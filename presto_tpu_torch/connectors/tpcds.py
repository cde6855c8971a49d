"""Deterministic TPC-DS generator connector — full 24-table schema.

Reference analog: ``presto-tpcds`` (teradata tpcds-backed generator,
`presto-tpcds/src/main/java/com/facebook/presto/tpcds/`).  From-scratch
counter-hash generation in the same style as connectors/tpch.py:
every value is a pure function of (table, column, row index), so splits
generate independently on any worker.  Distributions follow the TPC-DS
spec's shapes (fact rows scale with sf, dimensions fixed or sublinear;
customer_demographics is the spec's exact 1,920,800-row demographic
cross product; returns sample their parent sales so return joins on
(item, ticket/order) resolve) — byte-parity with the official dsdgen is
a non-goal since correctness is oracle-checked on the same generated
data.

All 24 spec tables exist with the column subsets the benchmark corpus
(tests/tpcds_queries.py) exercises; columns grow with the corpus.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from presto_tpu_torch.connectors.tpch import PatternDictionary, _hash_u64, _uniform_int
from presto_tpu_torch.page import Dictionary, Page
from presto_tpu_torch.types import BIGINT, DATE, INTEGER, VARCHAR, DecimalType, Type

_MONEY = DecimalType(12, 2)
_GMT = DecimalType(5, 2)

# date_dim: 1900-01-01 .. 2100-01-01, sk = julian-style offset
DATE_DIM_ROWS = 73049
D_SK0 = 2415022  # spec's first d_date_sk
_EPOCH_OFF = (np.datetime64("1970-01-01") - np.datetime64("1900-01-01")).astype(int)

# sales window: 1998-01-01 (+5 years)
_SALES_START = int((np.datetime64("1998-01-01") - np.datetime64("1900-01-01")).astype(int))
_SALES_DAYS = 1826

GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = [
    "Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
    "Advanced Degree", "Unknown",
]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
YN = ["N", "Y"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"]
COLORS = ["red", "green", "blue", "yellow", "black", "white", "pink", "purple",
          "orange", "brown", "cyan", "magenta", "olive", "navy", "teal", "maroon"]
SIZES = ["small", "medium", "large", "extra large", "economy", "N/A", "petite"]
SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU", "PRIVATECARRIER",
            "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES",
            "ZOUROS", "GERMA", "DIAMOND", "RUPEKSA", "GREAT EASTERN", "HARMSTORF"]
CITIES = ["Fairview", "Midway", "Oakland", "Riverside", "Centerville", "Five Points",
          "Greenville", "Liberty", "Pleasant Hill", "Salem", "Union", "Bethel",
          "Clinton", "Enterprise", "Friendship", "Glendale", "Lakeview", "Marion",
          "Mount Olive", "Springfield"]
COUNTIES = ["Williamson County", "Ziebach County", "Walker County", "Daviess County",
            "Barrow County", "Franklin Parish", "Luce County", "Richland County",
            "Furnas County", "Maverick County"]
COUNTRIES = ["United States"]
REASONS = ["Package was damaged", "Stopped working", "Did not like the color",
           "Did not like the model", "Parts missing", "Does not work with a product",
           "Gift exchange", "Did not fit", "Wrong size", "Not the product ordered",
           "Found a better price", "Ordered twice", "No longer needed",
           "Did not like the warranty", "unknown"]
STATES = ["TN", "CA", "TX", "OH", "GA", "NY", "WA", "IL", "MI", "FL"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday"]

CD_ROWS = 2 * 5 * 7 * 20 * 4 * 7 * 7 * 7  # 1,920,800 (spec cross product)
HD_ROWS = 20 * 6 * 10 * 6  # 7,200 (income band x buy potential x deps x vehicles)
IB_ROWS = 20
TIME_ROWS = 86400
INV_WEEKS = 261


def _seed(t: str, c: str) -> int:
    h = 1469598103934665603
    for ch in f"tpcds.{t}.{c}":
        h = ((h ^ ord(ch)) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


SCHEMAS: Dict[str, List[Tuple[str, Type]]] = {
    "date_dim": [
        ("d_date_sk", BIGINT), ("d_date", DATE), ("d_year", BIGINT),
        ("d_moy", BIGINT), ("d_dom", BIGINT), ("d_qoy", BIGINT),
        ("d_day_name", VARCHAR), ("d_month_seq", BIGINT),
        ("d_week_seq", BIGINT), ("d_dow", BIGINT),
    ],
    "time_dim": [
        ("t_time_sk", BIGINT), ("t_time", BIGINT), ("t_hour", BIGINT),
        ("t_minute", BIGINT), ("t_second", BIGINT), ("t_am_pm", VARCHAR),
    ],
    "item": [
        ("i_item_sk", BIGINT), ("i_item_id", VARCHAR), ("i_item_desc", VARCHAR),
        ("i_brand_id", BIGINT), ("i_brand", VARCHAR),
        ("i_class_id", BIGINT), ("i_class", VARCHAR),
        ("i_category_id", BIGINT), ("i_category", VARCHAR),
        ("i_manufact_id", BIGINT), ("i_manufact", VARCHAR),
        ("i_manager_id", BIGINT), ("i_current_price", _MONEY),
        ("i_color", VARCHAR), ("i_size", VARCHAR),
    ],
    "customer": [
        ("c_customer_sk", BIGINT), ("c_customer_id", VARCHAR),
        ("c_current_cdemo_sk", BIGINT), ("c_current_hdemo_sk", BIGINT),
        ("c_current_addr_sk", BIGINT), ("c_first_name", VARCHAR),
        ("c_last_name", VARCHAR), ("c_birth_month", BIGINT),
        ("c_birth_year", BIGINT), ("c_birth_country", VARCHAR),
        ("c_first_sales_date_sk", BIGINT), ("c_first_shipto_date_sk", BIGINT),
    ],
    "customer_address": [
        ("ca_address_sk", BIGINT), ("ca_address_id", VARCHAR),
        ("ca_city", VARCHAR), ("ca_county", VARCHAR), ("ca_state", VARCHAR),
        ("ca_zip", VARCHAR), ("ca_country", VARCHAR), ("ca_gmt_offset", _GMT),
    ],
    "customer_demographics": [
        ("cd_demo_sk", BIGINT), ("cd_gender", VARCHAR),
        ("cd_marital_status", VARCHAR), ("cd_education_status", VARCHAR),
        ("cd_purchase_estimate", BIGINT), ("cd_credit_rating", VARCHAR),
        ("cd_dep_count", BIGINT), ("cd_dep_employed_count", BIGINT),
        ("cd_dep_college_count", BIGINT),
    ],
    "household_demographics": [
        ("hd_demo_sk", BIGINT), ("hd_income_band_sk", BIGINT),
        ("hd_buy_potential", VARCHAR), ("hd_dep_count", BIGINT),
        ("hd_vehicle_count", BIGINT),
    ],
    "income_band": [
        ("ib_income_band_sk", BIGINT), ("ib_lower_bound", BIGINT),
        ("ib_upper_bound", BIGINT),
    ],
    "promotion": [
        ("p_promo_sk", BIGINT), ("p_promo_id", VARCHAR),
        ("p_channel_dmail", VARCHAR), ("p_channel_email", VARCHAR),
        ("p_channel_event", VARCHAR), ("p_channel_tv", VARCHAR),
    ],
    "reason": [
        ("r_reason_sk", BIGINT), ("r_reason_id", VARCHAR),
        ("r_reason_desc", VARCHAR),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", BIGINT), ("sm_ship_mode_id", VARCHAR),
        ("sm_type", VARCHAR), ("sm_carrier", VARCHAR),
    ],
    "store": [
        ("s_store_sk", BIGINT), ("s_store_id", VARCHAR),
        ("s_store_name", VARCHAR), ("s_number_employees", BIGINT),
        ("s_state", VARCHAR), ("s_city", VARCHAR), ("s_county", VARCHAR),
        ("s_zip", VARCHAR), ("s_gmt_offset", _GMT),
    ],
    "warehouse": [
        ("w_warehouse_sk", BIGINT), ("w_warehouse_id", VARCHAR),
        ("w_warehouse_name", VARCHAR), ("w_warehouse_sq_ft", BIGINT),
        ("w_state", VARCHAR),
    ],
    "call_center": [
        ("cc_call_center_sk", BIGINT), ("cc_call_center_id", VARCHAR),
        ("cc_name", VARCHAR), ("cc_manager", VARCHAR), ("cc_county", VARCHAR),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", BIGINT), ("cp_catalog_page_id", VARCHAR),
    ],
    "web_page": [
        ("wp_web_page_sk", BIGINT), ("wp_web_page_id", VARCHAR),
        ("wp_char_count", BIGINT),
    ],
    "web_site": [
        ("web_site_sk", BIGINT), ("web_site_id", VARCHAR), ("web_name", VARCHAR),
    ],
    "inventory": [
        ("inv_date_sk", BIGINT), ("inv_item_sk", BIGINT),
        ("inv_warehouse_sk", BIGINT), ("inv_quantity_on_hand", BIGINT),
    ],
    "store_sales": [
        ("ss_sold_date_sk", BIGINT), ("ss_sold_time_sk", BIGINT),
        ("ss_item_sk", BIGINT), ("ss_customer_sk", BIGINT),
        ("ss_cdemo_sk", BIGINT), ("ss_hdemo_sk", BIGINT),
        ("ss_addr_sk", BIGINT), ("ss_store_sk", BIGINT),
        ("ss_promo_sk", BIGINT), ("ss_ticket_number", BIGINT),
        ("ss_quantity", BIGINT),
        ("ss_wholesale_cost", _MONEY), ("ss_list_price", _MONEY),
        ("ss_sales_price", _MONEY), ("ss_ext_discount_amt", _MONEY),
        ("ss_ext_sales_price", _MONEY), ("ss_ext_wholesale_cost", _MONEY),
        ("ss_ext_list_price", _MONEY), ("ss_coupon_amt", _MONEY),
        ("ss_net_paid", _MONEY), ("ss_net_profit", _MONEY),
    ],
    "store_returns": [
        ("sr_returned_date_sk", BIGINT), ("sr_item_sk", BIGINT),
        ("sr_customer_sk", BIGINT), ("sr_cdemo_sk", BIGINT),
        ("sr_store_sk", BIGINT), ("sr_reason_sk", BIGINT),
        ("sr_ticket_number", BIGINT), ("sr_return_quantity", BIGINT),
        ("sr_return_amt", _MONEY), ("sr_net_loss", _MONEY),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", BIGINT), ("cs_sold_time_sk", BIGINT),
        ("cs_ship_date_sk", BIGINT), ("cs_bill_customer_sk", BIGINT),
        ("cs_bill_cdemo_sk", BIGINT), ("cs_bill_hdemo_sk", BIGINT),
        ("cs_bill_addr_sk", BIGINT), ("cs_ship_customer_sk", BIGINT),
        ("cs_ship_addr_sk", BIGINT), ("cs_call_center_sk", BIGINT),
        ("cs_catalog_page_sk", BIGINT), ("cs_ship_mode_sk", BIGINT),
        ("cs_warehouse_sk", BIGINT), ("cs_item_sk", BIGINT),
        ("cs_promo_sk", BIGINT), ("cs_order_number", BIGINT),
        ("cs_quantity", BIGINT),
        ("cs_wholesale_cost", _MONEY), ("cs_list_price", _MONEY),
        ("cs_sales_price", _MONEY), ("cs_ext_discount_amt", _MONEY),
        ("cs_ext_sales_price", _MONEY), ("cs_ext_wholesale_cost", _MONEY),
        ("cs_ext_list_price", _MONEY), ("cs_ext_ship_cost", _MONEY),
        ("cs_coupon_amt", _MONEY),
        ("cs_net_paid", _MONEY), ("cs_net_profit", _MONEY),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", BIGINT), ("cr_item_sk", BIGINT),
        ("cr_returning_customer_sk", BIGINT), ("cr_call_center_sk", BIGINT),
        ("cr_reason_sk", BIGINT), ("cr_order_number", BIGINT),
        ("cr_return_quantity", BIGINT), ("cr_return_amount", _MONEY),
        ("cr_net_loss", _MONEY),
    ],
    "web_sales": [
        ("ws_sold_date_sk", BIGINT), ("ws_sold_time_sk", BIGINT),
        ("ws_ship_date_sk", BIGINT), ("ws_item_sk", BIGINT),
        ("ws_bill_customer_sk", BIGINT), ("ws_bill_addr_sk", BIGINT),
        ("ws_ship_customer_sk", BIGINT), ("ws_ship_addr_sk", BIGINT),
        ("ws_web_page_sk", BIGINT), ("ws_web_site_sk", BIGINT),
        ("ws_ship_mode_sk", BIGINT), ("ws_warehouse_sk", BIGINT),
        ("ws_promo_sk", BIGINT), ("ws_order_number", BIGINT),
        ("ws_quantity", BIGINT),
        ("ws_wholesale_cost", _MONEY), ("ws_list_price", _MONEY),
        ("ws_sales_price", _MONEY), ("ws_ext_discount_amt", _MONEY),
        ("ws_ext_sales_price", _MONEY), ("ws_ext_wholesale_cost", _MONEY),
        ("ws_ext_list_price", _MONEY), ("ws_ext_ship_cost", _MONEY),
        ("ws_net_paid", _MONEY), ("ws_net_profit", _MONEY),
    ],
    "web_returns": [
        ("wr_returned_date_sk", BIGINT), ("wr_item_sk", BIGINT),
        ("wr_returning_customer_sk", BIGINT), ("wr_reason_sk", BIGINT),
        ("wr_order_number", BIGINT), ("wr_return_quantity", BIGINT),
        ("wr_return_amt", _MONEY), ("wr_net_loss", _MONEY),
    ],
}


def _per_code(fmt):
    """A ``PatternDictionary`` formatter over an array of codes from one
    that formats a single code."""
    return lambda codes: [fmt(i) for i in codes.tolist()]


class Tpcds:
    def __init__(self, sf: float = 1.0, split_rows: int = 1 << 20,
                 cd_rows: Optional[int] = None, inv_rows: Optional[int] = None):
        self.sf = float(sf)
        self.split_rows = int(split_rows)
        # test harnesses may truncate the demographic cross product and
        # the inventory fact (both are sf-independent monsters)
        self.cd_rows = int(cd_rows) if cd_rows is not None else CD_ROWS
        self.n_store_sales = max(int(round(2_880_000 * self.sf)), 1)
        self.n_catalog_sales = max(int(round(1_441_548 * self.sf)), 1)
        self.n_web_sales = max(int(round(719_384 * self.sf)), 1)
        self.n_store_returns = max(int(round(287_514 * self.sf)), 1)
        self.n_catalog_returns = max(int(round(144_067 * self.sf)), 1)
        self.n_web_returns = max(int(round(71_763 * self.sf)), 1)
        self.n_items = 18000
        self.n_customers = max(int(round(100_000 * self.sf)), 1)
        self.n_addresses = max(int(round(50_000 * self.sf)), 1)
        self.n_promos = 300
        self.n_stores = max(int(round(12 * max(self.sf, 1.0))), 1)
        self.n_warehouses = 5
        self.n_call_centers = 6
        self.n_catalog_pages = 11718
        self.n_web_pages = 60
        self.n_web_sites = 30
        self.n_reasons = len(REASONS)
        self.n_ship_modes = len(SHIP_TYPES) * 4
        default_inv = INV_WEEKS * self.n_warehouses * self.n_items
        self.inv_rows = int(inv_rows) if inv_rows is not None else default_inv
        self._dicts: Dict[str, Dictionary] = {}

    # -- metadata -----------------------------------------------------------
    def table_names(self) -> List[str]:
        return list(SCHEMAS.keys())

    def schema(self, table: str) -> List[Tuple[str, Type]]:
        return SCHEMAS[table]

    def row_count(self, table: str) -> int:
        return {
            "date_dim": DATE_DIM_ROWS,
            "time_dim": TIME_ROWS,
            "item": self.n_items,
            "customer": self.n_customers,
            "customer_address": self.n_addresses,
            "customer_demographics": self.cd_rows,
            "household_demographics": HD_ROWS,
            "income_band": IB_ROWS,
            "promotion": self.n_promos,
            "reason": self.n_reasons,
            "ship_mode": self.n_ship_modes,
            "store": self.n_stores,
            "warehouse": self.n_warehouses,
            "call_center": self.n_call_centers,
            "catalog_page": self.n_catalog_pages,
            "web_page": self.n_web_pages,
            "web_site": self.n_web_sites,
            "inventory": self.inv_rows,
            "store_sales": self.n_store_sales,
            "store_returns": self.n_store_returns,
            "catalog_sales": self.n_catalog_sales,
            "catalog_returns": self.n_catalog_returns,
            "web_sales": self.n_web_sales,
            "web_returns": self.n_web_returns,
        }[table]

    def num_splits(self, table: str) -> int:
        return max(1, -(-self.row_count(table) // self.split_rows))

    def table_version(self, table: str) -> int:
        """Generated data is immutable: a constant version marks every
        table cacheable forever (serving-tier result/subplan caches)."""
        return 0

    def max_split_rows(self, table: str) -> int:
        return min(self.split_rows, max(self.row_count(table), 1))

    def primary_key(self, table: str) -> Optional[List[str]]:
        return {
            "date_dim": ["d_date_sk"],
            "time_dim": ["t_time_sk"],
            "item": ["i_item_sk"],
            "customer": ["c_customer_sk"],
            "customer_address": ["ca_address_sk"],
            "customer_demographics": ["cd_demo_sk"],
            "household_demographics": ["hd_demo_sk"],
            "income_band": ["ib_income_band_sk"],
            "promotion": ["p_promo_sk"],
            "reason": ["r_reason_sk"],
            "ship_mode": ["sm_ship_mode_sk"],
            "store": ["s_store_sk"],
            "warehouse": ["w_warehouse_sk"],
            "call_center": ["cc_call_center_sk"],
            "catalog_page": ["cp_catalog_page_sk"],
            "web_page": ["wp_web_page_sk"],
            "web_site": ["web_site_sk"],
        }.get(table)

    def column_domain(self, table: str, column: str) -> Optional[Tuple[int, int]]:
        t = dict(SCHEMAS[table])[column]
        if t.is_string:
            return (0, len(self.dictionary_for(table, column)) - 1)
        sales_dates = (D_SK0 + _SALES_START, D_SK0 + _SALES_START + _SALES_DAYS - 1)
        return_dates = (sales_dates[0], sales_dates[1] + 90)
        doms: Dict[str, Tuple[int, int]] = {
            "d_date_sk": (D_SK0, D_SK0 + DATE_DIM_ROWS - 1),
            "d_year": (1900, 2100),
            "d_moy": (1, 12),
            "d_dom": (1, 31),
            "d_qoy": (1, 4),
            "d_dow": (0, 6),
            "t_time_sk": (0, TIME_ROWS - 1),
            "t_hour": (0, 23),
            "t_minute": (0, 59),
            "t_second": (0, 59),
            "i_item_sk": (1, self.n_items),
            "i_brand_id": (1, 1000),
            "i_class_id": (1, 100),
            "i_category_id": (1, 10),
            "i_manufact_id": (1, 1000),
            "i_manager_id": (1, 100),
            "c_customer_sk": (1, self.n_customers),
            "c_current_cdemo_sk": (1, self.cd_rows),
            "c_current_hdemo_sk": (1, HD_ROWS),
            "c_current_addr_sk": (1, self.n_addresses),
            "c_birth_month": (1, 12),
            "c_birth_year": (1920, 1992),
            "ca_address_sk": (1, self.n_addresses),
            "cd_demo_sk": (1, self.cd_rows),
            "hd_demo_sk": (1, HD_ROWS),
            "hd_income_band_sk": (1, IB_ROWS),
            "hd_dep_count": (0, 9),
            "hd_vehicle_count": (0, 5),
            "ib_income_band_sk": (1, IB_ROWS),
            "p_promo_sk": (1, self.n_promos),
            "r_reason_sk": (1, self.n_reasons),
            "sm_ship_mode_sk": (1, self.n_ship_modes),
            "s_store_sk": (1, self.n_stores),
            "w_warehouse_sk": (1, self.n_warehouses),
            "cc_call_center_sk": (1, self.n_call_centers),
            "cp_catalog_page_sk": (1, self.n_catalog_pages),
            "wp_web_page_sk": (1, self.n_web_pages),
            "web_site_sk": (1, self.n_web_sites),
            "inv_date_sk": (D_SK0 + _SALES_START, D_SK0 + _SALES_START + 7 * INV_WEEKS),
            "inv_item_sk": (1, self.n_items),
            "inv_warehouse_sk": (1, self.n_warehouses),
            "ss_sold_date_sk": sales_dates,
            "ss_sold_time_sk": (0, TIME_ROWS - 1),
            "ss_item_sk": (1, self.n_items),
            "ss_customer_sk": (1, self.n_customers),
            "ss_cdemo_sk": (1, self.cd_rows),
            "ss_hdemo_sk": (1, HD_ROWS),
            "ss_addr_sk": (1, self.n_addresses),
            "ss_store_sk": (1, self.n_stores),
            "ss_promo_sk": (0, self.n_promos),
            "ss_quantity": (1, 100),
            "sr_returned_date_sk": return_dates,
            "sr_item_sk": (1, self.n_items),
            "sr_customer_sk": (1, self.n_customers),
            "sr_cdemo_sk": (1, self.cd_rows),
            "sr_store_sk": (1, self.n_stores),
            "sr_reason_sk": (1, self.n_reasons),
            "cs_sold_date_sk": sales_dates,
            "cs_sold_time_sk": (0, TIME_ROWS - 1),
            "cs_ship_date_sk": (sales_dates[0], sales_dates[1] + 30),
            "cs_bill_customer_sk": (1, self.n_customers),
            "cs_bill_cdemo_sk": (1, self.cd_rows),
            "cs_bill_hdemo_sk": (1, HD_ROWS),
            "cs_bill_addr_sk": (1, self.n_addresses),
            "cs_ship_customer_sk": (1, self.n_customers),
            "cs_ship_addr_sk": (1, self.n_addresses),
            "cs_call_center_sk": (1, self.n_call_centers),
            "cs_catalog_page_sk": (1, self.n_catalog_pages),
            "cs_ship_mode_sk": (1, self.n_ship_modes),
            "cs_warehouse_sk": (1, self.n_warehouses),
            "cs_item_sk": (1, self.n_items),
            "cs_promo_sk": (0, self.n_promos),
            "cs_quantity": (1, 100),
            "cr_returned_date_sk": return_dates,
            "cr_item_sk": (1, self.n_items),
            "cr_returning_customer_sk": (1, self.n_customers),
            "cr_call_center_sk": (1, self.n_call_centers),
            "cr_reason_sk": (1, self.n_reasons),
            "ws_sold_date_sk": sales_dates,
            "ws_sold_time_sk": (0, TIME_ROWS - 1),
            "ws_ship_date_sk": (sales_dates[0], sales_dates[1] + 30),
            "ws_item_sk": (1, self.n_items),
            "ws_bill_customer_sk": (1, self.n_customers),
            "ws_bill_addr_sk": (1, self.n_addresses),
            "ws_ship_customer_sk": (1, self.n_customers),
            "ws_ship_addr_sk": (1, self.n_addresses),
            "ws_web_page_sk": (1, self.n_web_pages),
            "ws_web_site_sk": (1, self.n_web_sites),
            "ws_ship_mode_sk": (1, self.n_ship_modes),
            "ws_warehouse_sk": (1, self.n_warehouses),
            "ws_promo_sk": (0, self.n_promos),
            "ws_quantity": (1, 100),
            "wr_returned_date_sk": return_dates,
            "wr_item_sk": (1, self.n_items),
            "wr_returning_customer_sk": (1, self.n_customers),
            "wr_reason_sk": (1, self.n_reasons),
        }
        return doms.get(column)

    # -- dictionaries -------------------------------------------------------
    def dictionary_for(self, table: str, column: str) -> Optional[Dictionary]:
        t = dict(SCHEMAS[table])[column]
        if not t.is_string:
            return None
        if column in self._dicts:
            return self._dicts[column]
        fixed = {
            "d_day_name": DAY_NAMES,
            "t_am_pm": ["AM", "PM"],
            "i_category": CATEGORIES,
            "i_color": COLORS,
            "i_size": SIZES,
            "cd_gender": GENDERS,
            "cd_marital_status": MARITAL,
            "cd_education_status": EDUCATION,
            "cd_credit_rating": CREDIT,
            "hd_buy_potential": BUY_POTENTIAL,
            "ca_city": CITIES,
            "ca_county": COUNTIES,
            "ca_state": STATES,
            "ca_country": COUNTRIES,
            "c_birth_country": ["UNITED STATES", "CANADA", "MEXICO", "GERMANY",
                                "JAPAN", "BRAZIL", "INDIA", "FRANCE"],
            "p_channel_dmail": YN, "p_channel_email": YN,
            "p_channel_event": YN, "p_channel_tv": YN,
            "r_reason_desc": REASONS,
            "sm_type": SHIP_TYPES,
            "sm_carrier": CARRIERS,
            "s_store_name": ["ought", "able", "pri", "ese", "anti", "cally",
                             "ation", "eing"],
            "s_state": STATES,
            "s_city": CITIES,
            "s_county": COUNTIES,
            "w_warehouse_name": ["Conventional childr", "Important issues liv",
                                 "Doors canno", "Bad cards must make.", "arehouse"],
            "w_state": STATES,
            "cc_name": ["NY Metro", "Mid Atlantic", "Midwest", "North Midwest",
                        "Pacific Northwest", "California"],
            "cc_county": COUNTIES,
            "web_name": [f"site_{i}" for i in range(30)],
        }
        if column in fixed:
            d: Dictionary = Dictionary(fixed[column])
        elif column == "i_item_id":
            d = PatternDictionary(_per_code(lambda i: f"AAAAAAAA{i + 1:08d}"), self.n_items)
        elif column == "i_item_desc":
            d = PatternDictionary(_per_code(lambda i: f"item description {i + 1}"), 4096)
        elif column == "i_brand":
            d = PatternDictionary(_per_code(lambda i: f"brand#{i + 1}"), 1000)
        elif column == "i_class":
            d = PatternDictionary(_per_code(lambda i: f"class#{i + 1}"), 100)
        elif column == "i_manufact":
            d = PatternDictionary(_per_code(lambda i: f"manufact#{i + 1}"), 1000)
        elif column == "c_customer_id":
            d = PatternDictionary(_per_code(lambda i: f"AAAAAAAA{i + 1:08d}C"), self.n_customers)
        elif column == "c_first_name":
            d = PatternDictionary(_per_code(lambda i: f"First{i}"), 512)
        elif column == "c_last_name":
            d = PatternDictionary(_per_code(lambda i: f"Last{i}"), 1024)
        elif column == "ca_address_id":
            d = PatternDictionary(_per_code(lambda i: f"AAAAAAAA{i + 1:08d}A"), self.n_addresses)
        elif column in ("ca_zip", "s_zip"):
            d = PatternDictionary(_per_code(lambda i: f"{10000 + i * 7 % 90000:05d}"), 400)
        elif column == "p_promo_id":
            d = PatternDictionary(_per_code(lambda i: f"promo#{i + 1:08d}"), self.n_promos)
        elif column == "r_reason_id":
            d = PatternDictionary(_per_code(lambda i: f"reason#{i + 1}"), self.n_reasons)
        elif column == "sm_ship_mode_id":
            d = PatternDictionary(_per_code(lambda i: f"ship#{i + 1}"), self.n_ship_modes)
        elif column == "s_store_id":
            d = PatternDictionary(_per_code(lambda i: f"store#{i + 1:08d}"), self.n_stores)
        elif column == "w_warehouse_id":
            d = PatternDictionary(_per_code(lambda i: f"wh#{i + 1}"), self.n_warehouses)
        elif column == "cc_call_center_id":
            d = PatternDictionary(_per_code(lambda i: f"cc#{i + 1}"), self.n_call_centers)
        elif column == "cc_manager":
            d = PatternDictionary(_per_code(lambda i: f"Manager {i}"), 64)
        elif column == "cp_catalog_page_id":
            d = PatternDictionary(_per_code(lambda i: f"cp#{i + 1:08d}"), self.n_catalog_pages)
        elif column == "wp_web_page_id":
            d = PatternDictionary(_per_code(lambda i: f"wp#{i + 1}"), self.n_web_pages)
        elif column == "web_site_id":
            d = PatternDictionary(_per_code(lambda i: f"web#{i + 1}"), self.n_web_sites)
        else:
            raise KeyError(column)
        self._dicts[column] = d
        return d

    # -- generators ---------------------------------------------------------
    def generate_split(self, table: str, split: int) -> Dict[str, np.ndarray]:
        n = self.row_count(table)
        lo = split * self.split_rows
        hi = min(lo + self.split_rows, n)
        idx = np.arange(lo, hi)
        return getattr(self, f"_{table}")(idx)

    def _date_dim(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        days = idx.astype("int64")  # days since 1900-01-01
        dt = np.datetime64("1900-01-01") + days.astype("timedelta64[D]")
        y = dt.astype("datetime64[Y]").astype(int) + 1970
        month0 = dt.astype("datetime64[M]").astype(int)
        moy = month0 % 12 + 1
        dom = (dt - dt.astype("datetime64[M]")).astype(int) + 1
        dow = (days + 1) % 7  # 1900-01-01 was a Monday; 0=Sunday
        return {
            "d_date_sk": days + D_SK0,
            "d_date": (days - _EPOCH_OFF).astype(np.int32),
            "d_year": y.astype(np.int64),
            "d_moy": moy.astype(np.int64),
            "d_dom": dom.astype(np.int64),
            "d_qoy": ((moy - 1) // 3 + 1).astype(np.int64),
            "d_day_name": dow.astype(np.int32),
            "d_month_seq": (month0 + 840).astype(np.int64),
            "d_week_seq": ((days + 1) // 7 + 5217).astype(np.int64),
            "d_dow": dow.astype(np.int64),
        }

    def _time_dim(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        sec = idx.astype(np.int64)
        return {
            "t_time_sk": sec,
            "t_time": sec,
            "t_hour": sec // 3600,
            "t_minute": (sec // 60) % 60,
            "t_second": sec % 60,
            "t_am_pm": (sec >= 43200).astype(np.int32),
        }

    def _item(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("item", c)
        brand_id = _uniform_int(s("brand"), idx, 1, 1000)
        class_id = _uniform_int(s("class"), idx, 1, 100)
        return {
            "i_item_sk": idx.astype(np.int64) + 1,
            "i_item_id": idx.astype(np.int32),
            "i_item_desc": (_hash_u64(s("desc"), idx) % 4096).astype(np.int32),
            "i_brand_id": brand_id,
            "i_brand": (brand_id - 1).astype(np.int32),
            "i_class_id": class_id,
            "i_class": (class_id - 1).astype(np.int32),
            "i_category_id": (class_id - 1) % 10 + 1,
            "i_category": ((class_id - 1) % 10).astype(np.int32),
            "i_manufact_id": _uniform_int(s("manufact"), idx, 1, 1000),
            "i_manufact": (_uniform_int(s("manufact"), idx, 1, 1000) - 1).astype(np.int32),
            "i_manager_id": _uniform_int(s("manager"), idx, 1, 100),
            "i_current_price": _uniform_int(s("price"), idx, 100, 9999),
            "i_color": (_hash_u64(s("color"), idx) % len(COLORS)).astype(np.int32),
            "i_size": (_hash_u64(s("size"), idx) % len(SIZES)).astype(np.int32),
        }

    def _customer(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("customer", c)
        first_sale = (D_SK0 + _SALES_START
                      + _uniform_int(s("first_sale"), idx, 0, _SALES_DAYS - 1))
        return {
            "c_customer_sk": idx.astype(np.int64) + 1,
            "c_customer_id": idx.astype(np.int32),
            "c_current_cdemo_sk": _uniform_int(s("cdemo"), idx, 1, self.cd_rows),
            "c_current_hdemo_sk": _uniform_int(s("hdemo"), idx, 1, HD_ROWS),
            "c_current_addr_sk": _uniform_int(s("addr"), idx, 1, self.n_addresses),
            "c_first_name": (_hash_u64(s("first"), idx) % 512).astype(np.int32),
            "c_last_name": (_hash_u64(s("last"), idx) % 1024).astype(np.int32),
            "c_birth_month": _uniform_int(s("bmonth"), idx, 1, 12),
            "c_birth_year": _uniform_int(s("byear"), idx, 1920, 1992),
            "c_birth_country": (_hash_u64(s("bcountry"), idx) % 8).astype(np.int32),
            "c_first_sales_date_sk": first_sale,
            "c_first_shipto_date_sk": first_sale + 30,
        }

    def _customer_address(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("customer_address", c)
        return {
            "ca_address_sk": idx.astype(np.int64) + 1,
            "ca_address_id": idx.astype(np.int32),
            "ca_city": (_hash_u64(s("city"), idx) % len(CITIES)).astype(np.int32),
            "ca_county": (_hash_u64(s("county"), idx) % len(COUNTIES)).astype(np.int32),
            "ca_state": (_hash_u64(s("state"), idx) % len(STATES)).astype(np.int32),
            "ca_zip": (_hash_u64(s("zip"), idx) % 400).astype(np.int32),
            "ca_country": np.zeros(len(idx), dtype=np.int32),
            "ca_gmt_offset": -(_uniform_int(s("gmt"), idx, 5, 8)) * 100,
        }

    def _customer_demographics(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # mixed-radix decode of the demographic cross product (spec
        # enumerates all combinations exactly once)
        x = idx.copy()
        gender = x % 2; x //= 2
        marital = x % 5; x //= 5
        education = x % 7; x //= 7
        purchase = x % 20; x //= 20
        credit = x % 4; x //= 4
        dep = x % 7; x //= 7
        dep_emp = x % 7; x //= 7
        dep_col = x % 7
        return {
            "cd_demo_sk": idx.astype(np.int64) + 1,
            "cd_gender": gender.astype(np.int32),
            "cd_marital_status": marital.astype(np.int32),
            "cd_education_status": education.astype(np.int32),
            "cd_purchase_estimate": (purchase + 1).astype(np.int64) * 500,
            "cd_credit_rating": credit.astype(np.int32),
            "cd_dep_count": dep.astype(np.int64),
            "cd_dep_employed_count": dep_emp.astype(np.int64),
            "cd_dep_college_count": dep_col.astype(np.int64),
        }

    def _household_demographics(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        x = idx.copy()
        ib = x % IB_ROWS; x //= IB_ROWS
        bp = x % 6; x //= 6
        dep = x % 10; x //= 10
        veh = x % 6
        return {
            "hd_demo_sk": idx.astype(np.int64) + 1,
            "hd_income_band_sk": (ib + 1).astype(np.int64),
            "hd_buy_potential": bp.astype(np.int32),
            "hd_dep_count": dep.astype(np.int64),
            "hd_vehicle_count": veh.astype(np.int64),  # 0..5
        }

    def _income_band(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "ib_income_band_sk": idx.astype(np.int64) + 1,
            "ib_lower_bound": idx.astype(np.int64) * 10000,
            "ib_upper_bound": (idx.astype(np.int64) + 1) * 10000,
        }

    def _promotion(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("promotion", c)
        chan = lambda c: (_hash_u64(s(c), idx) % 10 == 0).astype(np.int32)  # 10% 'Y'
        return {
            "p_promo_sk": idx.astype(np.int64) + 1,
            "p_promo_id": idx.astype(np.int32),
            "p_channel_dmail": chan("dmail"),
            "p_channel_email": chan("email"),
            "p_channel_event": chan("event"),
            "p_channel_tv": chan("tv"),
        }

    def _reason(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "r_reason_sk": idx.astype(np.int64) + 1,
            "r_reason_id": idx.astype(np.int32),
            "r_reason_desc": idx.astype(np.int32),
        }

    def _ship_mode(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "sm_ship_mode_sk": idx.astype(np.int64) + 1,
            "sm_ship_mode_id": idx.astype(np.int32),
            "sm_type": (idx % len(SHIP_TYPES)).astype(np.int32),
            "sm_carrier": (idx % len(CARRIERS)).astype(np.int32),
        }

    def _store(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("store", c)
        return {
            "s_store_sk": idx.astype(np.int64) + 1,
            "s_store_id": idx.astype(np.int32),
            "s_store_name": (idx % 8).astype(np.int32),
            "s_number_employees": _uniform_int(s("emp"), idx, 200, 300),
            "s_state": (_hash_u64(s("state"), idx) % len(STATES)).astype(np.int32),
            "s_city": (_hash_u64(s("city"), idx) % len(CITIES)).astype(np.int32),
            "s_county": (_hash_u64(s("county"), idx) % len(COUNTIES)).astype(np.int32),
            # zips share customer_address's 400-value dictionary (first
            # 40 values only) so s_zip = ca_zip equijoins (q24) and
            # shared prefixes (q8) hit at useful rates
            "s_zip": (_hash_u64(s("zip"), idx) % 40).astype(np.int32),
            "s_gmt_offset": -(_uniform_int(s("gmt"), idx, 5, 8)) * 100,
        }

    def _warehouse(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("warehouse", c)
        return {
            "w_warehouse_sk": idx.astype(np.int64) + 1,
            "w_warehouse_id": idx.astype(np.int32),
            "w_warehouse_name": (idx % 5).astype(np.int32),
            "w_warehouse_sq_ft": _uniform_int(s("sqft"), idx, 50000, 1000000),
            "w_state": (_hash_u64(s("state"), idx) % len(STATES)).astype(np.int32),
        }

    def _call_center(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("call_center", c)
        return {
            "cc_call_center_sk": idx.astype(np.int64) + 1,
            "cc_call_center_id": idx.astype(np.int32),
            "cc_name": (idx % 6).astype(np.int32),
            "cc_manager": (_hash_u64(s("mgr"), idx) % 64).astype(np.int32),
            "cc_county": (_hash_u64(s("county"), idx) % len(COUNTIES)).astype(np.int32),
        }

    def _catalog_page(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "cp_catalog_page_sk": idx.astype(np.int64) + 1,
            "cp_catalog_page_id": idx.astype(np.int32),
        }

    def _web_page(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("web_page", c)
        return {
            "wp_web_page_sk": idx.astype(np.int64) + 1,
            "wp_web_page_id": idx.astype(np.int32),
            "wp_char_count": _uniform_int(s("chars"), idx, 100, 8000),
        }

    def _web_site(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "web_site_sk": idx.astype(np.int64) + 1,
            "web_site_id": idx.astype(np.int32),
            "web_name": (idx % 30).astype(np.int32),
        }

    def _inventory(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # mixed-radix (item, warehouse, week) enumeration of the cross
        # product prefix; inv dates land on week boundaries like dsdgen.
        # week varies FASTEST so a truncated inv_rows still spans many
        # weeks (a per-item time series — q39's month-over-month cov
        # self-join needs at least two months of snapshots)
        s = lambda c: _seed("inventory", c)
        x = idx.copy()
        week = x % INV_WEEKS; x //= INV_WEEKS
        wh = x % self.n_warehouses; x //= self.n_warehouses
        item = x
        return {
            "inv_date_sk": (D_SK0 + _SALES_START + week * 7).astype(np.int64),
            "inv_item_sk": (item + 1).astype(np.int64),
            "inv_warehouse_sk": (wh + 1).astype(np.int64),
            "inv_quantity_on_hand": _uniform_int(s("qty"), idx, 0, 1000),
        }

    # ---- sales facts ------------------------------------------------------
    def _sales_core(self, t: str, idx: np.ndarray, n_items: int) -> Dict[str, np.ndarray]:
        """Shared price waterfall for the three sales channels."""
        s = lambda c: _seed(t, c)
        date_sk = D_SK0 + _SALES_START + _uniform_int(s("date"), idx, 0, _SALES_DAYS - 1)
        qty = _uniform_int(s("qty"), idx, 1, 100)
        wholesale = _uniform_int(s("wholesale"), idx, 100, 8800)
        markup = _uniform_int(s("markup"), idx, 100, 200)  # 1.00x-2.00x, scale 2
        list_price = wholesale * markup // 100
        discount = _uniform_int(s("discount"), idx, 0, 99)  # % of list
        sales_price = list_price * (100 - discount) // 100
        coupon_on = _hash_u64(s("coupon_on"), idx) % 5 == 0
        coupon = np.where(coupon_on, sales_price * qty // 10, 0)
        ext_sales = qty * sales_price
        ext_list = qty * list_price
        net_paid = ext_sales - coupon
        promo = np.where(
            _hash_u64(s("promo_null"), idx) % 5 == 0,
            0,
            _uniform_int(s("promo"), idx, 1, self.n_promos),
        )
        return {
            "date_sk": date_sk,
            "time_sk": _uniform_int(s("time"), idx, 0, TIME_ROWS - 1),
            "item_sk": _uniform_int(s("item"), idx, 1, n_items),
            "promo_sk": promo,
            "quantity": qty,
            "wholesale_cost": wholesale,
            "list_price": list_price,
            "sales_price": sales_price,
            "ext_discount_amt": ext_list - ext_sales,
            "ext_sales_price": ext_sales,
            "ext_wholesale_cost": qty * wholesale,
            "ext_list_price": ext_list,
            "coupon_amt": coupon,
            "net_paid": net_paid,
            "net_profit": net_paid - qty * wholesale,
        }

    def _store_sales(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("store_sales", c)
        core = self._sales_core("store_sales", idx, self.n_items)
        return {
            "ss_sold_date_sk": core["date_sk"],
            "ss_sold_time_sk": core["time_sk"],
            "ss_item_sk": core["item_sk"],
            "ss_customer_sk": _uniform_int(s("cust"), idx, 1, self.n_customers),
            "ss_cdemo_sk": _uniform_int(s("cdemo"), idx, 1, self.cd_rows),
            "ss_hdemo_sk": _uniform_int(s("hdemo"), idx, 1, HD_ROWS),
            "ss_addr_sk": _uniform_int(s("addr"), idx, 1, self.n_addresses),
            "ss_store_sk": _uniform_int(s("store"), idx, 1, self.n_stores),
            "ss_promo_sk": core["promo_sk"],
            "ss_ticket_number": idx.astype(np.int64) + 1,
            "ss_quantity": core["quantity"],
            "ss_wholesale_cost": core["wholesale_cost"],
            "ss_list_price": core["list_price"],
            "ss_sales_price": core["sales_price"],
            "ss_ext_discount_amt": core["ext_discount_amt"],
            "ss_ext_sales_price": core["ext_sales_price"],
            "ss_ext_wholesale_cost": core["ext_wholesale_cost"],
            "ss_ext_list_price": core["ext_list_price"],
            "ss_coupon_amt": core["coupon_amt"],
            "ss_net_paid": core["net_paid"],
            "ss_net_profit": core["net_profit"],
        }

    def _returns_core(self, ret_table: str, sale_table: str, n_sales: int,
                      idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Shared return-fact machinery: each return samples a parent
        sale (pure index function, so (item, ticket/order) joins back)
        and re-derives the parent's price waterfall from the sale seeds."""
        s = lambda c: _seed(ret_table, c)
        ps = lambda c: _seed(sale_table, c)
        sale = (_hash_u64(s("sale"), idx) % n_sales).astype(np.int64)
        sale_date = D_SK0 + _SALES_START + _uniform_int(ps("date"), sale, 0, _SALES_DAYS - 1)
        sale_qty = _uniform_int(ps("qty"), sale, 1, 100)
        wholesale = _uniform_int(ps("wholesale"), sale, 100, 8800)
        markup = _uniform_int(ps("markup"), sale, 100, 200)
        list_price = wholesale * markup // 100
        discount = _uniform_int(ps("discount"), sale, 0, 99)
        sales_price = list_price * (100 - discount) // 100
        rqty = 1 + _hash_u64(s("rqty"), idx) % np.maximum(sale_qty, 1)
        ramt = rqty * sales_price
        return {
            "sale": sale,
            "returned_date_sk": sale_date + _uniform_int(s("lag"), idx, 1, 90),
            "item_sk": _uniform_int(ps("item"), sale, 1, self.n_items),
            "reason_sk": _uniform_int(s("reason"), idx, 1, self.n_reasons),
            "return_quantity": rqty.astype(np.int64),
            "return_amt": ramt.astype(np.int64),
            "net_loss": (ramt + _uniform_int(s("fee"), idx, 50, 10000)).astype(np.int64),
        }

    def _store_returns(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        core = self._returns_core("store_returns", "store_sales", self.n_store_sales, idx)
        sale = core["sale"]
        ss = lambda c: _seed("store_sales", c)
        return {
            "sr_returned_date_sk": core["returned_date_sk"],
            "sr_item_sk": core["item_sk"],
            "sr_customer_sk": _uniform_int(ss("cust"), sale, 1, self.n_customers),
            "sr_cdemo_sk": _uniform_int(ss("cdemo"), sale, 1, self.cd_rows),
            "sr_store_sk": _uniform_int(ss("store"), sale, 1, self.n_stores),
            "sr_reason_sk": core["reason_sk"],
            "sr_ticket_number": sale + 1,
            "sr_return_quantity": core["return_quantity"],
            "sr_return_amt": core["return_amt"],
            "sr_net_loss": core["net_loss"],
        }

    def _catalog_sales(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("catalog_sales", c)
        core = self._sales_core("catalog_sales", idx, self.n_items)
        ship_cost = core["ext_sales_price"] // 20
        return {
            "cs_sold_date_sk": core["date_sk"],
            "cs_sold_time_sk": core["time_sk"],
            "cs_ship_date_sk": core["date_sk"] + _uniform_int(s("shiplag"), idx, 1, 30),
            "cs_bill_customer_sk": _uniform_int(s("bcust"), idx, 1, self.n_customers),
            "cs_bill_cdemo_sk": _uniform_int(s("bcdemo"), idx, 1, self.cd_rows),
            "cs_bill_hdemo_sk": _uniform_int(s("bhdemo"), idx, 1, HD_ROWS),
            "cs_bill_addr_sk": _uniform_int(s("baddr"), idx, 1, self.n_addresses),
            "cs_ship_customer_sk": _uniform_int(s("scust"), idx, 1, self.n_customers),
            "cs_ship_addr_sk": _uniform_int(s("saddr"), idx, 1, self.n_addresses),
            "cs_call_center_sk": _uniform_int(s("cc"), idx, 1, self.n_call_centers),
            "cs_catalog_page_sk": _uniform_int(s("cp"), idx, 1, self.n_catalog_pages),
            "cs_ship_mode_sk": _uniform_int(s("sm"), idx, 1, self.n_ship_modes),
            "cs_warehouse_sk": _uniform_int(s("wh"), idx, 1, self.n_warehouses),
            "cs_item_sk": core["item_sk"],
            "cs_promo_sk": core["promo_sk"],
            "cs_order_number": idx.astype(np.int64) + 1,
            "cs_quantity": core["quantity"],
            "cs_wholesale_cost": core["wholesale_cost"],
            "cs_list_price": core["list_price"],
            "cs_sales_price": core["sales_price"],
            "cs_ext_discount_amt": core["ext_discount_amt"],
            "cs_ext_sales_price": core["ext_sales_price"],
            "cs_ext_wholesale_cost": core["ext_wholesale_cost"],
            "cs_ext_list_price": core["ext_list_price"],
            "cs_ext_ship_cost": ship_cost,
            "cs_coupon_amt": core["coupon_amt"],
            "cs_net_paid": core["net_paid"],
            "cs_net_profit": core["net_profit"] - ship_cost,
        }

    def _catalog_returns(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        core = self._returns_core("catalog_returns", "catalog_sales",
                                  self.n_catalog_sales, idx)
        sale = core["sale"]
        cs = lambda c: _seed("catalog_sales", c)
        return {
            "cr_returned_date_sk": core["returned_date_sk"],
            "cr_item_sk": core["item_sk"],
            "cr_returning_customer_sk": _uniform_int(cs("bcust"), sale, 1, self.n_customers),
            "cr_call_center_sk": _uniform_int(cs("cc"), sale, 1, self.n_call_centers),
            "cr_reason_sk": core["reason_sk"],
            "cr_order_number": sale + 1,
            "cr_return_quantity": core["return_quantity"],
            "cr_return_amount": core["return_amt"],
            "cr_net_loss": core["net_loss"],
        }

    def _web_sales(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = lambda c: _seed("web_sales", c)
        core = self._sales_core("web_sales", idx, self.n_items)
        ship_cost = core["ext_sales_price"] // 20
        return {
            "ws_sold_date_sk": core["date_sk"],
            "ws_sold_time_sk": core["time_sk"],
            "ws_ship_date_sk": core["date_sk"] + _uniform_int(s("shiplag"), idx, 1, 30),
            "ws_item_sk": core["item_sk"],
            "ws_bill_customer_sk": _uniform_int(s("bcust"), idx, 1, self.n_customers),
            "ws_bill_addr_sk": _uniform_int(s("baddr"), idx, 1, self.n_addresses),
            "ws_ship_customer_sk": _uniform_int(s("scust"), idx, 1, self.n_customers),
            "ws_ship_addr_sk": _uniform_int(s("saddr"), idx, 1, self.n_addresses),
            "ws_web_page_sk": _uniform_int(s("wp"), idx, 1, self.n_web_pages),
            "ws_web_site_sk": _uniform_int(s("wsite"), idx, 1, self.n_web_sites),
            "ws_ship_mode_sk": _uniform_int(s("sm"), idx, 1, self.n_ship_modes),
            "ws_warehouse_sk": _uniform_int(s("wh"), idx, 1, self.n_warehouses),
            "ws_promo_sk": core["promo_sk"],
            "ws_order_number": idx.astype(np.int64) + 1,
            "ws_quantity": core["quantity"],
            "ws_wholesale_cost": core["wholesale_cost"],
            "ws_list_price": core["list_price"],
            "ws_sales_price": core["sales_price"],
            "ws_ext_discount_amt": core["ext_discount_amt"],
            "ws_ext_sales_price": core["ext_sales_price"],
            "ws_ext_wholesale_cost": core["ext_wholesale_cost"],
            "ws_ext_list_price": core["ext_list_price"],
            "ws_ext_ship_cost": ship_cost,
            "ws_net_paid": core["net_paid"],
            "ws_net_profit": core["net_profit"] - ship_cost,
        }

    def _web_returns(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        core = self._returns_core("web_returns", "web_sales", self.n_web_sales, idx)
        sale = core["sale"]
        ws = lambda c: _seed("web_sales", c)
        return {
            "wr_returned_date_sk": core["returned_date_sk"],
            "wr_item_sk": core["item_sk"],
            "wr_returning_customer_sk": _uniform_int(ws("bcust"), sale, 1, self.n_customers),
            "wr_reason_sk": core["reason_sk"],
            "wr_order_number": sale + 1,
            "wr_return_quantity": core["return_quantity"],
            "wr_return_amt": core["return_amt"],
            "wr_net_loss": core["net_loss"],
        }

    # -- Page production ----------------------------------------------------
    def page_for_split(self, table: str, split: int, capacity: Optional[int] = None) -> Page:
        cols = self.generate_split(table, split)
        schema = SCHEMAS[table]
        arrays = [cols[name] for name, _ in schema]
        types = [t for _, t in schema]
        dicts = [self.dictionary_for(table, name) for name, _ in schema]
        return Page.from_arrays(arrays, types, dictionaries=dicts, capacity=capacity)

    def pages(self, table: str, capacity: Optional[int] = None) -> Iterator[Page]:
        for i in range(self.num_splits(table)):
            yield self.page_for_split(table, i, capacity=capacity)
