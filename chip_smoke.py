"""Smoke run of presto_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card's name and power limit;
2. build the CUDA kernels from ``presto_tpu_torch/csrc`` (all ``nvcc``
   runs at once, while the host generates the TPC-H tables lineitem,
   orders, customer, part, partsupp, supplier, nation and region at
   SF10 and again at SF 1, and the TPC-DS tables the slice's queries
   read at SF10: store_sales 28.8M rows, catalog_sales 14.4M, web_sales
   7.2M, customer_demographics 1.9M, ...) and print each ``-Xptxas -v``
   summary;
3. hold each kernel against its plain PyTorch version on the card,
   with exact equality, and time both with CUDA events: K1 expr_eval
   (Q6's filter, Q1's sum_charge argument, Q14's CASE/LIKE argument and
   its long-decimal/double projection, Q3's varchar filter, and the IN
   filters of Q12, Q16 and Q19), K2 packed_group_agg at 1, 12, 16 and
   16384 slots, K3 packed_fold_finalize, K4 join_build (Q14's and Q3's
   unique builds, a build whose primary key holds a duplicate, which
   breaks the promise and goes down the sorted branch, and the sorted
   builds of Q4 and Q5), K5 join_probe (Q14's and Q3's inner probes of
   the first lineitem split, Q4's semi and mark probes, Q16's
   null-aware anti probe, a left probe against Q14's build), K6
   sorted_group_agg (Q3's partial over that probe output, and its merge
   of every split's partials), K7 topn (Q3's top 10), K8 join_expand
   (Q13's left probe, the same as a FULL join with its matched mask,
   Q5's inner probe) and K9 hash_keys (Q10's seven keys over its first
   split and over its merge, Q13's c_count); the fourth slice's
   opcodes, states and modes: K1's date part (Q7's year), short decimal
   to double (Q17), long comparisons (Q11, Q15) and null test (Q21),
   K6's min/max over Q21's first lineitem split and over its merge,
   K2's long max and K3's fold and finalize of it (Q15), K6's presorted
   mode (Q18's first lineitem split) and K7 at n = 100 (Q18); and the
   fifth slice's: K10 window_eval over a whole 2^23-row store_sales
   split (partition by ss_item_sk, order by ss_net_profit: rank,
   row_number, a ROWS-frame sum and avg) and over the real window input
   of each windowed TPC-DS query, K1's double opcodes where q53, q63,
   q89, q47 and q57 run them, K7's double key (q89's top 100) and K3's
   avg of an integer as a double (q7's finalize); the sixth slice's
   opcodes and states; and the seventh slice's K11 spill_partition over
   a whole lineitem split (packed l_orderkey) and a whole store_sales
   split (hashed customer and item keys) at 8 and 64 buckets, its
   column gather, the copies of the gathered buffer to pinned host
   memory and back, and K4's null_flags; and the eighth slice's over
   whole lineitem splits: each new K1 opcode family (exact, or within 2
   ulp for ln and power, the gap printed as ``max_ulp``), K2's and K6's
   double, boolean and varchar-rank min/max, bool counts, bitwise folds
   and HLL sums, and K3's fold and finalize of them; and the ninth
   slice's (``check_tail_kernels``): K1's VLUT, DVLUT (over customer's
   split), TSPART, DTRUNC, DTADD, DTDIFF, CASTTS, UNIXT, DFMT and
   checksum's hash, K2's checksum, moments, covariance sums and
   min_by / max_by, K6's moments, covariance sums and min_by / max_by by
   l_suppkey and their merges, K3's fold and finalizes of them (exact,
   skewness within 2 ulp: pow); and the tenth slice's
   (``check_container_kernels``): every K12 ``container_eval`` opcode,
   K13 ``unnest_expand`` and K14 ``group_collect`` over seeded slot
   matrices of 2^20 rows (``container_sweep``), then K12 over a
   lineitem split (ct_row_ops' construction, subscript, contains, map
   lookup and ROW field), split's table over part's names, and over
   ct_array_agg's own arrays (cardinality, sum, sort, slot, the lambdas'
   assembly, compaction and match), K13 over the same arrays, K14's
   collect over a split by l_orderkey and its merge of two splits'
   partials;
4. run the 22 TPC-H queries (``tests/tpch_queries.py``) at SF10; the
   spill phase over the same tables (``tests/test_spill.py``'s
   aggregation, join and FULL OUTER join, and TPC-H Q18, each
   unconstrained and then under a pool at 0.6x its largest reservation
   at a spill site: K11 must launch, bytes must spill, and the rows
   must equal the unconstrained run's); the functions phase over the
   same tables (``FN_QUERIES``: approx_distinct, min/max over doubles,
   varchar and booleans with the bool and bitwise aggregates, count_if,
   the math family, date parts and casts, bitwise scalars, LIMIT 10,
   TABLESAMPLE BERNOULLI and SYSTEM); the dates and aggregate tail
   phase over the same tables (``DT_QUERIES``: date_trunc, date_diff,
   date_add, timestamp arithmetic and to_unixtime, a date_format group
   key, string value tables and casts, min_by / max_by, skewness,
   kurtosis, the covariance family and checksum by l_shipmode, by
   l_suppkey, globally and by two flags); the containers phase over the
   same tables (``CT_QUERIES``: array_agg by l_orderkey, its arrays
   unnested WITH ORDINALITY, a word count through split and UNNEST,
   histogram and map_agg, per-row container functions over lineitem,
   the lambdas over the aggregated arrays); then (TPC-H's tables freed)
   all 99 TPC-DS queries (``tests/tpcds_queries.py``) at SF10 but q72,
   which runs at sf 0.1 (at SF10 its expansion does not fit one card),
   through ``QueryRunner.execute`` under the default memory pool, each
   over a ``MemoryConnector`` that holds only the columns its SQL names
   (the tensors on the card are shared, not copied); every kernel
   launch counter is set to 0 just before each query and read just
   after it, and the run fails unless each query launched the kernels
   of its path; each query's pool peak is printed beside the card's;
5. check rows against the same queries run by the port on the CPU over
   the same generated data, exactly (doubles included): the fifth slice's 13
   TPC-DS queries and q29 at SF10 (the rows of phase 4), TPC-H at
   SF 1 (the card runs the 22 queries again over the SF 1 tables; Q22,
   which finds no row there, also without its anti join), the other
   TPC-DS queries at SF 1 (run again there on the card), q72 at sf
   0.01; the functions, the dates and aggregate tail and the
   containers phases at SF 1, exact but for skewness's doubles (``FN_APPROX``: its pow, a relative
   1e-12);
6. print per-query wall time, fact rows/s and a trace summary, a
   ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the ``presto_tpu`` package.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time

# the caching allocator grows segments in place instead of reserving one
# per size: after the containers' multi-GB states, TPC-DS's large joins
# otherwise meet 20 GiB reserved in fragments they cannot use
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SF = 10.0  # TPC-H scale factor: ~60M lineitem rows
SPLIT_ROWS = 1 << 23  # rows per lineitem split, as bench.py uses on an accelerator
REPS = 3  # timed repetitions per query after the counted run
# the TPC-H rows are checked against the CPU at this scale (the card runs
# the 22 queries again over these tables), so that the TPC-DS path's CPU
# check fits the run's time
TPCH_CHECK_SF = 1.0
DS_SF = 10.0  # TPC-DS: store_sales 28.8M rows, catalog_sales 14.4M, web_sales 7.2M
DS_SPLIT_ROWS = 1 << 23
# the columns the 22 queries read; lineitem's l_linenumber keeps its
# declared order (l_orderkey, l_linenumber), which a connector keeps
# only with both columns and Q18's streaming aggregation reads
TABLES = {
    "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                 "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode"],
    "orders": ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice", "o_orderdate",
               "o_orderpriority", "o_shippriority", "o_comment"],
    "customer": ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone", "c_acctbal",
                 "c_mktsegment", "c_comment"],
    "part": ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size", "p_container"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal",
                 "s_comment"],
    "nation": ["n_nationkey", "n_name", "n_regionkey"],
    "region": ["r_regionkey", "r_name"],
}


def _tpch_queries(module: str = "tpch_queries") -> dict:
    """The query texts the tests use (``tests/tpch_queries.py``, or
    ``tests/tpcds_queries.py``)."""
    path = pathlib.Path(__file__).resolve().parent / "tests" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.QUERIES


SQL = _tpch_queries()
Q6, Q1, Q14, Q3 = SQL[6], SQL[1], SQL[14], SQL[3]
QUERIES = {f"q{q}": SQL[q] for q in (6, 1, 14, 3, 4, 5, 10, 12, 13, 16, 19, 20,
                                      2, 7, 8, 9, 11, 15, 17, 18, 21, 22)}
DS_SQL = _tpch_queries("tpcds_queries")
# the fifth slice: the bench's q3 and q7, the windowed queries, and q13
# (nine dictionary tables in one predicate)
DS_QUERIES = {f"ds_q{q}": DS_SQL[q] for q in (3, 7, 12, 20, 98, 53, 63, 89, 44, 47, 57, 51,
                                              13)}
DS_WINDOWED = ("ds_q12", "ds_q20", "ds_q98", "ds_q53", "ds_q63", "ds_q89", "ds_q44",
               "ds_q47", "ds_q57", "ds_q51")
# the sixth slice: UNION, ROLLUP, string CASE and column comparisons,
# coalesce/floor/round, long add/sub, sum0 and collapsed sums,
# variance, double sums and double keys
DS2_QUERIES = {f"ds_q{q}": DS_SQL[q] for q in (2, 4, 11, 33, 49, 54, 56, 60, 66, 71, 74, 75,
                                               76, 5, 14, 18, 22, 27, 67, 77, 80, 6, 8, 19,
                                               46, 68, 36, 70, 86, 16, 28, 95, 17, 39, 40, 78,
                                               23)}
# the sixth slice's rows are checked at this scale: the card runs its
# queries again over these tables and the CPU runs them once
DS_CHECK_SF = 1.0
# queries that may find no row at DS_CHECK_SF: q76 picks the sales
# whose store, web page or ship address key is NULL, which this
# generator never writes (no row at any scale)
DS2_EMPTY_AT_CHECK = ("ds_q76",)


# the seventh slice: the 49 TPC-DS queries that ran only on the CPU
# before (tests/test_torch_tpcds_corpus.py BEFORE without q3, and
# tests/test_torch_tpcds.py ALSO without q13), their rows checked at
# DS_CHECK_SF as the sixth slice's are
DS3_QUERIES = {f"ds_q{q}": DS_SQL[q] for q in (1, 9, 10, 15, 24, 25, 29, 30, 32, 34, 37, 38,
                                               41, 42, 43, 45, 48, 50, 52, 55, 59, 61, 62,
                                               64, 65, 69, 72, 79, 81, 82, 84, 87, 88, 90,
                                               91, 92, 93, 94, 96, 97, 99, 21, 26, 31, 35,
                                               58, 73, 83, 85)}
# q29 finds no row at DS_CHECK_SF (22 at DS_SF): its rows are checked at
# DS_SF, the counted run's against the CPU's; q85 finds no row at any
# scale this generator was run at (sf 0.01 to 10), in both packages
DS3_CHECK_AT_DS_SF = ("ds_q29",)
DS3_EMPTY_AT_CHECK = ("ds_q85",)
# queries that do not fit one card at DS_SF: (scale on the card, scale
# of the row check).  q72 joins catalog_sales to inventory on the item
# key alone (inventory has 23.49M rows at every scale), so its
# expansion grows with catalog_sales: it ran out of the card's memory
# at sf 0.2 and above and peaked at 53.33 GiB at sf 0.1; its CPU run
# takes ~190 s at sf 0.1 and ~20 s at 0.01
DS3_SCALE = {"ds_q72": (0.1, 0.01)}
# the eighth slice, the function surface at SF10 over the resident TPC-H
# tables (run before they leave the card; rows checked at
# TPCH_CHECK_SF): approx_distinct, min/max over doubles, varchar and
# booleans with the bool and bitwise aggregates, count_if beside
# unfiltered aggregates, the math family, date parts and casts,
# bitwise scalars, and the LIMIT and TABLESAMPLE scans
FN_QUERIES = {
    "fn_approx_distinct": "select approx_distinct(l_partkey) from lineitem",
    "fn_approx_distinct_grouped": "select l_returnflag, l_linestatus, approx_distinct("
                                  "l_orderkey) from lineitem group by l_returnflag, l_linestatus",
    "fn_minmax": "select l_shipmode, min(l_extendedprice / l_quantity), max(l_extendedprice / "
                 "l_quantity), min(l_shipinstruct), max(l_shipinstruct), min(l_returnflag = 'R'), "
                 "max(l_linestatus = 'F'), bool_and(l_quantity > 1), bool_or(l_quantity > 49), "
                 "bitwise_and_agg(l_orderkey), bitwise_or_agg(l_partkey) from lineitem "
                 "group by l_shipmode",
    "fn_minmax_by_supplier": "select l_suppkey, min(l_extendedprice / l_quantity), "
                             "max(l_extendedprice / l_quantity), bool_and(l_quantity > 1), "
                             "bitwise_or_agg(l_partkey) from lineitem group by l_suppkey",
    "fn_count_if": "select count_if(l_quantity > 25), count(*), sum(l_quantity) from lineitem",
    "fn_count_if_grouped": "select l_returnflag, count_if(l_quantity > 25), count(*), "
                           "sum(l_quantity) from lineitem group by l_returnflag",
    "fn_math": "select sum(sqrt(l_extendedprice)), sum(ln(l_extendedprice)), "
               "sum(power(l_quantity, 2)), sum(greatest(l_discount, l_tax)), "
               "sum(sign(l_quantity - 25)), count(nullif(l_linenumber, 1)), "
               "sum(width_bucket(l_extendedprice, 0, 100000, 20)), sum(mod(l_orderkey, 7)) "
               "from lineitem",
    "fn_dates": "select day_of_week(l_shipdate), count(*), max(last_day_of_month(l_shipdate)), "
                "sum(day_of_year(l_shipdate)), min(week(l_receiptdate)), "
                "sum(cast(l_extendedprice as bigint)) from lineitem "
                "group by day_of_week(l_shipdate)",
    "fn_bits": "select l_linestatus, sum(bit_count(l_orderkey, 64)), "
               "sum(bitwise_shift_left(l_partkey, 3, 64)), sum(bitwise_xor(l_orderkey, "
               "l_partkey)), bitwise_or_agg(bitwise_shift_right(l_orderkey, 2, 64)) "
               "from lineitem group by l_linestatus",
    "fn_limit": "select l_orderkey, l_partkey, l_quantity from lineitem limit 10",
    "fn_bernoulli": "select count(*), sum(l_quantity) from lineitem tablesample bernoulli (10)",
    "fn_system": "select count(*), sum(l_extendedprice) from lineitem tablesample system (50)",
}
# the ninth slice, timestamps and date arithmetic, string functions over
# dictionaries and the coupled and statistical aggregates, at SF10 over
# the same resident tables (rows checked at TPCH_CHECK_SF with
# check_fn_rows): a dashboard's monthly rollup, a shipping-delay
# report, timestamp arithmetic, a date_format group key, string value
# tables and casts, and the aggregate tail by a small key (the sort
# path: its double states), by l_suppkey (100k groups and their merge),
# globally (K2's slot, K3's fold) and by two flags (K2's packed slots)
DT_QUERIES = {
    "dt_trunc_month": "select date_trunc('month', l_shipdate), count(*), sum(l_extendedprice) "
                      "from lineitem group by date_trunc('month', l_shipdate)",
    "dt_diff": "select l_shipmode, sum(date_diff('day', l_shipdate, l_receiptdate)), "
               "max(date_diff('month', l_commitdate, l_receiptdate)), "
               "min(date_add('month', 1, l_shipdate)) from lineitem group by l_shipmode",
    "dt_timestamp": "select date_trunc('week', cast(l_shipdate as timestamp) + interval '90' "
                    "minute), count(*), max(to_unixtime(cast(l_receiptdate as timestamp))), "
                    "sum(minute(cast(l_shipdate as timestamp) + interval '90' minute)) "
                    "from lineitem where cast(l_shipdate as timestamp) + interval '90' minute "
                    "> timestamp '1995-06-01 12:00:00' group by date_trunc('week', "
                    "cast(l_shipdate as timestamp) + interval '90' minute)",
    "dt_format": "select date_format(o_orderdate, '%Y-%m'), count(*), sum(o_totalprice) "
                 "from orders group by 1",
    "str_lut": "select length(p_name), count(*) from part where strpos(p_name, 'green') > 0 "
               "or starts_with(p_type, 'PROMO') group by length(p_name)",
    "str_cast": "select cast(substr(c_phone, 1, 2) as bigint), "
                "sum(cast(substr(c_phone, 1, 2) as bigint)), "
                "max(cast(substr(c_phone, 4, 3) as double)) from customer "
                "where regexp_like(c_name, '9$') group by cast(substr(c_phone, 1, 2) as bigint)",
    "agg_tail_mode": "select l_shipmode, min_by(l_orderkey, l_extendedprice), "
                     "max_by(l_partkey, l_discount), skewness(l_quantity), "
                     "kurtosis(l_extendedprice), covar_samp(l_extendedprice, l_quantity), "
                     "corr(l_extendedprice, l_discount), regr_slope(l_extendedprice, l_quantity), "
                     "checksum(l_orderkey) from lineitem group by l_shipmode",
    "agg_tail_supplier": "select l_suppkey, min_by(l_orderkey, l_extendedprice), "
                         "max_by(l_partkey, l_discount), skewness(l_quantity), "
                         "kurtosis(l_extendedprice), covar_samp(l_extendedprice, l_quantity), "
                         "corr(l_extendedprice, l_discount), "
                         "regr_slope(l_extendedprice, l_quantity), checksum(l_orderkey) "
                         "from lineitem group by l_suppkey",
    "agg_tail_global": "select min_by(l_orderkey, l_extendedprice), max_by(l_partkey, "
                       "l_discount), skewness(l_quantity), kurtosis(l_extendedprice), "
                       "covar_samp(l_extendedprice, l_quantity), corr(l_extendedprice, "
                       "l_discount), regr_intercept(l_extendedprice, l_quantity), "
                       "checksum(l_orderkey), covar_pop(l_extendedprice, l_quantity) "
                       "from lineitem",
    "agg_tail_flags": "select l_returnflag, l_linestatus, min_by(l_orderkey, l_extendedprice), "
                      "max_by(l_shipdate, l_receiptdate), checksum(l_partkey) from lineitem "
                      "group by l_returnflag, l_linestatus",
}
# skewness's power(m2, 1.5) is libdevice's pow on the card and torch's
# on the CPU, which may round apart: that column of a query's rows
# within a relative 1e-12, every other value exact
FN_APPROX = {"agg_tail_mode": (3,), "agg_tail_supplier": (3,), "agg_tail_global": (2,)}
# the tenth slice, ARRAY, MAP and ROW values, at SF10 over the same
# resident tables, no cut (rows checked at TPCH_CHECK_SF with
# check_fn_rows): array_agg of l_partkey by l_orderkey (15M groups over
# 60M rows: K6's runs, K14's collect and merge), the same arrays
# unnested back to 60M rows WITH ORDINALITY (K13), a word count of
# part names through split and UNNEST, histogram and map_agg, per-row
# K12 work over lineitem (contains, a subscript, a map lookup, a ROW
# field) and the lambdas over the aggregated arrays
CT_QUERIES = {
    "ct_array_agg": "select count(*), sum(cardinality(a)), sum(array_sum(a)), "
                    "sum(element_at(a, 1)) from (select l_orderkey, array_agg(l_partkey) a "
                    "from lineitem group by l_orderkey)",
    "ct_unnest": "select count(*), sum(e), sum(o), max(o) from (select l_orderkey, "
                 "array_agg(l_partkey) a from lineitem group by l_orderkey) cross join "
                 "unnest(a) with ordinality as u(e, o)",
    "ct_words": "select w, count(*) c from part cross join unnest(split(p_name, ' ')) as u(w) "
                "group by w order by c desc, w limit 10",
    "ct_histogram": "select histogram(l_shipmode) from lineitem",
    "ct_histogram_by": "select l_returnflag, histogram(l_linenumber) from lineitem "
                       "group by 1 order by 1",
    "ct_map_agg": "select map_agg(l_returnflag, c), cardinality(map_agg(l_returnflag, c)) "
                  "from (select l_returnflag, count(*) c from lineitem group by 1)",
    "ct_row_ops": "select sum(case when contains(array[1, 5, 7], l_linenumber) then 1 else 0 "
                  "end), sum(array[l_partkey, l_suppkey][2]), "
                  "sum(map(array['A','N','R'], array[1,2,3])[l_returnflag]), "
                  "sum(cast(row(l_partkey, l_suppkey) as row(x bigint, y bigint)).x) "
                  "from lineitem",
    "ct_lambdas": "select count(*), sum(array_sum(transform(a, x -> x * 2))), "
                  "sum(cardinality(filter(a, x -> x % 2 = 0))), "
                  "sum(case when any_match(a, x -> x > 100000) then 1 else 0 end), "
                  "sum(reduce(a, 0, (s, x) -> s + x, s -> s)) from (select l_orderkey, "
                  "array_agg(l_partkey) a from lineitem group by l_orderkey)",
}


def _spill_sql() -> dict:
    """AGG_SQL, JOIN_SQL and FULL_SQL of ``tests/test_spill.py``, read
    without importing it (it imports the JAX package)."""
    import ast

    path = pathlib.Path(__file__).resolve().parent / "tests" / "test_spill.py"
    tree = ast.parse(path.read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id.endswith("_SQL")}


# the spill phase at SF10: each query unconstrained, then under a pool
# at SPILL_FRACTION of its largest reservation at a spill site (a join
# build or an aggregation accumulator)
_SPILL = _spill_sql()
SPILL_QUERIES = {"spill_agg": _SPILL["AGG_SQL"], "spill_join": _SPILL["JOIN_SQL"],
                 "spill_full": _SPILL["FULL_SQL"], "spill_q18": SQL[18]}
SPILL_SITES = {"spill_agg": ("agg_accumulator@",), "spill_join": ("join_build@",),
               "spill_full": ("join_build@",),
               "spill_q18": ("join_build@", "agg_accumulator@")}
SPILL_FRACTION = 0.6


def empty_variants(sf: float) -> dict:
    """What runs where a query finds no row at ``sf``: Q11 with the
    spec's FRACTION of 0.0001 / SF (the SQL's 0.0001 is SF 1's), Q22
    without its anti join (the generator gives nearly every customer an
    order)."""
    fraction = f"{0.0001 / sf:.12f}".rstrip("0")
    variants = {"q11": SQL[11].replace("* 0.0001", f"* {fraction}"),
                "q22": SQL[22].replace(
                    "and not exists (\n            select * from orders where o_custkey "
                    "= c_custkey\n        )", "")}
    for label, sql in variants.items():
        if sql == QUERIES[label] and sf != 1:
            raise AssertionError(f"{label}: the variant's text was not found")
    return variants
# the kernels each query's path must launch; "join_probe:<kind>" counts
# K5 launches of one kind, "expr_eval:in" K1 launches of programs that
# test IN, "expr_eval:<op>" those of programs holding a fourth-slice
# opcode, "<kernel>:minmax" launches with a min/max state,
# "sorted_group_agg:presorted" K6's presorted mode, "topn:n>32" K7
# launches past 32 rows
REQUIRED = {
    "q6": ("expr_eval", "packed_group_agg", "packed_fold_finalize"),
    "q1": ("expr_eval", "packed_group_agg", "packed_fold_finalize"),
    "q14": ("expr_eval", "packed_group_agg", "packed_fold_finalize", "join_build",
            "join_probe"),
    "q3": ("expr_eval", "packed_fold_finalize", "join_build", "join_probe",
           "sorted_group_agg", "topn"),
    "q4": ("expr_eval", "join_build", "join_probe:semi", "packed_group_agg",
           "packed_fold_finalize"),
    "q5": ("expr_eval", "join_build", "join_probe", "join_expand", "packed_group_agg",
           "packed_fold_finalize"),
    "q10": ("expr_eval", "join_build", "join_probe", "sorted_group_agg", "hash_keys",
            "topn"),
    "q12": ("expr_eval", "expr_eval:in", "join_build", "join_probe", "packed_group_agg",
            "packed_fold_finalize"),
    "q13": ("expr_eval", "join_build", "join_expand", "sorted_group_agg", "hash_keys"),
    "q16": ("expr_eval", "expr_eval:in", "join_build", "join_probe:anti_null_aware",
            "sorted_group_agg"),
    "q19": ("expr_eval", "expr_eval:in", "join_build", "join_probe", "packed_group_agg",
            "packed_fold_finalize"),
    "q20": ("expr_eval", "join_build", "join_probe:semi", "sorted_group_agg"),
    "q2": ("expr_eval", "join_build", "join_probe", "sorted_group_agg:minmax", "topn:n>32"),
    "q7": ("expr_eval:year", "join_build", "join_probe", "sorted_group_agg", "hash_keys"),
    "q8": ("expr_eval:year", "join_build", "join_probe", "sorted_group_agg"),
    "q9": ("expr_eval:year", "join_build", "join_probe", "sorted_group_agg"),
    "q11": ("expr_eval:lcmp", "join_build", "join_probe", "packed_group_agg",
            "sorted_group_agg"),
    "q15": ("expr_eval:lcmp", "join_build", "join_probe", "packed_group_agg:minmax",
            "packed_fold_finalize", "sorted_group_agg"),
    "q17": ("expr_eval:s2d", "join_build", "join_probe", "packed_group_agg",
            "sorted_group_agg"),
    "q18": ("expr_eval", "join_build", "join_probe:semi", "sorted_group_agg:presorted",
            "hash_keys", "topn:n>32"),
    "q21": ("expr_eval:not_null", "join_build", "join_probe", "sorted_group_agg:minmax",
            "topn:n>32"),
    "q22": ("expr_eval", "expr_eval:in", "join_build", "join_probe:anti", "packed_group_agg",
            "sorted_group_agg"),
}
# "window_eval" is K10; "expr_eval:double" K1 launches of programs that
# hold a double opcode (each opcode also by its own name);
# "packed_fold_finalize:avg_double" K3 finalizes with an integer's avg
# as a double; "topn:double" K7 launches with a double key
_DOUBLE_FILTER = ("expr_eval:double", "expr_eval:load_f64", "expr_eval:dsub",
                  "expr_eval:dabs", "expr_eval:dcmp")
DS_REQUIRED = {
    "ds_q3": ("expr_eval", "join_build", "join_probe", "sorted_group_agg",
              "packed_fold_finalize", "topn"),
    "ds_q7": ("expr_eval", "join_build", "join_probe", "sorted_group_agg",
              "packed_fold_finalize:avg_double", "topn"),
    "ds_q12": ("expr_eval:s2d", "join_build", "join_probe", "sorted_group_agg",
               "window_eval"),
    "ds_q20": ("expr_eval:s2d", "join_build", "join_probe", "sorted_group_agg",
               "window_eval", "topn"),
    "ds_q98": ("expr_eval:s2d", "join_build", "join_probe", "sorted_group_agg",
               "window_eval"),
    "ds_q53": ("join_build", "join_probe", "window_eval") + _DOUBLE_FILTER,
    "ds_q63": ("join_build", "join_probe", "window_eval", "topn:double") + _DOUBLE_FILTER,
    "ds_q89": ("join_build", "join_probe", "window_eval", "topn:double") + _DOUBLE_FILTER,
    "ds_q44": ("expr_eval", "join_build", "sorted_group_agg", "window_eval"),
    "ds_q47": ("join_build", "join_probe", "join_expand", "window_eval", "topn")
    + _DOUBLE_FILTER,
    "ds_q57": ("join_build", "join_probe", "join_expand", "window_eval", "topn")
    + _DOUBLE_FILTER,
    "ds_q51": ("join_build", "join_probe", "join_expand", "sorted_group_agg", "window_eval"),
    "ds_q13": ("expr_eval", "join_build", "join_probe", "packed_fold_finalize:avg_double"),
}
# "a|b" is met when either counter is non-zero (a grouping takes K2 or
# K6 by its key domains at this scale).  The new kinds by name: K1's
# opcodes and tables (coalesce, floor, round, ladd, remap, string_eq),
# the variance states and double sums of K2/K6 and K6's variance merge,
# K3's sum0, collapsed sums, variance finalizes and Chan fold, K9 over
# a double key
_GROUPED = "packed_group_agg|sorted_group_agg"
_VAR = ("sorted_group_agg:variance", "sorted_group_agg:variance_merge",
        "packed_fold_finalize:variance")
_BASE = ("expr_eval", "join_build", _GROUPED, "packed_fold_finalize")
DS2_REQUIRED = {
    "ds_q2": ("join_build", _GROUPED, "packed_fold_finalize", "topn"),
    **{f"ds_q{q}": _BASE + ("topn",) for q in (33, 56, 60, 66, 71, 5, 14, 77, 80)},
    "ds_q23": _BASE,
    "ds_q4": _BASE + ("topn", "sorted_group_agg:double_sum"),
    "ds_q11": _BASE + ("topn",),
    "ds_q74": _BASE + ("topn",),
    "ds_q49": _BASE + ("topn", "window_eval", "expr_eval:coalesce", "hash_keys:double"),
    "ds_q54": _BASE + ("topn", "expr_eval:floor", "hash_keys:double"),
    "ds_q75": _BASE + ("topn", "expr_eval:coalesce", "expr_eval:ladd"),
    "ds_q76": ("expr_eval", "join_build", _GROUPED, "topn"),
    **{f"ds_q{q}": _BASE for q in (18, 22, 27)},
    "ds_q67": _BASE + ("topn", "window_eval", "expr_eval:coalesce"),
    "ds_q77": _BASE + ("topn", "expr_eval:coalesce"),
    "ds_q80": _BASE + ("topn", "expr_eval:coalesce"),
    **{f"ds_q{q}": _BASE + ("expr_eval:string_eq",) for q in (6, 8, 19, 46, 68)},
    **{f"ds_q{q}": _BASE + ("topn", "window_eval", "expr_eval:remap") for q in (36, 70, 86)},
    "ds_q16": _BASE + ("packed_fold_finalize:collapse",),
    "ds_q28": _BASE + ("packed_fold_finalize:sum0", "packed_fold_finalize:collapse"),
    "ds_q95": _BASE + ("packed_fold_finalize:collapse",),
    "ds_q17": _BASE + ("topn",) + _VAR,
    "ds_q39": _BASE + _VAR,
    "ds_q40": _BASE + ("topn", "expr_eval:coalesce"),
    "ds_q78": _BASE + ("topn", "expr_eval:coalesce", "expr_eval:round"),
}
# the eighth slice's kernels by path; "<kernel>:<kind>" counts the
# launches holding a new opcode family (K1) or state kind (K2, K3, K6),
# "expr_eval:collation" K1's varchar collation-rank tables; a LIMIT scan
# launches no kernel
FN_REQUIRED = {
    "fn_approx_distinct": ("expr_eval:hll", "sorted_group_agg", "packed_group_agg:hll",
                           "packed_fold_finalize:hll"),
    "fn_approx_distinct_grouped": ("expr_eval:hll", "sorted_group_agg:hll",
                                   "packed_fold_finalize:hll"),
    "fn_minmax": ("expr_eval:collation", "packed_group_agg:min_double", "packed_group_agg:bool",
                  "packed_group_agg:min_bool", "packed_group_agg:bitwise",
                  "packed_fold_finalize:min_double", "packed_fold_finalize:bool",
                  "packed_fold_finalize:bitwise"),
    "fn_count_if": ("expr_eval", "packed_group_agg", "packed_fold_finalize"),
    "fn_count_if_grouped": ("expr_eval", "packed_group_agg", "packed_fold_finalize"),
    "fn_minmax_by_supplier": ("sorted_group_agg:min_double", "sorted_group_agg:bitwise",
                              "packed_fold_finalize:bool"),
    "fn_math": ("expr_eval:dun", "expr_eval:dbin", "expr_eval:gl", "expr_eval:nullif",
                "expr_eval:wbucket", "expr_eval:imod", "packed_group_agg:double_sum",
                "packed_fold_finalize"),
    "fn_dates": ("expr_eval:year", "expr_eval:castbi", "hash_keys", "sorted_group_agg"),
    "fn_bits": ("expr_eval:bitw", "packed_group_agg:bitwise", "packed_fold_finalize:bitwise"),
    "fn_limit": (),
    "fn_bernoulli": ("packed_group_agg", "packed_fold_finalize"),
    "fn_system": ("packed_group_agg", "packed_fold_finalize"),
}
# the ninth slice's kernels by path, by opcode and state kind
_TAIL_SORTED = ("expr_eval:mix64", "sorted_group_agg:moments", "sorted_group_agg:min_by",
                "sorted_group_agg:double_sum", "sorted_group_agg:moments_merge",
                "packed_fold_finalize:moments", "packed_fold_finalize:covariance")
DT_REQUIRED = {
    "dt_trunc_month": ("expr_eval:dtrunc", _GROUPED, "packed_fold_finalize"),
    "dt_diff": ("expr_eval:dtdiff", "expr_eval:dtadd", "packed_group_agg",
                "packed_fold_finalize"),
    "dt_timestamp": ("expr_eval:castts", "expr_eval:dtadd", "expr_eval:dtrunc",
                     "expr_eval:unixt", "expr_eval:tspart", _GROUPED),
    "dt_format": ("expr_eval:dfmt", "sorted_group_agg"),
    "str_lut": ("expr_eval:vlut", _GROUPED),
    "str_cast": ("expr_eval:vlut", "expr_eval:dvlut", "sorted_group_agg"),
    "agg_tail_mode": _TAIL_SORTED,
    "agg_tail_supplier": _TAIL_SORTED,
    "agg_tail_global": ("expr_eval:mix64", "packed_group_agg:checksum",
                        "packed_group_agg:moments", "packed_group_agg:min_by",
                        "packed_group_agg:double_sum", "packed_fold_finalize:moments_fold",
                        "packed_fold_finalize:min_by_fold", "packed_fold_finalize:moments",
                        "packed_fold_finalize:covariance"),
    "agg_tail_flags": ("expr_eval:mix64", "packed_group_agg:checksum", "packed_group_agg:min_by",
                       "packed_fold_finalize:min_by_fold"),
}
CT_REQUIRED = {
    "ct_array_agg": ("sorted_group_agg", "group_collect", "group_collect:merge",
                     "container_eval:card", "container_eval:reduce",
                     "container_eval:subscript"),
    "ct_unnest": ("group_collect", "unnest_expand", _GROUPED),
    "ct_words": ("container_eval:table", "unnest_expand", _GROUPED),
    "ct_histogram": ("group_collect", _GROUPED),
    "ct_histogram_by": ("group_collect", "sorted_group_agg"),
    "ct_map_agg": ("group_collect", "container_eval:card"),
    "ct_row_ops": ("container_eval:construct", "container_eval:contains",
                   "container_eval:subscript", "container_eval:construct_map",
                   "container_eval:map_get", "container_eval:row_field", "expr_eval"),
    "ct_lambdas": ("group_collect", "unnest_expand", "container_eval:assemble",
                   "container_eval:compact", "container_eval:match", "container_eval:slot",
                   "container_eval:reduce"),
}
# where each kernel's TPU counterpart lives in the reference package
REPLACES = {
    "expr_eval": "presto_tpu/expr/compile.py:919",
    "packed_group_agg": "presto_tpu/ops/aggregate.py:1863",
    "packed_fold_finalize": "presto_tpu/ops/aggregate.py:870",
    "join_build": "presto_tpu/ops/join.py:160",
    "join_probe": "presto_tpu/ops/join.py:298",
    "sorted_group_agg": "presto_tpu/ops/aggregate.py:1776",
    "topn": "presto_tpu/ops/sort.py:121",
    "join_expand": "presto_tpu/ops/join.py:376",
    "hash_keys": "presto_tpu/ops/aggregate.py:1686",
    "window_eval": "presto_tpu/ops/window.py:106",
    "spill_partition": "presto_tpu/exec/spill.py:65",
    "spill_partition@gather": "presto_tpu/exec/spill.py:90",
    "join_build@null_flags": "presto_tpu/ops/join.py:237",
    "expr_eval@dun_sqrt": "presto_tpu/expr/compile.py:2356",
    "expr_eval@dun_ln": "presto_tpu/expr/compile.py:2356",
    "expr_eval@dbin_power": "presto_tpu/expr/compile.py:2356",
    "expr_eval@bitw": "presto_tpu/expr/compile.py:2480",
    "expr_eval@gl": "presto_tpu/expr/compile.py:2528",
    "expr_eval@nullif": "presto_tpu/expr/compile.py:1249",
    "expr_eval@castbi": "presto_tpu/expr/compile.py:1090",
    "expr_eval@hll": "presto_tpu/expr/compile.py:1583",
    "expr_eval@datepart": "presto_tpu/expr/compile.py:3102",
    "expr_eval@wbucket": "presto_tpu/expr/compile.py:2395",
    "expr_eval@imod": "presto_tpu/expr/compile.py:886",
    "packed_group_agg@min_double": "presto_tpu/ops/aggregate.py:454",
    "packed_group_agg@bool_bitwise": "presto_tpu/ops/aggregate.py:361",
    "packed_group_agg@hll": "presto_tpu/ops/aggregate.py:569",
    "sorted_group_agg@min_double": "presto_tpu/ops/aggregate.py:454",
    "sorted_group_agg@hll": "presto_tpu/ops/aggregate.py:1171",
    "packed_fold_finalize@functions": "presto_tpu/ops/aggregate.py:870",
    "packed_fold_finalize@functions_finalize": "presto_tpu/ops/aggregate.py:1562",
    "expr_eval@vlut": "presto_tpu/expr/compile.py:1279",
    "expr_eval@dvlut": "presto_tpu/expr/compile.py:1418",
    "expr_eval@tspart": "presto_tpu/expr/compile.py:3102",
    "expr_eval@dtrunc": "presto_tpu/expr/compile.py:3231",
    "expr_eval@dtadd": "presto_tpu/expr/compile.py:3267",
    "expr_eval@dtdiff": "presto_tpu/expr/compile.py:3297",
    "expr_eval@castts": "presto_tpu/expr/compile.py:3158",
    "expr_eval@unixt": "presto_tpu/expr/compile.py:3158",
    "expr_eval@dfmt": "presto_tpu/expr/compile.py:1556",
    "expr_eval@mix64": "presto_tpu/ops/aggregate.py:518",
    "packed_group_agg@checksum": "presto_tpu/ops/aggregate.py:518",
    "packed_group_agg@moments": "presto_tpu/ops/aggregate.py:480",
    "packed_group_agg@covariance": "presto_tpu/ops/aggregate.py:502",
    "packed_group_agg@min_by": "presto_tpu/ops/aggregate.py:536",
    "sorted_group_agg@moments": "presto_tpu/ops/aggregate.py:480",
    "sorted_group_agg@moments_merge": "presto_tpu/ops/aggregate.py:1118",
    "sorted_group_agg@covariance": "presto_tpu/ops/aggregate.py:502",
    "sorted_group_agg@min_by": "presto_tpu/ops/aggregate.py:536",
    "sorted_group_agg@min_by_merge": "presto_tpu/ops/aggregate.py:1151",
    "packed_fold_finalize@tail_fold": "presto_tpu/ops/aggregate.py:870",
    "packed_fold_finalize@tail_finalize": "presto_tpu/ops/aggregate.py:1447",
    "container_eval": "presto_tpu/expr/compile.py:1806",
    "container_eval@construct": "presto_tpu/ops/container.py:235",
    "container_eval@subscript": "presto_tpu/ops/container.py:252",
    "container_eval@contains": "presto_tpu/ops/container.py:283",
    "container_eval@map_get": "presto_tpu/ops/container.py:268",
    "container_eval@row_field": "presto_tpu/ops/container.py:179",
    "container_eval@card": "presto_tpu/ops/container.py:279",
    "container_eval@reduce": "presto_tpu/ops/container.py:299",
    "container_eval@sort": "presto_tpu/ops/container.py:320",
    "container_eval@table": "presto_tpu/expr/compile.py:1476",
    "container_eval@assemble": "presto_tpu/expr/compile.py:2284",
    "container_eval@compact": "presto_tpu/expr/compile.py:2284",
    "container_eval@match": "presto_tpu/expr/compile.py:2284",
    "container_eval@slot": "presto_tpu/expr/compile.py:2238",
    "unnest_expand": "presto_tpu/ops/container.py:472",
    "group_collect": "presto_tpu/ops/aggregate.py:640",
    "group_collect@merge": "presto_tpu/ops/aggregate.py:1185",
}


def release_host_memory() -> None:
    """Collect garbage and hand freed heap pages back to the system, so
    the later CPU row checks (TPC-DS q47's at SF10 most) find the room."""
    import ctypes

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    """Bytes of the distinct tensors among ``ts`` (each read once)."""
    seen = {}
    for t in ts:
        if t is not None:
            seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


def sector_bytes(t, rows) -> int:
    """Bytes of the distinct 32-byte sectors of ``t`` that reading its
    rows ``rows`` touches (the least a gather of them must move)."""
    if rows.numel() == 0:
        return 0
    row_bytes = t.stride(0) * t.element_size()
    first = rows * row_bytes // 32
    last = ((rows + 1) * row_bytes - 1) // 32
    return 32 * int(torch.unique(torch.cat([first, last])).numel())


def group_sum_library_ms(keys, row_mask, states) -> float:
    """Device ms of one ``index_add_`` that adds every state column of
    ``states`` (K6's inputs) into its group, by a group id computed
    beforehand over the live rows (dead rows dropped beforehand, as K6
    sorts them past its last group): the library call nearest to K6's
    work past the sort."""
    from presto_tpu_torch.kernels import keys as pk
    from presto_tpu_torch.kernels import sorted_group_agg as k6

    n = row_mask.shape[0]
    key, _ = pk.pack_plain(keys, n, row_mask.device)
    _, gid = torch.unique(key[row_mask], return_inverse=True)
    cols = []
    for kind, data, valid in states:
        if kind == k6.S_ONE:
            cols.append(row_mask.to(torch.int64))
        elif kind == k6.S_VALID:
            cols.append(valid.to(torch.int64))
        elif kind == k6.S_SUM:
            cols.append(torch.where(valid, data.to(torch.int64), 0))
        elif kind == k6.S_DSUM:
            cols.append(torch.where(valid, data, 0.0))
        else:
            limbs = k6._limbs(kind, data)
            cols.append(torch.where(valid[:, None], limbs, torch.zeros_like(limbs)))
    # a double sum adds its counts as doubles too (exact below 2^53)
    dtype = torch.float64 if any(c.is_floating_point() for c in cols) else torch.int64
    vals = torch.cat([c.reshape(n, -1).to(dtype) for c in cols], 1)[row_mask].contiguous()
    table = torch.zeros((int(gid.max()) + 1, vals.shape[1]), dtype=dtype,
                        device=row_mask.device)
    return cuda_ms(lambda: table.index_add_(0, gid, vals), 10)


def same(a, b, what: str) -> int:
    """Max absolute difference of two tensors (or nested tuples/lists of
    them); fails unless it is 0 with equal shapes and dtypes."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = 0 if torch.equal(a, b) else int(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max())
        if err:
            diff = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: kernel and plain version differ at {diff}")
        return err
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} vs {len(b)} outputs")
    return max((same(x, y, f"{what}[{i}]") for i, (x, y) in enumerate(zip(a, b))), default=0)


class KernelReport:
    def __init__(self):
        self.rows = {}
        # row name -> the launch count it reports, where a row stands
        # for one kind of launch (a K1 opcode, a K6 mode, ...)
        self.counters = {}

    def add(self, name, route, source, max_abs_err, ms, plain_ms, bound_bytes,
            library_ms=None, counter=None):
        if counter is not None:
            self.counters[name] = counter
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        self.rows[name] = {
            "name": name, "route": route, "source": source,
            "replaces": REPLACES.get(name, REPLACES[name.split("@")[0]]),
            "launches": 0, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        }
        log(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms"
            f"{'' if library_ms is None else f', library {library_ms:.4f} ms'}), "
            f"max_abs_err {max_abs_err}")


def check_kernels(report: KernelReport, runner, mem) -> None:
    """Phase 3: each kernel against its plain version at the main
    path's shapes (the first lineitem split and the Q6/Q1 plans)."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.ops.aggregate import (
        _finalize_kind, _slice_state_cols, kernel_inputs,
    )
    from presto_tpu_torch.planner.plan import AggregationNode, FilterNode

    page = mem.page_for_split("lineitem", 0)
    n = page.capacity
    q6_plan, q1_plan = runner.plan(Q6), runner.plan(Q1)
    comp = ExprCompiler.for_page(page)

    # K1: Q6's predicate as a filter, Q1's sum_charge argument as a projection
    pred = find(q6_plan, FilterNode).predicate
    prog, cols = comp.lower(pred)
    ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
    got = k1.expr_eval(prog, ins, n, row_mask=page.row_mask)
    want = k1.expr_eval_plain(prog, ins, n, row_mask=page.row_mask)
    err = same(got, want, "expr_eval filter")
    ms = cuda_ms(lambda: k1.expr_eval(prog, ins, n, row_mask=page.row_mask), 20)
    plain = cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n, row_mask=page.row_mask), 5)
    report.add("expr_eval", "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err, ms, plain,
               nbytes(*[t for c in ins for t in c], page.row_mask) + n)
    q1_agg = find(q1_plan, AggregationNode)
    charge = q1_agg.aggs[3].arg
    prog, cols = comp.lower(charge)
    ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
    err = same(k1.expr_eval(prog, ins, n), k1.expr_eval_plain(prog, ins, n),
               "expr_eval projection")
    ms = cuda_ms(lambda: k1.expr_eval(prog, ins, n), 20)
    plain = cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n), 5)
    report.add("expr_eval@q1_sum_charge", "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err,
               ms, plain, nbytes(*[t for c in ins for t in c]) + 9 * n)

    # K2: Q6's global state (1 slot), Q1's packed key (12 slots, and in
    # a 16-slot table), and a 16384-slot key that takes the global-atomics
    # path
    q6_agg = find(q6_plan, AggregationNode)
    _, q6_args = kernel_inputs(page, [], q6_agg.aggs, None)
    mg = runner.executor._max_groups(q1_agg)
    q1_keys, q1_args = kernel_inputs(page, q1_agg.group_exprs, q1_agg.aggs,
                                     q1_agg.key_domains)
    wide_key = (torch.remainder(page.blocks[0].data, 16383), page.blocks[0].valid, 0, 16384)
    (d0, v0, lo0, _), (d1, v1, lo1, _) = q1_keys
    keys16 = [(d0, v0, lo0, 4), (d1, v1, lo1, 4)]  # Q1's keys in a 4 x 4 table
    cases = [("q6_global", [], q6_args, 1), ("q1_packed", q1_keys, q1_args, mg),
             ("16_slots", keys16, q1_args, 16), ("16384_slots", [wide_key], q1_args, 16384)]
    for label, keys, args, g in cases:
        got = k2.packed_group_agg(n, page.row_mask, keys, args, g)
        want = k2.packed_group_agg_plain(n, page.row_mask, keys, args, g)
        err = same(got, want, f"packed_group_agg {label}")
        ms = cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, keys, args, g), 10)
        plain = cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, keys, args, g), 3)
        in_bytes = nbytes(page.row_mask, *[t for k in keys for t in k[:2]],
                          *[t for a in args for t in a[1:]])
        library = None
        if label in ("q6_global", "q1_packed"):
            # one PyTorch call over the same limbs: the global sum alone,
            # or Q1's sum_charge limbs added per precomputed group
            from presto_tpu_torch.ops import decimal128 as d128

            limbs = d128.to_sum_limbs(d128.from_int64(args[0 if label == "q6_global"
                                                           else 3][1]))
            if label == "q6_global":
                library = cuda_ms(lambda: torch.sum(limbs, dim=0), 10)
            else:
                gid = torch.zeros(n, dtype=torch.int64, device=page.device)
                for kd, kv, klo, kc in keys:
                    gid = gid * kc + torch.where(kv, kd.to(torch.int64) - klo + 1, 0)
                gid = torch.where(page.row_mask, gid, g)
                table = torch.zeros((g + 1, 4), dtype=torch.int64, device=page.device)
                library = cuda_ms(lambda: table.index_add_(0, gid, limbs), 10)
        name = "packed_group_agg" if label == "q1_packed" else f"packed_group_agg@{label}"
        out_bytes = nbytes(*[t for st in got[0] for t in st], got[1])
        report.add(name, "cuda", "presto_tpu_torch/csrc/packed_group_agg.cu", err, ms, plain,
                   in_bytes + out_bytes, library)

    # K3: fold Q1's partial tables of splits 0 and 1, then finalize
    from presto_tpu_torch.ops.aggregate import grouped_aggregate

    p1 = mem.page_for_split("lineitem", 1)
    parts = [grouped_aggregate(p, q1_agg.group_exprs, q1_agg.aggs, mg,
                               q1_agg.key_domains, mode="partial") for p in (page, p1)]
    nk = len(q1_agg.group_exprs)

    def cols_of(part):
        return [(k3.COL_D128 if b.type.is_long_decimal else k3.COL_I64, b.data, b.valid)
                for c in _slice_state_cols(part, nk, q1_agg.aggs) for b in c]

    ca, cb = cols_of(parts[0]), cols_of(parts[1])
    fold = k3.packed_fold(ca, cb, parts[0].row_mask, parts[1].row_mask)
    err = same(fold, k3.packed_fold_plain(ca, cb, parts[0].row_mask, parts[1].row_mask),
               "packed_fold_finalize fold")
    items = []
    pos = 0
    for agg in q1_agg.aggs:
        k = 1 if agg.fn in ("count", "count_star") else 2
        cols = fold[0][pos:pos + k]
        items.append((_finalize_kind(agg), cols[0][0], cols[-1][0]))
        pos += k
    fin_err = same(k3.packed_finalize(items, fold[1]),
                   k3.packed_finalize_plain(items, fold[1]), "packed_fold_finalize finalize")
    ms = cuda_ms(lambda: k3.packed_fold(ca, cb, parts[0].row_mask, parts[1].row_mask), 100)
    plain = cuda_ms(lambda: k3.packed_fold_plain(ca, cb, parts[0].row_mask,
                                                 parts[1].row_mask), 20)
    fold_bytes = nbytes(*[t for c in ca + cb for t in c[1:]], *[t for o in fold[0] for t in o],
                        parts[0].row_mask, parts[1].row_mask, fold[1])
    report.add("packed_fold_finalize", "cuda", "presto_tpu_torch/csrc/packed_fold_finalize.cu",
               err, ms, plain, fold_bytes)
    ms = cuda_ms(lambda: k3.packed_finalize(items, fold[1]), 100)
    plain = cuda_ms(lambda: k3.packed_finalize_plain(items, fold[1]), 20)
    fin_out = k3.packed_finalize(items, fold[1])
    fin_bytes = nbytes(*[t for _, s, c in items for t in (s, c)], fold[1],
                       *[t for o in fin_out for t in o])
    report.add("packed_fold_finalize@finalize", "cuda",
               "presto_tpu_torch/csrc/packed_fold_finalize.cu", fin_err, ms, plain, fin_bytes)


def find(node, cls):
    """The first ``cls`` node on the left spine under ``node``."""
    while not isinstance(node, cls):
        node = node.sources[0]
    return node


def first_split(ex, node):
    """The page the streaming chain of ``node`` produces from its first
    split, as the executor runs it."""
    page = next(ex._source_pages(ex._chain_leaf(node)))
    return ex._build_stage(node)(page)


def k1_row(report: KernelReport, name: str, expr, page, filt: bool = False,
           library=None, key: bool = False, counter=None):
    """K1 against its plain version on ``expr`` over ``page`` (as a
    filter with ``filt``, as a key's CANON program with ``key``);
    ``library`` times one PyTorch call beside it."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.kernels import expr_eval as k1

    c = ExprCompiler.for_page(page)
    prog, cols = c.lower_key(expr) if key else c.lower(expr)
    ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
    n = page.capacity
    mask = page.row_mask if filt else None
    err = same(k1.expr_eval(prog, ins, n, row_mask=mask),
               k1.expr_eval_plain(prog, ins, n, row_mask=mask), name)
    ms = cuda_ms(lambda: k1.expr_eval(prog, ins, n, row_mask=mask), 20)
    plain = cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n, row_mask=mask), 5)
    width = {k1.KIND_BOOL: 1, k1.KIND_I32: 4, k1.KIND_D128: 16}.get(prog.out_kind, 8)
    out = n if filt else n * (1 + width)
    report.add(name, "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err, ms, plain,
               nbytes(*[t for c in ins for t in c], mask) + out,
               library(prog, ins) if library is not None else None, counter)
    log(f"{name}: {len(prog.ops)} instructions, {len(prog.luts)} tables")


def check_join_kernels(report: KernelReport, runners) -> None:
    """Phase 3, the joins' slice: K1's new opcodes, K4, K5, K6 and K7
    against their plain versions at Q14's and Q3's shapes."""
    from presto_tpu_torch.kernels import join_build as k4
    from presto_tpu_torch.kernels import join_probe as k5
    from presto_tpu_torch.kernels import keys as pk
    from presto_tpu_torch.kernels import topn as k7
    from presto_tpu_torch.ops.aggregate import merge_aggregate, merge_inputs, sorted_inputs
    from presto_tpu_torch.ops.join import _direct_budget, key_columns, packed_domain_size
    from presto_tpu_torch.ops.sort import topn_keys
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.planner.plan import AggregationNode, JoinNode, ProjectNode, TopNNode

    exs = {"q14": runners["q14"].executor, "q3": runners["q3"].executor}
    q14, q3 = runners["q14"].plan(Q14), runners["q3"].plan(Q3)
    joins = {"q14": find(q14, JoinNode), "q3": find(q3, JoinNode)}
    src = "presto_tpu_torch/csrc/"

    # K4, unique-direct: Q14's build over part, Q3's over orders x customer
    builds = {}
    for label, join in joins.items():
        ex = exs[label]
        page = ex.build_side(join)
        keys = key_columns(page, join.right_keys, join.key_domains)
        prod = packed_domain_size(join.key_domains)
        if not (join.unique_build and prod <= _direct_budget(page)):
            raise AssertionError(f"{label}: the build does not take the unique branch")
        got = k4.join_build_unique(keys, page.row_mask, prod)
        want = k4.join_build_unique_plain(keys, page.row_mask, prod)
        err = same(got, want, f"join_build {label}")
        if not bool(got[3]):
            raise AssertionError(f"{label}: unique build reports a collision")
        ms = cuda_ms(lambda: k4.join_build_unique(keys, page.row_mask, prod), 5)
        plain = cuda_ms(lambda: k4.join_build_unique_plain(keys, page.row_mask, prod), 2)
        report.add("join_build" if label == "q3" else f"join_build@{label}", "cuda",
                   src + "join_build.cu", err, ms, plain,
                   nbytes(page.row_mask, *[t for k in keys for t in k[:2]]) +
                   nbytes(*got[:3]) + 1)
        builds[label] = ex._materialize_build(join)
        log(f"{label} build: {page.capacity} rows, {int(page.row_mask.sum())} live, "
            f"domain {prod}")

    # K4 on a broken promise: part's keys with one duplicate; the unique
    # branch reports it, the sorted branch (with its starts table) rebuilds
    ex = exs["q14"]
    page = ex.build_side(joins["q14"])
    (d, v, lo, card), = key_columns(page, joins["q14"].right_keys, joins["q14"].key_domains)
    d = d.clone()
    d[1] = d[0]
    keys = [(d, v, lo, card)]
    prod = packed_domain_size(joins["q14"].key_domains)
    got = k4.join_build_unique(keys, page.row_mask, prod)
    want = k4.join_build_unique_plain(keys, page.row_mask, prod)
    same((got[0], got[2], got[3]), (want[0], want[2], want[3]), "join_build collision")
    if bool(got[3]):
        raise AssertionError("join_build: a duplicate key went undetected")
    got = k4.join_build_sorted(keys, page.row_mask, prod)
    err = same(got, k4.join_build_sorted_plain(keys, page.row_mask, prod),
               "join_build sorted")
    ms = cuda_ms(lambda: k4.join_build_sorted(keys, page.row_mask, prod), 5)
    plain = cuda_ms(lambda: k4.join_build_sorted_plain(keys, page.row_mask, prod), 2)
    # one PyTorch call beside it: the starts table by torch.searchsorted
    # over the sorted keys (the part of the branch past torch.sort)
    slots = torch.arange(prod + 1, dtype=torch.int64, device=page.device)
    library = cuda_ms(lambda: torch.searchsorted(got[0], slots), 5)
    report.add("join_build@sorted_collision", "cuda", src + "join_build.cu", err, ms, plain,
               nbytes(page.row_mask, d, v) + nbytes(*got), library)

    # K5: the probe of the first lineitem split; K1 on Q14's arguments
    probes = {}
    for label, join in joins.items():
        build = builds[label]
        ex = exs[label]
        probe = first_split(ex, join.left)
        keys = key_columns(probe, join.left_keys, join.key_domains)
        cols = [(b.data, b.valid) for b in build.page.blocks]
        args = (keys, probe.row_mask, build.sorted_keys, build.perm, build.starts, cols)
        got = k5.join_probe(*args)
        err = same(got, k5.join_probe_plain(*args), f"join_probe {label}")
        ms = cuda_ms(lambda: k5.join_probe(*args), 10)
        plain = cuda_ms(lambda: k5.join_probe_plain(*args), 3)
        # one PyTorch call beside it: one build column gathered through
        # a precomputed row index
        n = probe.capacity
        key, ok = pk.pack_plain(keys, n, probe.device)
        kk = torch.clamp(key, 0, build.starts.shape[0] - 2)
        row = build.perm[build.starts[kk].to(torch.int64)].to(torch.int64)
        col = build.page.blocks[0].data
        library = cuda_ms(lambda: torch.index_select(col, 0, row), 10)
        # bytes this probe must move: its keys and mask read once, its
        # outputs written once, and the distinct 32-byte sectors its
        # live rows read in starts (starts[k] and starts[k + 1]) and its
        # matched rows read in perm and in each build column's data and
        # valid
        live_rows = probe.row_mask & ok
        live = int(live_rows.sum())
        matched = int(got[1].sum())
        out_bytes = nbytes(*[t for o in got[0] for t in o], got[1])
        live_k = kk[live_rows]
        pos = build.starts[kk[got[1]]].to(torch.int64)
        brow = build.perm[pos].to(torch.int64)
        touched = (sector_bytes(build.starts, torch.cat([live_k, live_k + 1]))
                   + sector_bytes(build.perm, pos)
                   + sum(sector_bytes(t, brow) for c in cols for t in c))
        report.add("join_probe" if label == "q3" else f"join_probe@{label}", "cuda",
                   src + "join_probe.cu", err, ms, plain,
                   nbytes(probe.row_mask, *[t for k in keys for t in k[:2]]) + out_bytes
                   + touched, library)
        from presto_tpu_torch.page import Block, Page

        probes[label] = Page(tuple(probe.blocks) + tuple(
            Block(dd, vv, b.type, b.dictionary)
            for (dd, vv), b in zip(got[0], build.page.blocks)), got[1])
        log(f"{label} probe of split 0: {n} rows, {live} live, "
            f"{int(got[1].sum())} matched")
    agg14 = find(q14, AggregationNode)
    k1_row(report, "expr_eval@q14_case_like", agg14.aggs[0].arg, probes["q14"])
    out14 = exs["q14"]._run_aggregation(agg14)
    k1_row(report, "expr_eval@q14_promo_div", find(q14, ProjectNode).projections[0], out14)
    ex = exs["q3"]
    cust = first_split(ex, find(joins["q3"].right, JoinNode).right.source)
    k1_row(report, "expr_eval@q3_mktsegment", find(joins["q3"].right, JoinNode).right.predicate,
           cust, filt=True)

    # K6: Q3's partial over the probe output, then the merge of every
    # split's partials; K7: Q3's top 10 over the merged groups
    agg3 = find(q3, AggregationNode)
    page = probes["q3"]
    keys, states, _ = sorted_inputs(page, agg3.group_exprs, agg3.aggs, agg3.key_domains)
    groups = k6_row(report, "sorted_group_agg", keys, page.row_mask, states,
                    library=group_sum_library_ms(keys, page.row_mask, states))
    log(f"q3 partial of split 0: {groups} groups")
    parts = list(ex._pages(ex.partial_node(agg3)))
    cat = concat_pages_device(parts)
    nk = len(agg3.group_exprs)
    keys, states, _ = merge_inputs(cat, nk, agg3.aggs, agg3.key_domains)
    groups = k6_row(report, "sorted_group_agg@merge", keys, cat.row_mask, states,
                    library=group_sum_library_ms(keys, cat.row_mask, states))
    log(f"q3 merge: {cat.capacity} partial rows from {len(parts)} splits, {groups} groups")
    groups = merge_aggregate(cat, nk, agg3.aggs, agg3.max_groups,
                             key_domains=agg3.key_domains)
    top = find(q3, TopNNode)
    keys = topn_keys(groups, top.sort_exprs, top.ascending, top.nulls_first)
    got = k7.topn(keys, groups.row_mask, top.count)
    err = same(got, k7.topn_plain(keys, groups.row_mask, top.count), "topn")
    ms = cuda_ms(lambda: k7.topn(keys, groups.row_mask, top.count), 20)
    plain = cuda_ms(lambda: k7.topn_plain(keys, groups.row_mask, top.count), 5)
    report.add("topn", "cuda", src + "topn.cu", err, ms, plain,
               nbytes(groups.row_mask, *[t for k in keys for t in k[:2]]) + 4 * top.count + 4)
    log(f"q3 top {top.count} of {groups.capacity} groups")
    for ex in exs.values():
        ex._builds.clear()


def find_all(node, cls) -> list:
    """Every ``cls`` node under ``node``, preorder, left first."""
    out, stack = [], [node]
    while stack:
        n = stack.pop()
        if isinstance(n, cls):
            out.append(n)
        stack.extend(reversed(n.sources))
    return out


def in_library(prog, ins):
    """One ``torch.isin`` of the column the program's first IN tests
    against its literals (or the codes its IN table accepts)."""
    from presto_tpu_torch.kernels import expr_eval as k1

    for i, (op, arg) in enumerate(zip(prog.ops, prog.args)):
        if op == k1.IN or (op == k1.LUT and prog.luts[arg].kind == "in"):
            col = ins[prog.args[i - 1]][0]
            if op == k1.IN:
                first = arg & ((1 << k1.IN_COUNT_SHIFT) - 1)
                vals = prog.consts[first:first + (arg >> k1.IN_COUNT_SHIFT)]
            else:
                vals = [c for c, hit in enumerate(prog.luts[arg].values) if hit]
            lits = torch.tensor(vals, dtype=col.dtype, device=col.device)
            return cuda_ms(lambda: torch.isin(col, lits), 20)
    raise AssertionError(f"no IN in {prog}")


def canon_library(prog, ins):
    """One indexing of the CANON table by the column's codes."""
    table = prog.luts[0].on(ins[0][0].device)
    codes = ins[0][0]
    return cuda_ms(lambda: table[codes], 20)


def remap_library(prog, ins):
    """One indexing of the program's first remap table by the codes of
    the column it reads."""
    from presto_tpu_torch.kernels import expr_eval as k1

    for i, (op, arg) in enumerate(zip(prog.ops, prog.args)):
        if op == k1.CANON and prog.luts[arg].kind == "remap":
            table = prog.luts[arg].on(ins[0][0].device)
            codes = ins[prog.args[i - 1]][0]
            return cuda_ms(lambda: table[codes], 20)
    raise AssertionError(f"no remap table in {prog}")


def lookup_bytes(build, key, live) -> int:
    """Bytes of the distinct sectors the live rows' lookups touch in the
    build's starts table (starts[k], starts[k + 1]), or, without one, of
    the sorted keys at their lower bounds."""
    if build.starts is not None:
        kk = torch.clamp(key[live], 0, build.starts.shape[0] - 2)
        return sector_bytes(build.starts, torch.cat([kk, kk + 1]))
    pos = torch.clamp(torch.searchsorted(build.sorted_keys, key[live]), 0,
                      build.sorted_keys.shape[0] - 1)
    return sector_bytes(build.sorted_keys, pos)


def check_slice_kernels(report: KernelReport, runners) -> None:
    """Phase 3, the third slice: K1's IN, K4's sorted branch at full size,
    K5's left, semi, anti and mark kinds, K8 and K9, against their plain
    versions at the shapes of Q4, Q5, Q10, Q12, Q13, Q14, Q16 and Q19."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import join_build as k4
    from presto_tpu_torch.kernels import join_expand as k8
    from presto_tpu_torch.kernels import join_probe as k5
    from presto_tpu_torch.kernels import keys as pk
    from presto_tpu_torch.ops.aggregate import merge_inputs
    from presto_tpu_torch.ops.join import _direct_budget, key_columns, packed_domain_size
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.planner.plan import AggregationNode, FilterNode, JoinNode

    src = "presto_tpu_torch/csrc/"
    plans = {q: runners[q].plan(QUERIES[q]) for q in ("q4", "q5", "q10", "q12", "q13", "q14",
                                                      "q16", "q19")}
    exs = {q: runners[q].executor for q in plans}

    def tests_in(prog):
        return k1.IN in prog.ops or any(t.kind == "in" for t in prog.luts)

    # K1: the largest filter with IN of Q12, Q16 and Q19
    for label in ("q12", "q16", "q19"):
        ex = exs[label]
        best = None
        for f in find_all(plans[label], FilterNode):
            page = first_split(ex, f.source)
            prog, _ = ExprCompiler.for_page(page).lower(f.predicate)
            if tests_in(prog) and (best is None or len(prog.ops) > best[0]):
                best = (len(prog.ops), f, page)
        _, f, page = best
        k1_row(report, f"expr_eval@{label}_in", f.predicate, page, filt=True,
               library=in_library)
        ex._builds.clear()

    # K4's sorted branch at full size: Q4's build (lineitem filtered,
    # keyed by l_orderkey) and Q5's (the four-way join, keyed by
    # (o_custkey, s_nationkey))
    joins = {"q4": find(plans["q4"], JoinNode), "q5": find(plans["q5"], JoinNode)}
    for label, join in joins.items():
        ex = exs[label]
        if join.unique_build:
            raise AssertionError(f"{label}: expected a non-unique build")
        page = ex.build_side(join)
        keys = key_columns(page, join.right_keys, join.key_domains)
        prod = packed_domain_size(join.key_domains)
        dom = prod if prod is not None and prod <= _direct_budget(page) else None
        got = k4.join_build_sorted(keys, page.row_mask, dom)
        err = same(got, k4.join_build_sorted_plain(keys, page.row_mask, dom),
                   f"join_build {label} sorted")
        ms = cuda_ms(lambda: k4.join_build_sorted(keys, page.row_mask, dom), 3)
        plain = cuda_ms(lambda: k4.join_build_sorted_plain(keys, page.row_mask, dom), 1)
        library = None
        if dom is not None:
            slots = torch.arange(dom + 1, dtype=torch.int64, device=page.device)
            library = cuda_ms(lambda: torch.searchsorted(got[0], slots), 3)
        report.add(f"join_build@{label}_sorted", "cuda", src + "join_build.cu", err, ms, plain,
                   nbytes(page.row_mask, *[t for k in keys for t in k[:2]]) + nbytes(*got),
                   library)
        log(f"{label} sorted build: {page.capacity} rows, {int(page.row_mask.sum())} live, "
            f"domain {dom}, {len(page.blocks)} columns; peak device memory so far "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        ex._builds.clear()

    # K5's new kinds: Q4's semi (and mark, null-aware, over the same
    # build), Q16's null-aware anti, a left probe against Q14's build
    j16 = next(j for j in find_all(plans["q16"], JoinNode) if j.kind == "anti")
    j14 = find(plans["q14"], JoinNode)
    cases = [("q4_semi", joins["q4"], k5.SEMI, joins["q4"].null_aware),
             ("q4_mark", joins["q4"], k5.MARK, True),
             ("q16_anti_null_aware", j16, k5.ANTI, j16.null_aware),
             ("q14_left", j14, k5.LEFT, False)]
    for label, join, kind, null_aware in cases:
        ex = exs[label.split("_")[0]]
        build = ex._materialize_build(join)
        probe = first_split(ex, join.left)
        keys = key_columns(probe, join.left_keys, join.key_domains)
        cols = [(b.data, b.valid) for b in build.page.blocks] if kind == k5.LEFT else []
        args = (keys, probe.row_mask, build.sorted_keys, build.perm, build.starts, cols, kind,
                False, null_aware, build.flags)
        got = k5.join_probe(*args)
        err = same(got, k5.join_probe_plain(*args), f"join_probe {label}")
        ms = cuda_ms(lambda: k5.join_probe(*args), 10)
        plain = cuda_ms(lambda: k5.join_probe_plain(*args), 3)
        n = probe.capacity
        key, ok = pk.pack_plain(keys, n, probe.device)
        live = probe.row_mask & ok
        out_bytes = nbytes(got[1], *[t for o in got[0] for t in o])
        bound = (nbytes(probe.row_mask, *[t for k in keys for t in k[:2]]) + out_bytes
                 + lookup_bytes(build, key, live))
        if kind == k5.LEFT:
            # one build column gathered through a precomputed row index
            kk = torch.clamp(key, 0, build.starts.shape[0] - 2)
            row = build.perm[build.starts[kk].to(torch.int64)].to(torch.int64)
            col = build.page.blocks[0].data
            library = cuda_ms(lambda: torch.index_select(col, 0, row), 10)
            matched = live & (build.starts[kk + 1] > build.starts[kk])
            brow = row[matched]
            bound += sector_bytes(build.perm, build.starts[kk[matched]].to(torch.int64)) + \
                sum(sector_bytes(t, brow) for c in cols for t in c)
        else:
            # presence of each probe key among the build's keys
            bkeys = build.sorted_keys[build.sorted_keys != pk.I64_MAX]
            pkeys = torch.where(live, key, torch.full_like(key, -1))
            library = cuda_ms(lambda: torch.isin(pkeys, bkeys), 10)
        report.add(f"join_probe@{label}", "cuda", src + "join_probe.cu", err, ms, plain, bound,
                   library)
        log(f"{label}: probe of {n} rows, {int(live.sum())} live keys, "
            f"{int(got[1].sum())} output rows; build {build.page.capacity} rows")
        ex._builds.clear()

    # K8: Q13's left probe of customer against the filtered orders (and
    # the same as a FULL join, with its matched mask), Q5's inner probe
    j13 = next(j for j in find_all(plans["q13"], JoinNode) if j.kind == "left")
    cases = [("join_expand", "q13", j13, True, False),
             ("join_expand@q13_full", "q13", j13, True, True),
             ("join_expand@q5_inner", "q5", joins["q5"], False, False)]
    for name, label, join, left, full in cases:
        ex = exs[label]
        build = ex._materialize_build(join)
        probe = first_split(ex, join.left)
        keys = key_columns(probe, join.left_keys, join.key_domains)
        probe_cols = [(b.data, b.valid) for b in probe.blocks]
        build_cols = [(b.data, b.valid) for b in build.page.blocks]
        cap = build.page.capacity

        def run(fn, matched=None):
            return fn(keys, probe.row_mask, build.sorted_keys, build.perm, build.starts,
                      probe_cols, build_cols, left, False, matched)

        masks = [torch.zeros(cap, dtype=torch.bool, device=probe.device) if full else None
                 for _ in range(2)]
        got, want = run(k8.join_expand, masks[0]), run(k8.join_expand_plain, masks[1])
        if got[2] != want[2]:
            raise AssertionError(f"{name}: totals {got[2]} vs {want[2]}")
        err = same((got[0], got[1]) + ((masks[0],) if full else ()),
                   (want[0], want[1]) + ((masks[1],) if full else ()), name)
        ms = cuda_ms(lambda: run(k8.join_expand, masks[0]), 5)
        plain = cuda_ms(lambda: run(k8.join_expand_plain, masks[1]), 2)
        # bytes: the probe's keys, mask and columns read once, the
        # sectors its lookups touch in starts, in perm and in each build
        # column at the matched rows, every output written once
        n = probe.capacity
        key, ok = pk.pack_plain(keys, n, probe.device)
        live = probe.row_mask & ok
        kk = torch.clamp(key, 0, build.starts.shape[0] - 2)
        in_dom = live & (key >= 0) & (key < build.starts.shape[0] - 1)
        lo = build.starts[kk].to(torch.int64)
        m = torch.where(in_dom, build.starts[kk + 1].to(torch.int64) - lo,
                        torch.zeros_like(lo))
        counts = torch.where(probe.row_mask & (m == 0), torch.ones_like(m), m) if left \
            else torch.where(probe.row_mask, m, torch.zeros_like(m))
        first = torch.cumsum(m, 0) - m
        pos = torch.repeat_interleave(lo, m) + torch.arange(int(m.sum()), device=lo.device) \
            - torch.repeat_interleave(first, m)
        rows = build.perm[pos].to(torch.int64)
        bound = (nbytes(probe.row_mask, *[t for k in keys for t in k[:2]],
                        *[t for c in probe_cols for t in c])
                 + lookup_bytes(build, key, live) + sector_bytes(build.perm, pos)
                 + sum(sector_bytes(t, rows) for c in build_cols for t in c)
                 + nbytes(*[t for c in got[0] + got[1] for t in c]) + (cap if full else 0))
        # the expansion index alone: one repeat_interleave of the counts
        library = cuda_ms(lambda: torch.repeat_interleave(counts), 5)
        report.add(name, "cuda", src + "join_expand.cu", err, ms, plain, bound, library)
        log(f"{name}: {n} probe rows, {int(live.sum())} live keys -> {got[2]} output rows; "
            f"build {cap} rows, {len(build_cols)} columns")
        ex._builds.clear()

    # K9: Q10's seven keys over its first split and over the merge of
    # its partials, Q13's c_count over the 1.5M inner groups
    agg10 = find(plans["q10"], AggregationNode)
    agg13 = find(plans["q13"], AggregationNode)
    ex10, ex13 = exs["q10"], exs["q13"]
    page10 = first_split(ex10, agg10.source)
    parts = concat_pages_device(list(ex10._pages(ex10.partial_node(agg10))))
    page13 = first_split(ex13, agg13.source)
    inputs = [("hash_keys", key_columns(page10, agg10.group_exprs, agg10.key_domains),
               page10.row_mask),
              ("hash_keys@q10_merge", merge_inputs(parts, len(agg10.group_exprs), agg10.aggs,
                                                   agg10.key_domains)[0], parts.row_mask),
              ("hash_keys@q13", key_columns(page13, agg13.group_exprs, agg13.key_domains),
               page13.row_mask)]
    # K1's CANON on Q10's key columns whose dictionary repeats a value
    # (their codes feed K9 above, so K9's rows alone cannot see a wrong
    # code)
    c10 = ExprCompiler.for_page(page10)
    canon = [(e, n) for e, n in zip(agg10.group_exprs, agg10.group_names)
             if c10.lower_key(e) is not None]
    if not canon:
        raise AssertionError("q10: no group key over a dictionary that repeats a value")
    for e, n in canon:
        k1_row(report, f"expr_eval@q10_canon_{n}", e, page10, library=canon_library, key=True)
    for name, keys, mask in inputs:
        if not pk.hashed(keys):
            raise AssertionError(f"{name}: the keys have an exact domain")
        got = pk.hash_keys(keys, mask)
        err = same(got, pk.masked_plain(keys, mask, False)[0], name)
        ms = cuda_ms(lambda: pk.hash_keys(keys, mask), 20)
        plain = cuda_ms(lambda: pk.masked_plain(keys, mask, False), 5)
        report.add(name, "cuda", src + "keys.cu", err, ms, plain,
                   nbytes(mask, *[t for k in keys for t in k[:2]]) + 8 * mask.shape[0])
        log(f"{name}: {len(keys)} keys over {mask.shape[0]} rows, {int(mask.sum())} live")
    for ex in exs.values():
        ex._builds.clear()


def calls_in(e) -> list:
    """Every Call under expression ``e``."""
    from presto_tpu_torch.expr.ir import Call

    out, stack = [], [e]
    while stack:
        x = stack.pop()
        if isinstance(x, Call):
            out.append(x)
            stack.extend(x.args)
    return out


def find_call(plan, test):
    """``(node, expr)``: the first filter predicate, projection or
    aggregate argument under ``plan`` (preorder) holding a call that
    ``test`` accepts."""
    from presto_tpu_torch.planner.plan import AggregationNode, FilterNode, ProjectNode

    for node in find_all(plan, (FilterNode, ProjectNode, AggregationNode)):
        if isinstance(node, FilterNode):
            exprs = [node.predicate]
        elif isinstance(node, ProjectNode):
            exprs = list(node.projections)
        else:
            exprs = [a.arg for a in node.aggs if a.arg is not None]
        for e in exprs:
            if any(test(c) for c in calls_in(e)):
                return node, e
    raise AssertionError("no such call in the plan")


def minmax_library_ms(keys, row_mask, states) -> float:
    """Device ms of one ``scatter_reduce_`` that takes the least of the
    first min/max state's values per group, by a group id computed
    beforehand over its valid live rows."""
    from presto_tpu_torch.kernels import keys as pk

    n = row_mask.shape[0]
    key, _ = pk.pack_plain(keys, n, row_mask.device)
    _, data, valid = states[0]
    ok = row_mask & valid
    _, gid = torch.unique(key[ok], return_inverse=True)
    vals = data[ok].to(torch.int64)
    table = torch.zeros(int(gid.max()) + 1, dtype=torch.int64, device=row_mask.device)
    return cuda_ms(lambda: table.scatter_reduce_(0, gid, vals, "amin"), 10)


def k6_row(report, name, keys, mask, states, presorted=False, library=None,
           counter=None) -> int:
    """K6 against its plain version; returns the group count."""
    from presto_tpu_torch.kernels import sorted_group_agg as k6

    got = k6.sorted_group_agg(keys, mask, states, presorted)
    err = same(got[:2], k6.sorted_group_agg_plain(keys, mask, states, presorted)[:2], name)
    ms = cuda_ms(lambda: k6.sorted_group_agg(keys, mask, states, presorted), 5)
    plain = cuda_ms(lambda: k6.sorted_group_agg_plain(keys, mask, states, presorted), 2)
    in_bytes = nbytes(mask, *[t for k in keys for t in k[:2]],
                      *[t for _, dd, vv in states for t in (dd, vv)])
    report.add(name, "cuda", "presto_tpu_torch/csrc/sorted_group_agg.cu", err, ms, plain,
               in_bytes + nbytes(*[t for o in got[0] for t in o], *got[1]), library, counter)
    return got[2]


def check_aggregation_kernels(report: KernelReport, runners) -> None:
    """Phase 3, the fourth slice: K1's DATEPART, S2D, long comparisons
    and NOTNULL; min/max in K2, K3 and K6; K6's presorted mode; K7 at
    n = 100; each against its plain version at the shapes of Q7, Q11,
    Q15, Q17, Q18 and Q21."""
    from presto_tpu_torch.expr.compile import _lane, LONG
    from presto_tpu_torch.kernels import keys as pk
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.kernels import topn as k7
    from presto_tpu_torch.ops.aggregate import (
        _finalize_kind, kernel_inputs, merge_inputs, sorted_inputs,
    )
    from presto_tpu_torch.ops.sort import topn_keys
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.planner.plan import AggregationNode, TopNNode

    src = "presto_tpu_torch/csrc/"
    plans = {q: runners[q].plan(QUERIES[q]) for q in ("q7", "q11", "q15", "q17", "q18",
                                                      "q21")}
    exs = {q: runners[q].executor for q in plans}

    def long_cmp(c):
        return c.fn in ("eq", "ne", "lt", "le", "gt", "ge") and not c.args[0].type.is_string \
            and LONG in (_lane(c.args[0].type), _lane(c.args[1].type))

    # K1: each new opcode at the place its query runs it
    cases = [("q7", "year", lambda c: c.fn == "year"),
             ("q17", "s2d", lambda c: c.fn == "div" and c.type.name == "double"),
             ("q11", "lcmp", long_cmp), ("q15", "lcmp", long_cmp),
             ("q21", "not_null", lambda c: c.fn == "not_null")]
    for label, op, test in cases:
        node, e = find_call(plans[label], test)
        ex = exs[label]
        page = first_split(ex, node.source)
        name = f"expr_eval@{label}_{op}"
        k1_row(report, name, e, page, filt=type(node).__name__ == "FilterNode",
               counter=f"expr_eval:{op}")
        log(f"{name}: {type(node).__name__} over {page.capacity} rows, "
            f"{int(page.row_mask.sum())} live")
        ex._builds.clear()

    # K6's min/max: Q21's grouping of all lineitem by l_orderkey, over
    # its first split and over the merge of every split's partials
    ex = exs["q21"]
    agg21 = next(a for a in find_all(plans["q21"], AggregationNode)
                 if {c.fn for c in a.aggs} == {"min", "max"})
    page = first_split(ex, agg21.source)
    keys, states, _ = sorted_inputs(page, agg21.group_exprs, agg21.aggs, agg21.key_domains)
    groups = k6_row(report, "sorted_group_agg@q21_minmax", keys, page.row_mask, states,
                    library=minmax_library_ms(keys, page.row_mask, states),
                    counter="sorted_group_agg:minmax")
    log(f"q21 min/max partial of split 0: {page.capacity} rows, {groups} groups")
    parts = concat_pages_device(list(ex._pages(ex.partial_node(agg21))))
    keys, states, _ = merge_inputs(parts, len(agg21.group_exprs), agg21.aggs,
                                   agg21.key_domains)
    groups = k6_row(report, "sorted_group_agg@q21_minmax_merge", keys, parts.row_mask,
                    states, library=minmax_library_ms(keys, parts.row_mask, states),
                    counter="sorted_group_agg:minmax")
    log(f"q21 min/max merge: {parts.capacity} partial rows, {groups} groups")
    ex._builds.clear()

    # K6's presorted mode: Q18's grouping of lineitem by l_orderkey over
    # its first split; beside it, torch.unique_consecutive of the live
    # rows' packed keys (the run ids alone)
    ex = exs["q18"]
    agg18 = next(a for a in find_all(plans["q18"], AggregationNode) if a.presorted)
    page = first_split(ex, agg18.source)
    keys, states, _ = sorted_inputs(page, agg18.group_exprs, agg18.aggs, agg18.key_domains)
    live_keys = pk.pack_plain(keys, page.capacity, page.device)[0][page.row_mask]
    library = cuda_ms(lambda: torch.unique_consecutive(live_keys, return_inverse=True), 10)
    groups = k6_row(report, "sorted_group_agg@q18_presorted", keys, page.row_mask, states,
                    presorted=True, library=library, counter="sorted_group_agg:presorted")
    log(f"q18 presorted partial of split 0: {page.capacity} rows, {groups} groups")

    # K7 at n = 100: Q18's top 100 over its grouped rows
    outer = find(plans["q18"], TopNNode)
    groups_page = ex._run_aggregation(outer.source)
    keys = topn_keys(groups_page, outer.sort_exprs, outer.ascending, outer.nulls_first)
    got = k7.topn(keys, groups_page.row_mask, outer.count)
    err = same(got, k7.topn_plain(keys, groups_page.row_mask, outer.count), "topn n=100")
    ms = cuda_ms(lambda: k7.topn(keys, groups_page.row_mask, outer.count), 20)
    plain = cuda_ms(lambda: k7.topn_plain(keys, groups_page.row_mask, outer.count), 5)
    report.add("topn@q18_n100", "cuda", src + "topn.cu", err, ms, plain,
               nbytes(groups_page.row_mask, *[t for k in keys for t in k[:2]])
               + 4 * outer.count + 4, counter="topn:n>32")
    log(f"q18 top {outer.count} of {groups_page.capacity} rows "
        f"({int(groups_page.row_mask.sum())} live)")
    ex._builds.clear()

    # K2's long max and K3's fold and finalize of it: Q15's global max
    # over the revenue of every supplier (the page halved for the fold)
    ex = exs["q15"]
    agg15 = next(a for a in find_all(plans["q15"], AggregationNode) if not a.group_exprs)
    page = first_split(ex, agg15.source)
    n = page.capacity
    _, args = kernel_inputs(page, [], agg15.aggs, None)
    got = k2.packed_group_agg(n, page.row_mask, [], args, 1)
    err = same(got, k2.packed_group_agg_plain(n, page.row_mask, [], args, 1),
               "packed_group_agg q15 max")
    ms = cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, [], args, 1), 20)
    plain = cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, [], args, 1), 5)
    report.add("packed_group_agg@q15_long_max", "cuda", src + "packed_group_agg.cu", err, ms,
               plain, nbytes(page.row_mask, *[t for a in args for t in a[1:]])
               + nbytes(*[t for st in got[0] for t in st], got[1]),
               counter="packed_group_agg:minmax")
    log(f"q15 global max over {n} rows ({int(page.row_mask.sum())} live)")
    half = torch.arange(n, device=page.device) < n // 2
    sides = [k2.packed_group_agg(n, page.row_mask & h, [], args, 1) for h in (half, ~half)]
    kinds = [k3.COL_MAX_D128, k3.COL_I64]
    ca, cb = ([(k, t, sd[1]) for k, t in zip(kinds, sd[0][0])] for sd in sides)
    fold = k3.packed_fold(ca, cb, sides[0][1], sides[1][1])
    err = same(fold, k3.packed_fold_plain(ca, cb, sides[0][1], sides[1][1]),
               "packed_fold_finalize q15 max fold")
    ms = cuda_ms(lambda: k3.packed_fold(ca, cb, sides[0][1], sides[1][1]), 100)
    plain = cuda_ms(lambda: k3.packed_fold_plain(ca, cb, sides[0][1], sides[1][1]), 20)
    report.add("packed_fold_finalize@q15_max_fold", "cuda", src + "packed_fold_finalize.cu",
               err, ms, plain, nbytes(*[t for c in ca + cb for t in c[1:]],
                                      *[t for o in fold[0] for t in o], fold[1]))
    items = [(_finalize_kind(agg15.aggs[0]), got[0][0][0], got[0][0][1])]
    err = same(k3.packed_finalize(items, got[1]), k3.packed_finalize_plain(items, got[1]),
               "packed_fold_finalize q15 max finalize")
    ms = cuda_ms(lambda: k3.packed_finalize(items, got[1]), 100)
    plain = cuda_ms(lambda: k3.packed_finalize_plain(items, got[1]), 20)
    report.add("packed_fold_finalize@q15_max_finalize", "cuda",
               src + "packed_fold_finalize.cu", err, ms, plain,
               nbytes(got[0][0][0], got[0][0][1], got[1]) + 2 * 16 + 1)
    ex._builds.clear()


def same_bits(a, b, what: str) -> int:
    """:func:`same` with doubles compared by their bits (NaN and -0.0
    included)."""
    def bits(x):
        if isinstance(x, torch.Tensor):
            return x.view(torch.int64) if x.dtype == torch.float64 else x
        return [bits(y) for y in x]

    return same(bits(a), bits(b), what)


def k10_row(report: KernelReport, name: str, inputs) -> None:
    """K10 against its plain version on ``inputs`` (``window_inputs``:
    the permutation, row mask, partition key, order keys, functions and
    arguments); bound: each input read once, each output written once."""
    from presto_tpu_torch.kernels import window_eval as k10

    got = k10.window_eval(*inputs)
    err = same_bits(got, k10.window_eval_plain(*inputs), name)
    ms = cuda_ms(lambda: k10.window_eval(*inputs), 5)
    plain = cuda_ms(lambda: k10.window_eval_plain(*inputs), 2)
    perm, mask, pkey, order, funcs, args = inputs
    in_bytes = nbytes(perm, mask, pkey, *[t for c in order for t in c],
                      *[t for a in args if a is not None for t in a])
    report.add(name, "cuda", "presto_tpu_torch/csrc/window_eval.cu", err, ms, plain,
               in_bytes + nbytes(*[t for o in got for t in o]))
    log(f"{name}: {perm.shape[0]} rows, {int(mask.sum())} live, "
        f"{len(funcs)} functions ({', '.join(k10.KIND_NAMES[f.kind] for f in funcs)})")


def source_page(ex, node):
    """The page a breaker's source gives (its pages concatenated)."""
    from presto_tpu_torch.page import concat_pages_device

    try:
        return concat_pages_device(list(ex._pages(node)))
    finally:
        ex._builds.clear()


def check_window_kernels(report: KernelReport, ds_runners, ds_mem) -> None:
    """Phase 3, the fifth slice: K10 over one whole store_sales split
    (partition by ss_item_sk, order by ss_net_profit: rank, row_number,
    and a ROWS-frame sum and avg) and over the real window input of each
    windowed query; K1's double opcodes where each query runs them; K7's
    double key (q89's top 100); K3's double avg (q7's finalize)."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import ColumnRef
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import topn as k7
    from presto_tpu_torch.ops.aggregate import _finalize_kind, _slice_state_cols, merge_aggregate
    from presto_tpu_torch.ops.sort import topn_keys
    from presto_tpu_torch.ops.window import WindowFunc, window_inputs
    from presto_tpu_torch.planner.plan import (
        AggregationNode, FilterNode, ProjectNode, TopNNode, WindowNode,
    )

    page = ds_mem.page_for_split("store_sales", 0)
    names = [c for c, _ in ds_mem.schema("store_sales")]
    types = dict(ds_mem.schema("store_sales"))
    item, profit = (ColumnRef(type=types[c], index=names.index(c))
                    for c in ("ss_item_sk", "ss_net_profit"))
    rows = ("rows", -2, 0)
    funcs = [WindowFunc("rank"), WindowFunc("row_number"),
             WindowFunc("sum", profit, frame=rows), WindowFunc("avg", profit, frame=rows)]
    k10_row(report, "window_eval", window_inputs(
        page, [item], [profit], [True], funcs,
        [ds_mem.column_domain("store_sales", "ss_item_sk")]))
    for label in DS_WINDOWED:
        ex = ds_runners[label].executor
        plan = ds_runners[label].plan(DS_QUERIES[label])
        seen = []  # a CTE read twice repeats its window nodes: each spec once
        for node in find_all(plan, WindowNode):
            spec = (repr(node.partition_exprs), repr(node.order_exprs), repr(node.funcs),
                    repr(node.source))
            if spec in seen:
                continue
            seen.append(spec)
            src = source_page(ex, node.source)
            j = len(seen) - 1
            k10_row(report, f"window_eval@{label}" + (f"_{j}" if j else ""), window_inputs(
                src, list(node.partition_exprs), list(node.order_exprs), list(node.ascending),
                list(node.funcs), node.partition_domains))

    # K1: the first filter or projection of each query that runs a
    # double opcode, over the page its node sees
    for label in DS_QUERIES:
        ex = ds_runners[label].executor
        plan = ds_runners[label].plan(DS_QUERIES[label])
        for node in find_all(plan, (FilterNode, ProjectNode)):
            exprs = [node.predicate] if isinstance(node, FilterNode) else list(node.projections)
            exprs = [e for e in exprs if any(
                x.type.name == "double" for c in calls_in(e) for x in (c,) + tuple(c.args))]
            hit = None
            if exprs:
                page = first_split(ex, node.source)
                ex._builds.clear()
                for e in exprs:
                    prog, _ = ExprCompiler.for_page(page).lower(e)
                    if k1.DOUBLE_OPS & set(prog.ops):
                        hit = (e, page)
                        break
            if hit is not None:
                k1_row(report, f"expr_eval@{label}_double", hit[0], hit[1],
                       filt=isinstance(node, FilterNode), counter="expr_eval:double")
                break

    # K7 over q89's double key: its top 100 of every grouped row
    label = "ds_q89"
    ex = ds_runners[label].executor
    top = find_all(ds_runners[label].plan(DS_QUERIES[label]), TopNNode)[0]
    page = source_page(ex, top.source)
    keys = topn_keys(page, top.sort_exprs, top.ascending, top.nulls_first)
    if not any(d.dtype == torch.float64 for d, _, _, _ in keys):
        raise AssertionError(f"{label}: its top-n has no double key")
    n = top.count
    err = same(k7.topn(keys, page.row_mask, n), k7.topn_plain(keys, page.row_mask, n),
               f"topn {label}")
    ms = cuda_ms(lambda: k7.topn(keys, page.row_mask, n), 20)
    plain = cuda_ms(lambda: k7.topn_plain(keys, page.row_mask, n), 5)
    report.add(f"topn@{label}_double", "cuda", "presto_tpu_torch/csrc/topn.cu", err, ms, plain,
               nbytes(page.row_mask, *[t for d, v, _, _ in keys for t in (d, v)]) + 4 * n + 4,
               counter="topn:double")
    log(f"{label} top {n} of {page.capacity} rows ({int(page.row_mask.sum())} live)")

    # K3: q7's finalize of its merged states (avg of an integer -> double)
    label = "ds_q7"
    ex = ds_runners[label].executor
    agg = [a for a in find_all(ds_runners[label].plan(DS_QUERIES[label]), AggregationNode)
           if a.step == "single"][0]
    cat = source_page(ex, ex.partial_node(agg))
    nk = len(agg.group_exprs)
    merged = merge_aggregate(cat, nk, list(agg.aggs), agg.max_groups,
                             key_domains=agg.key_domains, mode="partial")
    items = [(_finalize_kind(a), cols[0].data, cols[-1].data)
             for a, cols in zip(agg.aggs, _slice_state_cols(merged, nk, agg.aggs))]
    if not any(k == k3.FIN_AVG_DOUBLE for k, _, _ in items):
        raise AssertionError(f"{label}: no avg finalizes to a double")
    got = k3.packed_finalize(items, merged.row_mask)
    err = same_bits(got, k3.packed_finalize_plain(items, merged.row_mask), f"finalize {label}")
    ms = cuda_ms(lambda: k3.packed_finalize(items, merged.row_mask), 50)
    plain = cuda_ms(lambda: k3.packed_finalize_plain(items, merged.row_mask), 10)
    report.add(f"packed_fold_finalize@{label}_avg_double", "cuda",
               "presto_tpu_torch/csrc/packed_fold_finalize.cu", err, ms, plain,
               nbytes(merged.row_mask, *[t for _, a, b in items for t in (a, b)],
                      *[t for o in got for t in o]), counter="packed_fold_finalize:avg_double")
    log(f"{label} finalize: {merged.capacity} groups")


def fold_row(report, name, ca, cb, ma, mb, counter) -> list:
    """K3's fold of two packed state tables against its plain version;
    returns the folded columns and mask."""
    from presto_tpu_torch.kernels import packed_fold_finalize as k3

    got = k3.packed_fold(ca, cb, ma, mb)
    err = same_bits(got, k3.packed_fold_plain(ca, cb, ma, mb), name)
    ms = cuda_ms(lambda: k3.packed_fold(ca, cb, ma, mb), 50)
    plain = cuda_ms(lambda: k3.packed_fold_plain(ca, cb, ma, mb), 10)
    report.add(name, "cuda", "presto_tpu_torch/csrc/packed_fold_finalize.cu", err, ms, plain,
               nbytes(*[t for c in ca + cb for t in c[1:]], ma, mb,
                      *[t for o in got[0] for t in o], got[1]), counter=counter)
    return got


def finalize_row(report, name, items, mask, counter) -> None:
    """K3's finalize of ``items`` against its plain version."""
    from presto_tpu_torch.kernels import packed_fold_finalize as k3

    got = k3.packed_finalize(items, mask)
    err = same_bits(got, k3.packed_finalize_plain(items, mask), name)
    ms = cuda_ms(lambda: k3.packed_finalize(items, mask), 50)
    plain = cuda_ms(lambda: k3.packed_finalize_plain(items, mask), 10)
    report.add(name, "cuda", "presto_tpu_torch/csrc/packed_fold_finalize.cu", err, ms, plain,
               nbytes(mask, *[t for _, a, b in items for t in (a, b)],
                      *[t for o in got for t in o]), counter=counter)


def state_tensors(states) -> list:
    """Every tensor of K6 states (a variance merge's data is a tuple)."""
    out = []
    for _, data, valid in states:
        out += list(data) if isinstance(data, tuple) else [data]
        out.append(valid)
    return out


def k6_bits_row(report, name, keys, mask, states, counter, library=None) -> int:
    """:func:`k6_row` with doubles compared by their bits."""
    from presto_tpu_torch.kernels import sorted_group_agg as k6

    got = k6.sorted_group_agg(keys, mask, states)
    err = same_bits(got[:2], k6.sorted_group_agg_plain(keys, mask, states)[:2], name)
    ms = cuda_ms(lambda: k6.sorted_group_agg(keys, mask, states), 5)
    plain = cuda_ms(lambda: k6.sorted_group_agg_plain(keys, mask, states), 2)
    in_bytes = nbytes(mask, *[t for k in keys for t in k[:2]], *state_tensors(states))
    report.add(name, "cuda", "presto_tpu_torch/csrc/sorted_group_agg.cu", err, ms, plain,
               in_bytes + nbytes(*[t for o in got[0] for t in o], *got[1]), library, counter)
    return got[2]


def check_sixth_slice_kernels(report: KernelReport, ds2_runners, ds_mem) -> None:
    """Phase 3, the sixth slice, each against its plain version, doubles
    by their bits: K1's coalesce, floor, round, cast_decimal (over a
    whole store_sales split), its string-CASE remap (q36), string-column
    comparison (q68), coalesce (q40) and long subtraction (q75) over the
    real inputs of those queries; K6's variance partial over a whole
    store_sales split grouped by ss_item_sk, its merge of two splits'
    partials and its double sum; K2's variance over one slot (the global
    aggregate), K3's Chan fold of two splits' global tables and its
    variance finalize; K3's sum0 and collapsed-sum finalizes of
    q28's partial states; K9 over a double key."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import AggCall, Call, ColumnRef, Literal
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import keys as pk
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.ops.aggregate import (
        _finalize_kind, _slice_state_cols, grouped_aggregate, kernel_inputs, merge_inputs,
        sorted_inputs,
    )
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.planner.plan import AggregationNode, WindowNode
    from presto_tpu_torch.types import DOUBLE, parse_type

    pages = [ds_mem.page_for_split("store_sales", i) for i in (0, 1)]
    names = [c for c, _ in ds_mem.schema("store_sales")]
    types = dict(ds_mem.schema("store_sales"))

    def col(c):
        return ColumnRef(type=types[c], index=names.index(c))

    def call(fn, t, *args):
        return Call(type=parse_type(t) if isinstance(t, str) else t, fn=fn, args=tuple(args))

    # K1 over a whole split
    page = pages[0]
    whole = {
        "coalesce": (call("coalesce", types["ss_ext_discount_amt"], col("ss_ext_discount_amt"),
                          col("ss_ext_sales_price")),
                     lambda prog, ins: cuda_ms(lambda: torch.where(ins[0][1], ins[0][0],
                                                                   ins[1][0]), 20)),
        "floor": (call("floor", "decimal(7,0)", col("ss_sales_price")),
                  lambda prog, ins: cuda_ms(lambda: torch.div(ins[0][0], 100,
                                                              rounding_mode="floor"), 20)),
        "round": (call("round", types["ss_net_paid"], col("ss_net_paid"),
                       Literal(type=parse_type("integer"), value=1)), None),
        "cast_decimal": (call("cast_decimal", "decimal(12,2)",
                              call("div", DOUBLE, call("cast_double", DOUBLE,
                                                       col("ss_net_profit")),
                                   Literal(type=DOUBLE, value=3.0))), None),
    }
    for label, (expr, library) in whole.items():
        k1_row(report, f"expr_eval@{label}", expr, page, library=library,
               counter=f"expr_eval:{label}")
    # K1 where the slice's queries run their string and long opcodes
    real = {"string_eq": ("ds_q68", lambda c: c.fn in ("eq", "ne") and all(
                a.type.is_string and not isinstance(a, Literal) for a in c.args)),
            "coalesce_q40": ("ds_q40", lambda c: c.fn == "coalesce"),
            "ladd": ("ds_q75", lambda c: c.fn in ("add", "sub") and c.type.is_long_decimal)}
    for label, (q, test) in real.items():
        ex = ds2_runners[q].executor
        node, expr = find_call(ds2_runners[q].plan(DS2_QUERIES[q]), test)
        src = first_split(ex, node.source)
        ex._builds.clear()
        k1_row(report, f"expr_eval@{label}", expr, src,
               filt=type(node).__name__ == "FilterNode",
               counter="expr_eval:" + label.split("_q")[0])
    # q36's string CASE partitions its window: K1 over the window's input
    label = "ds_q36"
    ex = ds2_runners[label].executor
    win = find_all(ds2_runners[label].plan(DS2_QUERIES[label]), WindowNode)[0]
    expr = [e for e in win.partition_exprs
            if any(c.fn == "case" and c.type.is_string for c in calls_in(e))][0]
    k1_row(report, "expr_eval@remap", expr, source_page(ex, win.source),
           library=remap_library, counter="expr_eval:remap")

    # K6: the variance partial of ss_quantity by ss_item_sk over a whole
    # split, the merge of two splits' partials, a double sum
    item, qty = col("ss_item_sk"), col("ss_quantity")
    dom = [ds_mem.column_domain("store_sales", "ss_item_sk")]
    stddev = AggCall(fn="stddev_samp", arg=qty, type=DOUBLE)
    keys, states, _ = sorted_inputs(page, [item], [stddev], dom)
    groups = k6_bits_row(report, "sorted_group_agg@variance", keys, page.row_mask, states,
                         "sorted_group_agg:variance")
    log(f"K6 variance: {groups} groups of {page.capacity} rows")
    parts = [grouped_aggregate(p, [item], [stddev], 1 << 20, key_domains=[None],
                               mode="partial") for p in pages]
    cat = concat_pages_device(parts)
    keys, states, _ = merge_inputs(cat, 1, [stddev], [None])
    k6_bits_row(report, "sorted_group_agg@variance_merge", keys, cat.row_mask, states,
                "sorted_group_agg:variance_merge")
    total = AggCall(fn="sum", arg=call("cast_double", DOUBLE, col("ss_net_paid")), type=DOUBLE)
    keys, states, _ = sorted_inputs(page, [item], [total], dom)
    k6_bits_row(report, "sorted_group_agg@double_sum", keys, page.row_mask, states,
                "sorted_group_agg:double_sum",
                library=group_sum_library_ms(keys, page.row_mask, states))

    # K2's variance over one slot (the global aggregate: a keyed double
    # state takes K6); K3's Chan fold of two splits' global tables and
    # the variance finalize
    aggs = [stddev, AggCall(fn="var_pop", arg=col("ss_net_paid"), type=DOUBLE)]
    ks, args = kernel_inputs(page, [], aggs, None)
    n = page.capacity
    got = k2.packed_group_agg(n, page.row_mask, ks, args, 1)
    err = same_bits(got, k2.packed_group_agg_plain(n, page.row_mask, ks, args, 1),
                    "packed_group_agg variance_global")
    ms = cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, ks, args, 1), 10)
    plain = cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, ks, args, 1), 2)
    # one PyTorch call: the sample variance and mean of the valid rows
    x = args[0][1][args[0][2] & page.row_mask]
    library = cuda_ms(lambda: torch.var_mean(x), 10)
    report.add("packed_group_agg@variance_global", "cuda",
               "presto_tpu_torch/csrc/packed_group_agg.cu", err, ms, plain,
               nbytes(page.row_mask, *[t for a in args for t in a[1:]])
               + nbytes(*[t for st in got[0] for t in st], got[1]), library,
               "packed_group_agg:variance")
    parts = [grouped_aggregate(p, [], aggs, 1, mode="partial") for p in pages]
    kinds = [k3.COL_F64, k3.COL_VAR_M2, k3.COL_I64] * 2

    def cols_of(part):
        return [(k, b.data, b.valid) for k, b in zip(
            kinds, [b for c in _slice_state_cols(part, 0, aggs) for b in c])]

    fold, mask = fold_row(report, "packed_fold_finalize@chan", cols_of(parts[0]),
                          cols_of(parts[1]), parts[0].row_mask, parts[1].row_mask,
                          "packed_fold_finalize:chan")
    items = [(_finalize_kind(a), fold[3 * i + 1][0], fold[3 * i + 2][0])
             for i, a in enumerate(aggs)]
    finalize_row(report, "packed_fold_finalize@variance", items, mask,
                 "packed_fold_finalize:variance")

    # K3: q28's sum0 and collapsed sums over its partial states
    label = "ds_q28"
    ex = ds2_runners[label].executor
    agg = [a for a in find_all(ds2_runners[label].plan(DS2_QUERIES[label]), AggregationNode)
           if a.step == "single" and any(x.fn == "sum0" for x in a.aggs)][0]
    cat = source_page(ex, ex.partial_node(agg))
    nk = len(agg.group_exprs)
    items = [(_finalize_kind(a), cols[0].data, cols[-1].data)
             for a, cols in zip(agg.aggs, _slice_state_cols(cat, nk, agg.aggs))]
    kinds = {k for k, _, _ in items}
    if not kinds & {k3.FIN_SUM0, k3.FIN_SUM0_D128, k3.FIN_SUM0_COLLAPSE} or not kinds & {
            k3.FIN_SUM_COLLAPSE, k3.FIN_SUM0_COLLAPSE}:
        raise AssertionError(f"{label}: no sum0 or collapsed sum to finalize")
    finalize_row(report, "packed_fold_finalize@sum0", items, cat.row_mask,
                 "packed_fold_finalize:sum0")
    log(f"{label} finalize: {cat.capacity} partial rows, kinds {sorted(kinds)}")

    # K9 over a double key (q49 and q54 group by one)
    prog, cols = ExprCompiler.for_page(page).lower(call("cast_double", DOUBLE,
                                                        col("ss_sales_price")))
    dbl = k1.expr_eval(prog, [(page.blocks[i].data, page.blocks[i].valid) for i in cols],
                       page.capacity)
    hkeys = [(dbl[0], dbl[1], 0, 0), (page.blocks[names.index("ss_store_sk")].data,
                                      page.blocks[names.index("ss_store_sk")].valid, 0, 0)]
    err = same(pk.hash_keys(hkeys, page.row_mask), pk.masked_plain(hkeys, page.row_mask,
                                                                   False)[0], "hash_keys double")
    ms = cuda_ms(lambda: pk.hash_keys(hkeys, page.row_mask), 20)
    plain = cuda_ms(lambda: pk.masked_plain(hkeys, page.row_mask, False), 5)
    report.add("hash_keys@double", "cuda", "presto_tpu_torch/csrc/keys.cu", err, ms, plain,
               nbytes(page.row_mask, *[t for k in hkeys for t in k[:2]]) + 8 * page.capacity,
               counter="hash_keys:double")


def check_spill_kernels(report: KernelReport, mem, ds_mem) -> None:
    """Phase 3, the seventh slice, each exactly against its plain
    version: K11 over a whole lineitem split keyed by l_orderkey (packed
    over its domain) and over a whole store_sales split keyed by
    (ss_customer_sk, ss_item_sk) (hashed), at 8 and 64 buckets: bucket
    ids, permutation and counts; its gather of the spill phase's
    aggregation columns; the copy of the gathered buffer to pinned host
    memory and back (ms, GB/s); K4's null_flags over the store_sales
    split's two key valids."""
    from presto_tpu_torch.exec.spill import HostPage
    from presto_tpu_torch.kernels import join_build as k4
    from presto_tpu_torch.kernels import spill_partition as k11

    li = mem.page_for_split("lineitem", 0)
    li_names = [c for c, _ in mem.schema("lineitem")]
    okey = li.blocks[li_names.index("l_orderkey")]
    lo, hi = mem.column_domain("lineitem", "l_orderkey")
    ss = ds_mem.page_for_split("store_sales", 0)
    ss_names = [c for c, _ in ds_mem.schema("store_sales")]
    cust, item = (ss.blocks[ss_names.index(c)] for c in ("ss_customer_sk", "ss_item_sk"))
    cases = {"lineitem": ([(okey.data, okey.valid, lo, hi - lo + 2)], li),
             "store_sales": ([(cust.data, cust.valid, 0, 0), (item.data, item.valid, 0, 0)],
                             ss)}
    for label, (keys, page) in cases.items():
        mask = page.row_mask
        for num in (8, 64):
            got = k11.spill_partition(keys, mask, num)
            want = k11.spill_partition_plain(keys, mask, num)
            total = int(want[2].sum())
            err = max(same(got[0], want[0], f"spill_partition {label} bucket ids"),
                      same(got[1][:total], want[1][:total], f"spill_partition {label} perm"),
                      same(got[2], want[2], f"spill_partition {label} counts"))
            ms = cuda_ms(lambda: k11.spill_partition(keys, mask, num), 20)
            plain = cuda_ms(lambda: k11.spill_partition_plain(keys, mask, num), 3)
            bids = got[0]
            # one PyTorch call each for the grouping and the counts: a
            # stable sort of the bucket ids (dead rows, -1, sort first)
            library = cuda_ms(lambda: (torch.sort(bids, stable=True),
                                       torch.bincount(bids + 1, minlength=num + 1)), 20)
            name = "spill_partition" if (label, num) == ("lineitem", 8) else \
                f"spill_partition@{label}_k{num}"
            report.add(name, "cuda", "presto_tpu_torch/csrc/spill_partition.cu", err, ms,
                       plain, nbytes(mask, *[t for k in keys for t in k[:2]], got[0], got[2])
                       + 4 * total, library, "spill_partition")
            log(f"spill_partition {label} k={num}: {total} live rows of {mask.shape[0]}, "
                f"largest bucket {int(want[2].max())}")

    # the gather of the spill phase's aggregation columns through the
    # lineitem partition, and the copies of the gathered buffer
    keys, page = cases["lineitem"]
    _, perm, counts = k11.spill_partition(keys, page.row_mask, 8)  # the runners' default
    total = int(counts.sum())
    cols = [(page.blocks[li_names.index(c)].data, page.blocks[li_names.index(c)].valid)
            for c in ("l_orderkey", "l_quantity", "l_extendedprice")]
    buf = k11.gather_columns(cols, perm, total)
    err = same(buf, k11.gather_columns_plain(cols, perm, total), "spill_partition gather")
    ms = cuda_ms(lambda: k11.gather_columns(cols, perm, total), 20)
    plain = cuda_ms(lambda: k11.gather_columns_plain(cols, perm, total), 3)
    gather_bytes = buf.numel() + 4 * total + sum(
        sector_bytes(t, perm[:total].to(torch.int64)) for c in cols for t in c)
    report.add("spill_partition@gather", "cuda", "presto_tpu_torch/csrc/spill_partition.cu",
               err, ms, plain, gather_bytes, None, "spill_partition:gather")
    host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=buf.is_cuda)
    d2h = cuda_ms(lambda: host.copy_(buf, non_blocking=True), 10)
    hp = HostPage([(host[:8 * total].view(torch.int64), host[8 * total:9 * total]
                    .view(torch.bool), None, None)], torch.ones(total, dtype=torch.bool))
    h2d = cuda_ms(lambda: hp.rehydrate(buf.device), 10)
    log(f"spill copies ({total} rows): device to pinned host {buf.numel()} B in {d2h:.4f} ms "
        f"({buf.numel() / d2h / 1e6:.2f} GB/s); rehydrate of one column "
        f"{9 * total} B in {h2d:.4f} ms ({9 * total / h2d / 1e6:.2f} GB/s)")

    # K4's null_flags over the store_sales split's key valids
    valids = [cust.valid, item.valid]
    mask = ss.row_mask
    got = k4.null_flags(valids, mask)
    err = same(got, k4.null_flags_plain(valids, mask), "null_flags")
    ms = cuda_ms(lambda: k4.null_flags(valids, mask), 20)
    plain = cuda_ms(lambda: k4.null_flags_plain(valids, mask), 5)
    bad = mask & ~(cust.valid & item.valid)
    library = cuda_ms(lambda: torch.any(bad), 20)
    report.add("join_build@null_flags", "cuda", "presto_tpu_torch/csrc/join_build.cu", err, ms,
               plain, nbytes(mask, *valids) + 8, library, "join_build:null_flags")
    log(f"null_flags store_sales split: {got.tolist()}")


def peek_pool(limit: int):
    """A memory pool that also remembers the size of every reservation,
    by tag (``.peek``)."""
    from presto_tpu_torch.memory import MemoryPool

    class PeekPool(MemoryPool):
        def reserve(self, tag, nbytes, enforce=True):
            self.peek[tag] = nbytes
            super().reserve(tag, nbytes, enforce=enforce)

    pool = PeekPool(limit)
    pool.peek = {}
    return pool


def canonical_rows(page) -> list:
    """The live rows of a device page as int64 columns (each value's
    bits, 0 where NULL, then its valid bit), sorted by every column: a
    multiset of rows to compare exactly on the device."""
    live = page.row_mask.nonzero().flatten()
    cols = []
    for b in page.blocks:
        d, v = b.data[live], b.valid[live]
        if d.dtype == torch.float64:
            d = d.view(torch.int64)
        for x in (d.unbind(1) if d.dim() == 2 else (d,)):
            cols.append(torch.where(v, x.to(torch.int64), 0))
        cols.append(v.to(torch.int64))
    order = torch.arange(live.numel(), device=page.device)
    for c in reversed(cols):
        order = order[torch.sort(c[order], stable=True)[1]]
    return [c[order] for c in cols]


def run_spill_phase(mem, launches, spill_wall) -> None:
    """The spill phase at SF10: each of SPILL_QUERIES over the TPC-H
    tables on the card, twice unconstrained under a pool that records
    every reservation, then twice under a pool at SPILL_FRACTION of its
    largest reservation at a spill site (the first of those runs
    counted); the run fails unless K11 launched, bytes were spilled,
    and the spilled rows equal the unconstrained run's exactly (rows
    compared as sorted multisets on the card)."""
    from presto_tpu_torch.runner import QueryRunner

    cat0 = QueryRunner(query_catalog(mem, SQL[18]), device="cuda", memory_pool=False)
    for label, sql in SPILL_QUERIES.items():
        ordered = streamed_tables(cat0.plan(sql)) if label == "spill_q18" else ()
        catalog = query_catalog(mem, sql, ordered)
        peek = peek_pool(1 << 62)
        free = QueryRunner(catalog, device="cuda", memory_pool=peek)
        plan = free.plan(sql)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = free.executor.run_to_page(plan)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        want_rows = canonical_rows(want)
        del want
        site, site_bytes = max(((t, n) for t, n in peek.peek.items()
                                if any(s in t for s in SPILL_SITES[label])), key=lambda e: e[1])
        pool = peek_pool(int(SPILL_FRACTION * site_bytes))
        spilled = QueryRunner(catalog, device="cuda", memory_pool=pool)
        plan = spilled.plan(sql)
        spill_walls = []
        for i in range(2):
            torch.cuda.synchronize()
            if i == 0:
                reset_counts()
            t0 = time.perf_counter()
            got = spilled.executor.run_to_page(plan)
            torch.cuda.synchronize()
            spill_walls.append(time.perf_counter() - t0)
            if i == 0:
                launches[label] = read_counts()
                spill = spilled.executor.last_spill
        got_rows = canonical_rows(got)
        del got
        if launches[label]["spill_partition"] == 0 or spill.bytes == 0:
            raise AssertionError(f"{label}: nothing spilled ({launches[label]}, {spill})")
        if len(got_rows) != len(want_rows) or not all(
                torch.equal(a, b) for a, b in zip(got_rows, want_rows)):
            raise AssertionError(f"{label}: spilled rows differ from the unconstrained run's")
        spill_wall[label] = (walls, spill_walls)
        parts = sorted({t.split("/", 1)[1].split("@")[0] for t in pool.peek
                        if "partition" in t})
        log(f"{label}: {want_rows[0].numel()} rows equal unspilled; wall "
            f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms unconstrained (pool peak "
            f"{peek.peak / 2**30:.3f} GiB; largest spill site {site.split('/', 1)[1]} "
            f"{site_bytes / 2**30:.3f} GiB), {', '.join(f'{w * 1e3:.2f}' for w in spill_walls)}"
            f" ms spilled under a {pool.limit / 2**30:.3f} GiB pool (peak "
            f"{pool.peak / 2**30:.3f} GiB); spilled {spill.bytes / 2**30:.3f} GiB in "
            f"{spill.buckets} host buckets; K11 launches {launches[label]['spill_partition']}, "
            f"gathers {launches[label]['spill_partition:gather']}; partitioned sites {parts}; "
            f"demoted joins {len(spilled.executor._force_expanding)}")
        del want_rows, got_rows, free, spilled, peek, pool
        gc.collect()


def ulp_gap(got, want) -> int:
    """The largest distance in units in the last place between two
    double tensors (NaN against NaN: 0)."""
    from presto_tpu_torch.kernels.expr_eval import double_key

    if got.numel() == 0:
        return 0
    gap = (double_key(got) - double_key(want)).abs()
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(torch.where(both_nan, torch.zeros_like(gap), gap).max())


def check_function_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the eighth slice, over whole 2^23-row lineitem splits:
    each new K1 opcode family against its twin (exact, or within 2 ulp
    for a transcendental, the gap printed), K2's new states (double,
    boolean and varchar-rank min/max, bool counts, bitwise folds by
    l_shipmode; HLL's sum in the global slot), K6's (double min/max and
    bitwise folds by l_partkey, HLL's sum by bucket) and K3's fold and
    finalize of them (the HLL estimate), doubles by their bits."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import Call, ColumnRef, Literal
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.ops.aggregate import rank_luts
    from presto_tpu_torch.page import Block, Page
    from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, parse_type

    names = [c for c, _ in mem.schema("lineitem")]
    types = dict(mem.schema("lineitem"))

    def col(c):
        return ColumnRef(type=types[c], index=names.index(c))

    def call(fn, t, *args):
        return Call(type=parse_type(t) if isinstance(t, str) else t, fn=fn, args=tuple(args))

    def lit(v, t):
        return Literal(type=parse_type(t) if isinstance(t, str) else t, value=v)

    def lane(page, expr):
        return ExprCompiler.for_page(page).compile(expr)(page)

    def with_doubles(page):
        """The split with two double columns (K1's casts of the price
        and of price / quantity) after its own."""
        xd = lane(page, call("cast_double", DOUBLE, col("l_extendedprice")))
        yd = lane(page, call("div", DOUBLE, col("l_extendedprice"), col("l_quantity")))
        return Page(page.blocks + (Block(xd[0], xd[1], DOUBLE), Block(yd[0], yd[1], DOUBLE)),
                    page.row_mask)

    pages = [with_doubles(mem.page_for_split("lineitem", i)) for i in (0, 1)]
    page = pages[0]
    n = page.capacity
    xd = ColumnRef(type=DOUBLE, index=len(names))
    yd = ColumnRef(type=DOUBLE, index=len(names) + 1)
    xt, yt = page.blocks[len(names)].data, page.blocks[len(names) + 1].data
    okey, pkey = page.blocks[names.index("l_orderkey")].data, \
        page.blocks[names.index("l_partkey")].data
    # name: (expression, transcendental, library call, counter)
    rows = {
        "dun_sqrt": (call("sqrt", DOUBLE, xd), False, lambda: torch.sqrt(xt), "dun"),
        "dun_ln": (call("ln", DOUBLE, xd), True, lambda: torch.log(xt), "dun"),
        "dbin_power": (call("power", DOUBLE, yd, lit(1.5, "double")), True,
                       lambda: torch.pow(yt, 1.5), "dbin"),
        "bitw": (call("bitwise_xor", BIGINT, col("l_orderkey"), col("l_partkey")), False,
                 lambda: torch.bitwise_xor(okey, pkey), "bitw"),
        "gl": (call("greatest", DOUBLE, xd, yd), False, lambda: torch.maximum(xt, yt), "gl"),
        "nullif": (call("nullif", types["l_linenumber"], col("l_linenumber"),
                        lit(1, "integer")), False, None, "nullif"),
        "castbi": (call("cast_bigint", BIGINT, col("l_extendedprice")), False, None, "castbi"),
        "hll": (call("hll_rho", BIGINT, col("l_partkey")), False, None, "hll"),
        "datepart": (call("last_day_of_month", "date", col("l_shipdate")), False, None, "year"),
        "wbucket": (call("width_bucket", BIGINT, yd, lit(0.0, "double"),
                         lit(100000.0, "double"), lit(20, "bigint")), False, None, "wbucket"),
        "imod": (call("mod", BIGINT, col("l_orderkey"), lit(7, "bigint")), False,
                 lambda: torch.fmod(okey, 7), "imod"),
    }
    for label, (expr, transcendental, library, counter) in rows.items():
        name = f"expr_eval@{label}"
        prog, cols = ExprCompiler.for_page(page).lower(expr)
        ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
        got, want = k1.expr_eval(prog, ins, n), k1.expr_eval_plain(prog, ins, n)
        gap = 0
        if transcendental:
            same(got[1], want[1], f"{name} valid")
            gap = ulp_gap(got[0][want[1]], want[0][want[1]])
            if gap > 2:
                raise AssertionError(f"{name}: kernel and plain version {gap} ulp apart")
        else:
            same_bits(got, want, name)
        ms = cuda_ms(lambda: k1.expr_eval(prog, ins, n), 20)
        plain = cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n), 3)
        report.add(name, "cuda", "presto_tpu_torch/csrc/expr_eval.cu", gap, ms, plain,
                   nbytes(*[t for c in ins for t in c]) + nbytes(*got),
                   cuda_ms(library, 20) if library is not None else None,
                   f"expr_eval:{counter}")
        report.rows[name]["max_ulp"] = gap
        log(f"{name}: {len(prog.ops)} instructions, {gap} ulp")

    # the K2/K6 inputs: the doubles, a boolean lane, the varchar ranks of
    # l_shipinstruct (K1's collation table), HLL's rho of l_partkey
    def inputs(pg):
        b = pg.blocks
        ship = b[names.index("l_shipinstruct")]
        rank = ExprCompiler.run_program(k1.Program(
            (k1.LOAD, k1.CANON), (0, 0), (), 1, k1.KIND_I32,
            (rank_luts(ship.dictionary)[0],)), [names.index("l_shipinstruct")])(pg)
        flag = lane(pg, call("gt", BOOLEAN, col("l_quantity"), lit(2500, "decimal(12,2)")))
        rho = lane(pg, call("hll_rho", BIGINT, col("l_partkey")))
        ok, pk_ = b[names.index("l_orderkey")], b[names.index("l_partkey")]
        x = b[len(names)]
        return x, flag, rank, rho, ok, pk_

    mode_col = page.blocks[names.index("l_shipmode")]
    mode_keys = [(mode_col.data, mode_col.valid, 0, len(mode_col.dictionary.values) + 1)]
    x, flag, rank, rho, ok, pk_ = inputs(page)
    k2_rows = {
        "min_double": (mode_keys, [(k2.MIN_DOUBLE, x.data, x.valid),
                                   (k2.MAX_DOUBLE, x.data, x.valid)], mode_keys[0][3],
                       "packed_group_agg:min_double"),
        "bool_bitwise": (mode_keys, [(k2.BOOL_COUNT, flag[0], flag[1]),
                                     (k2.BIT_AND, ok.data, ok.valid),
                                     (k2.BIT_OR, pk_.data, pk_.valid),
                                     (k2.MIN_SHORT, flag[0], flag[1]),
                                     (k2.MAX_SHORT, rank[0], rank[1])], mode_keys[0][3],
                         "packed_group_agg:bitwise"),
        "hll": ([], [(k2.HLL_SUM, rho[0], rho[1])], 1, "packed_group_agg:hll"),
    }
    gid = torch.where(page.row_mask & x.valid, mode_col.data.to(torch.int64),
                      mode_keys[0][3])
    for label, (keys, args, g, counter) in k2_rows.items():
        name = f"packed_group_agg@{label}"
        got = k2.packed_group_agg(n, page.row_mask, keys, args, g)
        err = same_bits(got, k2.packed_group_agg_plain(n, page.row_mask, keys, args, g), name)
        ms = cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, keys, args, g), 10)
        plain = cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, keys, args, g), 2)
        library = None
        if label == "min_double":  # the least double per group, by a precomputed gid
            table = torch.full((g + 1,), float("inf"), dtype=torch.float64, device=page.device)
            library = cuda_ms(lambda: table.scatter_reduce_(0, gid, x.data, "amin"), 10)
        in_bytes = nbytes(page.row_mask, *[t for k in keys for t in k[:2]],
                          *[t for a in args for t in a[1:]])
        report.add(name, "cuda", "presto_tpu_torch/csrc/packed_group_agg.cu", err, ms, plain,
                   in_bytes + nbytes(*[t for st in got[0] for t in st], got[1]), library,
                   counter)

    # K6: by l_partkey (its exact domain), and HLL's sum by the buckets
    # of approx_distinct's inner level over l_orderkey
    dom = mem.column_domain("lineitem", "l_partkey")
    part_keys = [(pk_.data, pk_.valid, dom[0], dom[1] - dom[0] + 2)]
    states = [(k6.S_MIN_F64, x.data, x.valid), (k6.S_MAX_F64, x.data, x.valid),
              (k6.S_BAND, ok.data, ok.valid), (k6.S_BOR, ok.data, ok.valid),
              (k6.S_MIN, flag[0], flag[1]), (k6.S_SUM, flag[0], flag[1]),
              (k6.S_VALID, None, x.valid)]

    def double_min_library():
        n_ok = page.row_mask & x.valid
        _, g6 = torch.unique(pk_.data[n_ok], return_inverse=True)
        vals = x.data[n_ok]
        table = torch.full((int(g6.max()) + 1,), float("inf"), dtype=torch.float64,
                           device=page.device)
        return cuda_ms(lambda: table.scatter_reduce_(0, g6, vals, "amin"), 10)

    groups = k6_bits_row(report, "sorted_group_agg@min_double", part_keys, page.row_mask,
                         states, "sorted_group_agg:min_double", double_min_library())
    log(f"K6 double and boolean min/max, bool counts, bitwise folds: {groups} groups of "
        f"{n} rows")
    bucket = lane(page, call("hll_bucket", BIGINT, col("l_orderkey")))
    hll_keys = [(bucket[0], bucket[1], 0, 0)]
    groups = k6_bits_row(report, "sorted_group_agg@hll", hll_keys, page.row_mask,
                         [(k6.S_HLL, rho[0], rho[1]), (k6.S_VALID, None, rho[1])],
                         "sorted_group_agg:hll")
    log(f"K6 HLL sum: {groups} buckets")

    # K3: the two splits' global tables of the new states, folded and
    # finalized
    tables = []
    for pg in pages:
        x2, flag2, _, rho2, ok2, _ = inputs(pg)
        args = [(k2.MIN_DOUBLE, x2.data, x2.valid), (k2.MAX_DOUBLE, x2.data, x2.valid),
                (k2.BOOL_COUNT, flag2[0], flag2[1]), (k2.MIN_SHORT, flag2[0], flag2[1]),
                (k2.BIT_AND, ok2.data, ok2.valid), (k2.HLL_SUM, rho2[0], rho2[1])]
        tables.append(k2.packed_group_agg(pg.capacity, pg.row_mask, [], args, 1))
    kinds = [k3.COL_MIN_F64, k3.COL_I64, k3.COL_MAX_F64, k3.COL_I64, k3.COL_I64, k3.COL_I64,
             k3.COL_MIN_BOOL, k3.COL_I64, k3.COL_BAND, k3.COL_I64, k3.COL_F64, k3.COL_I64]

    def cols_of(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for s in states for t in s])]

    ca, cb = cols_of(*tables[0]), cols_of(*tables[1])
    fold = fold_row(report, "packed_fold_finalize@functions", ca, cb, tables[0][1],
                    tables[1][1], "packed_fold_finalize:min_double")
    f = [d for d, _ in fold[0]]
    finalize_row(report, "packed_fold_finalize@functions_finalize",
                 [(k3.FIN_SUM_F64, f[0], f[1]), (k3.FIN_BOOL_AND, f[4], f[5]),
                  (k3.FIN_BOOL_OR, f[4], f[5]), (k3.FIN_VALUE_BOOL, f[6], f[7]),
                  (k3.FIN_SUM, f[8], f[9]), (k3.FIN_HLL, f[10], f[11])], fold[1],
                 "packed_fold_finalize:hll")


def check_tail_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the ninth slice, over whole 2^23-row lineitem splits
    (the varchar casts over customer's split, str_cast's table): each
    new K1 opcode against its twin, exact; K2's checksum, moments and
    covariance sums (the global slot) and min_by (by l_shipmode); K6's
    moments, covariance sums and min_by by l_suppkey and their merge
    over two splits' partials; K3's fold of two splits' global tables
    and its finalizes (skewness within 2 ulp: pow), doubles by their
    bits."""
    from presto_tpu_torch.expr.compile import ExprCompiler, value_tables
    from presto_tpu_torch.expr.ir import Call, ColumnRef, Literal
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.ops.aggregate import CHECKSUM_NULL
    from presto_tpu_torch.page import Block, Page
    from presto_tpu_torch.types import BIGINT, DOUBLE, TIMESTAMP, parse_type

    def call(fn, t, *args):
        return Call(type=parse_type(t) if isinstance(t, str) else t, fn=fn, args=tuple(args))

    def lit(v, t):
        return Literal(type=parse_type(t) if isinstance(t, str) else t, value=v)

    def k1_check(name, page, expr, library, counter):
        n = page.capacity
        prog, cols = ExprCompiler.for_page(page).lower(expr)
        ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
        got, want = k1.expr_eval(prog, ins, n), k1.expr_eval_plain(prog, ins, n)
        err = same_bits(got, want, name)
        ms = cuda_ms(lambda: k1.expr_eval(prog, ins, n), 20)
        plain = cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n), 3)
        report.add(name, "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err, ms, plain,
                   nbytes(*[t for c in ins for t in c]) + nbytes(*got),
                   cuda_ms(library, 20) if library is not None else None,
                   f"expr_eval:{counter}")
        log(f"{name}: {' '.join(k1.OP_NAMES[o] for o in prog.ops)}, "
            f"{int(got[1].sum())} valid of {n}")
        return got

    names = [c for c, _ in mem.schema("lineitem")]
    types = dict(mem.schema("lineitem"))

    def col(c):
        return ColumnRef(type=types[c], index=names.index(c))

    def lane(page, expr):
        return ExprCompiler.for_page(page).compile(expr)(page)

    # each split with a timestamp (l_shipdate's midnight plus l_orderkey
    # x 1000003 microseconds) and l_extendedprice, l_quantity and
    # l_discount as doubles after its own columns
    ts_expr = call("ts_add_micros", TIMESTAMP, call("cast_timestamp", TIMESTAMP,
                                                     col("l_shipdate")),
                   call("mul", BIGINT, col("l_orderkey"), lit(1000003, "bigint")))

    def extended(page):
        extra = [lane(page, ts_expr)] + [lane(page, call("cast_double", DOUBLE, col(c)))
                                          for c in ("l_extendedprice", "l_quantity",
                                                    "l_discount")]
        return Page(page.blocks + tuple(Block(d, v, t) for (d, v), t in
                                        zip(extra, (TIMESTAMP, DOUBLE, DOUBLE, DOUBLE))),
                    page.row_mask)

    pages = [extended(mem.page_for_split("lineitem", i)) for i in (0, 1)]
    page = pages[0]
    n = page.capacity
    w = len(names)
    ts = ColumnRef(type=TIMESTAMP, index=w)
    ts_t = page.blocks[w].data
    price, qty, disc = (page.blocks[w + j] for j in (1, 2, 3))
    hour, day = 3_600_000_000, 86_400_000_000
    ship = page.blocks[names.index("l_shipinstruct")]
    lengths = value_tables(ship.dictionary, ("length",), len, torch.int64)[0].on(page.device)
    codes = ship.data.to(torch.int64).clamp(0, lengths.shape[0] - 1)
    rows = {
        "vlut": (call("length", BIGINT, col("l_shipinstruct")), lambda: lengths[codes], "vlut"),
        "tspart": (call("hour", BIGINT, ts), None, "tspart"),
        "dtrunc": (call("date_trunc", TIMESTAMP, lit("hour", "varchar"), ts),
                   lambda: torch.div(ts_t, hour, rounding_mode="floor") * hour, "dtrunc"),
        "dtadd": (call("date_add", TIMESTAMP, lit("month", "varchar"), col("l_linenumber"), ts),
                  None, "dtadd"),
        "dtdiff": (call("date_diff", BIGINT, lit("month", "varchar"), col("l_commitdate"),
                        col("l_receiptdate")), None, "dtdiff"),
        "castts": (call("cast_date", "date", ts),
                   lambda: torch.div(ts_t, day, rounding_mode="floor"), "castts"),
        "unixt": (call("to_unixtime", DOUBLE, ts), None, "unixt"),
        "dfmt": (call("date_format", "varchar", col("l_shipdate"), lit("%Y-%m", "varchar")),
                 None, "dfmt"),
    }
    for label, (expr, library, counter) in rows.items():
        k1_check(f"expr_eval@{label}", page, expr, library, counter)
    # checksum's per-row hash: splitmix64 of the lane, NULL's constant
    prog = k1.Program((k1.LOAD, k1.HLL, k1.LIT, k1.COAL), (0, 0, 0, 0), (CHECKSUM_NULL,), 1,
                      k1.KIND_I64)
    okey = page.blocks[names.index("l_orderkey")]
    ins = [(okey.data, okey.valid)]
    got = k1.expr_eval(prog, ins, n)
    err = same(got, k1.expr_eval_plain(prog, ins, n), "expr_eval@mix64")
    report.add("expr_eval@mix64", "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err,
               cuda_ms(lambda: k1.expr_eval(prog, ins, n), 20),
               cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n), 3),
               nbytes(okey.data, okey.valid, *got), None, "expr_eval:mix64")
    # the varchar casts over customer's split (str_cast's)
    cust = mem.page_for_split("customer", 0)
    cnames = [c for c, _ in mem.schema("customer")]
    phone = ColumnRef(type=dict(mem.schema("customer"))["c_phone"],
                      index=cnames.index("c_phone"))
    k1_check("expr_eval@dvlut", cust,
             call("cast_double", DOUBLE, call("substr", "varchar", phone, lit(4, "bigint"),
                                              lit(3, "bigint"))), None, "dvlut")

    # K2: the global slot's checksum, moments and covariance sums, and
    # min_by / max_by by l_shipmode (packed)
    hash_lane = got
    def cov_lanes(pg):
        """covar(l_quantity, l_extendedprice)'s five K1 lanes: x, y,
        x*y, x*x and y*y where both are valid."""
        pr_, qt_ = (ColumnRef(type=DOUBLE, index=w + j) for j in (1, 2))
        return [lane(pg, e) for e in (
            call("if", DOUBLE, call("not_null", "boolean", pr_), qt_, lit(None, "double")),
            call("if", DOUBLE, call("not_null", "boolean", qt_), pr_, lit(None, "double")),
            call("mul", DOUBLE, qt_, pr_), call("mul", DOUBLE, qt_, qt_),
            call("mul", DOUBLE, pr_, pr_))]

    cov = cov_lanes(page)
    mode_col = page.blocks[names.index("l_shipmode")]
    mode_keys = [(mode_col.data, mode_col.valid, 0, len(mode_col.dictionary.values) + 1)]
    pkey = page.blocks[names.index("l_partkey")]
    by_args = [(k2.BY_X, okey.data, okey.valid), (k2.BY_Y_MIN, price.data, price.valid),
               (k2.BY_X, pkey.data, pkey.valid), (k2.BY_Y_MAX, disc.data, disc.valid)]
    gid = torch.where(page.row_mask & price.valid, mode_col.data.to(torch.int64),
                      mode_keys[0][3])

    def min_by_library():
        """scatter_reduce_ amin of y by a precomputed gid, then a
        gather of the extreme back to the rows (min_by's first phase)."""
        table = torch.full((mode_keys[0][3] + 1,), float("inf"), dtype=torch.float64,
                           device=page.device)
        return table.scatter_reduce_(0, gid, price.data, "amin")[gid]

    def cov_library():
        ok = page.row_mask & qty.valid & price.valid
        both = torch.stack([price.data[ok], qty.data[ok]])
        return cuda_ms(lambda: torch.cov(both), 10)

    k2_rows = {
        "checksum": ([], [(k2.CHECKSUM, hash_lane[0], hash_lane[1])], 1, None,
                     "packed_group_agg:checksum"),
        "moments": ([], [(k2.MOMENTS, qty.data, qty.valid)], 1, None,
                    "packed_group_agg:moments"),
        "covariance": ([], [(k2.SUM_DOUBLE, d, v) for d, v in cov], 1, cov_library(),
                       "packed_group_agg:double_sum"),
        "min_by": (mode_keys, by_args, mode_keys[0][3], cuda_ms(min_by_library, 10),
                   "packed_group_agg:min_by"),
    }
    for label, (keys, args, g, library, counter) in k2_rows.items():
        name = f"packed_group_agg@{label}"
        got2 = k2.packed_group_agg(n, page.row_mask, keys, args, g)
        err = same_bits(got2, k2.packed_group_agg_plain(n, page.row_mask, keys, args, g), name)
        ms = cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, keys, args, g), 10)
        plain = cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, keys, args, g), 2)
        in_bytes = nbytes(page.row_mask, *[t for k in keys for t in k[:2]],
                          *[t for a in args for t in a[1:]])
        report.add(name, "cuda", "presto_tpu_torch/csrc/packed_group_agg.cu", err, ms, plain,
                   in_bytes + nbytes(*[t for st in got2[0] for t in st], got2[1]), library,
                   counter)

    # K6 by l_suppkey: the partials of two splits, then their merge
    supp = [pg.blocks[names.index("l_suppkey")] for pg in pages]
    dom = mem.column_domain("lineitem", "l_suppkey")

    def supp_keys(i):
        return [(supp[i].data, supp[i].valid, dom[0], dom[1] - dom[0] + 2)]

    def tail_states(pg):
        b = pg.blocks
        ok_, pk_ = b[names.index("l_orderkey")], b[names.index("l_partkey")]
        pr, qt, dc = b[w + 1], b[w + 2], b[w + 3]
        return [(k6.S_MOM, qt.data, qt.valid),
                (k6.S_BY_X, ok_.data, ok_.valid), (k6.S_BY_XV, None, ok_.valid),
                (k6.S_BY_Y_MIN, pr.data, pr.valid), (k6.S_VALID, None, pr.valid),
                (k6.S_BY_X, pk_.data, pk_.valid), (k6.S_BY_XV, None, pk_.valid),
                (k6.S_BY_Y_MAX, dc.data, dc.valid), (k6.S_VALID, None, dc.valid)]

    states = tail_states(page)
    groups = k6_bits_row(report, "sorted_group_agg@moments", supp_keys(0), page.row_mask,
                         states[:1], "sorted_group_agg:moments")
    k6_bits_row(report, "sorted_group_agg@min_by", supp_keys(0), page.row_mask, states[1:],
                "sorted_group_agg:min_by")
    k6_bits_row(report, "sorted_group_agg@covariance", supp_keys(0), page.row_mask,
                [(k6.S_DSUM, d, v) for d, v in cov] + [(k6.S_VALID, None, cov[0][1])],
                "sorted_group_agg:double_sum", group_sum_library_ms(
                    supp_keys(0), page.row_mask,
                    [(k6.S_DSUM, d, v) for d, v in cov] + [(k6.S_VALID, None, cov[0][1])]))
    log(f"K6 moments, min_by / max_by, covariance sums: {groups} groups of {n} rows")
    parts = [k6.sorted_group_agg(supp_keys(i), pg.row_mask, tail_states(pg))
             for i, pg in enumerate(pages)]
    # the partials of both splits as one page of rows: keys, the
    # moments (s, m2, m3, m4, cnt) and the two coupled states (x, flag,
    # y, count)
    cat = [torch.cat([p[0][0][0] for p in parts]), torch.cat([p[0][0][1] for p in parts])]
    st = [torch.cat([p[1][j] for p in parts]) for j in range(len(parts[0][1]))]
    live = torch.ones(cat[0].shape[0], dtype=torch.bool, device=page.device)
    merge_keys = [(cat[0], cat[1], dom[0], dom[1] - dom[0] + 2)]
    mom = tuple(st[:5])
    groups = k6_bits_row(report, "sorted_group_agg@moments_merge", merge_keys, live,
                         [(k6.S_MOM_MERGE, mom, live)], "sorted_group_agg:moments_merge")
    by_merge = []
    for x, flag, y, cnt, kind in ((st[5], st[6], st[7], st[8], k6.S_BY_Y_MIN),
                                  (st[9], st[10], st[11], st[12], k6.S_BY_Y_MAX)):
        by_merge += [(k6.S_BY_X, x, flag > 0), (k6.S_BY_XV, None, flag > 0),
                     (kind, y, cnt > 0), (k6.S_SUM, cnt, live)]
    k6_bits_row(report, "sorted_group_agg@min_by_merge", merge_keys, live, by_merge,
                "sorted_group_agg:min_by")
    log(f"K6 merges of {cat[0].shape[0]} partial rows: {groups} groups")

    # K3: the two splits' global tables (checksum, moments, min_by and
    # max_by, the covariance sums) folded, then finalized
    tables = []
    for pg in pages:
        b = pg.blocks
        ok_, pk_ = b[names.index("l_orderkey")], b[names.index("l_partkey")]
        pr, qt, dc = b[w + 1], b[w + 2], b[w + 3]
        hsh = k1.expr_eval(prog, [(ok_.data, ok_.valid)], pg.capacity)
        args = [(k2.CHECKSUM, hsh[0], hsh[1]), (k2.MOMENTS, qt.data, qt.valid),
                (k2.BY_X, ok_.data, ok_.valid), (k2.BY_Y_MIN, pr.data, pr.valid),
                (k2.BY_X, pk_.data, pk_.valid), (k2.BY_Y_MAX, dc.data, dc.valid)]
        args += [(k2.SUM_DOUBLE, d, v) for d, v in cov_lanes(pg)]
        tables.append(k2.packed_group_agg(pg.capacity, pg.row_mask, [], args, 1))
    kinds = [k3.COL_I64, k3.COL_F64, k3.COL_MOM_M2, k3.COL_MOM_M3, k3.COL_MOM_M4, k3.COL_I64,
             k3.COL_BY_X, k3.COL_BY_XV, k3.COL_BY_Y_MIN, k3.COL_I64,
             k3.COL_BY_X, k3.COL_BY_XV, k3.COL_BY_Y_MAX, k3.COL_I64] + [k3.COL_F64, k3.COL_I64] * 5

    def cols_of(states_, present):
        return [(k, t, present) for k, t in zip(kinds, [t for s_ in states_ for t in s_])]

    ca, cb = cols_of(*tables[0]), cols_of(*tables[1])
    fold = fold_row(report, "packed_fold_finalize@tail_fold", ca, cb, tables[0][1],
                    tables[1][1], "packed_fold_finalize:moments_fold")
    f = [d for d, _ in fold[0]]
    mom3 = torch.stack(f[2:5], dim=1)
    sums5 = torch.stack(f[14:24:2], dim=1)  # sx, sy, sxy, sxx, syy
    items = [(k3.FIN_COUNT, f[0], f[0]), (k3.FIN_SKEWNESS, mom3, f[5]),
             (k3.FIN_KURTOSIS, mom3, f[5]), (k3.FIN_SUM, f[6], f[7]), (k3.FIN_SUM, f[10], f[11]),
             (k3.FIN_COVAR_POP, sums5, f[15]), (k3.FIN_COVAR_SAMP, sums5, f[15]),
             (k3.FIN_CORR, sums5, f[15]), (k3.FIN_REGR_SLOPE, sums5, f[15]),
             (k3.FIN_REGR_INTERCEPT, sums5, f[15])]
    name = "packed_fold_finalize@tail_finalize"
    got3 = k3.packed_finalize(items, fold[1])
    want3 = k3.packed_finalize_plain(items, fold[1])
    same(got3[1], want3[1], f"{name} skewness valid")
    gap = ulp_gap(got3[1][0], want3[1][0])
    if gap > 2:
        raise AssertionError(f"{name}: skewness {gap} ulp from its plain version")
    err = same_bits(got3[:1] + got3[2:], want3[:1] + want3[2:], name)
    report.add(name, "cuda", "presto_tpu_torch/csrc/packed_fold_finalize.cu", err,
               cuda_ms(lambda: k3.packed_finalize(items, fold[1]), 50),
               cuda_ms(lambda: k3.packed_finalize_plain(items, fold[1]), 10),
               nbytes(fold[1], *[t for _, a, b in items for t in (a, b)],
                      *[t for o in got3 for t in o]), counter="packed_fold_finalize:moments")
    report.rows[name]["max_ulp"] = gap
    log(f"{name}: skewness {gap} ulp from its plain version")


def container_sweep(device) -> int:
    """Every K12 opcode (over int64, double and int32 storage), K13 and
    K14 against their twins on the card, bit for bit, over seeded slot
    matrices of 2^20 rows: NULL elements and containers, empty arrays,
    +-inf, extremes, duplicate keys.  Returns the checks made."""
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import group_collect as k14
    from presto_tpu_torch.kernels import unnest_expand as k13

    g = torch.Generator().manual_seed(10)
    n, m = 1 << 20, 8

    def mat(dtype):
        lens = torch.randint(0, m + 1, (n,), generator=g)
        s = torch.randint(-4, 5, (n, m), generator=g).to(dtype)
        if dtype.is_floating_point:
            s[torch.rand((n, m), generator=g) < 0.05] = float("inf")
        else:
            s[torch.rand((n, m), generator=g) < 0.05] = torch.iinfo(dtype).max
        s[torch.rand((n, m), generator=g) < 0.1] = k12.sentinel(dtype)
        j = torch.arange(m)[None, :]
        s = torch.where(j < lens[:, None], s, torch.full_like(s, k12.sentinel(dtype)))
        return torch.cat([lens[:, None].to(dtype), s], 1).to(device)

    def rnd(p):
        return (torch.rand(n, generator=g) < p).to(device)

    checks = 0
    for dtype in (torch.int64, torch.float64, torch.int32):
        a, b = mat(dtype), mat(dtype)
        mp = torch.cat([a, b[:, 1:]], 1).contiguous()
        av, xv = rnd(0.9), rnd(0.9)
        x = torch.randint(-3, 10, (n,), generator=g).to(device)
        rm = rnd(0.9)
        outs = k13.unnest_expand(rm, [(a, av, m, [(1, dtype)])], [(x, xv)], True)
        off, total = outs[4], outs[3]
        yb = (torch.rand(max(total, 1), generator=g) < 0.5).to(device)
        yv = (torch.rand(max(total, 1), generator=g) < 0.9).to(device)
        yd = torch.randint(-5, 5, (max(total, 1),), generator=g).to(dtype).to(device)
        y2 = torch.stack([x.to(dtype), (x * 3).to(dtype)], 1).contiguous()
        y2v = torch.stack([xv, av], 1).contiguous()
        cases = [
            dict(op=k12.CARD, a=a, av=av), dict(op=k12.SUBSCRIPT, a=a, av=av, x=x, xv=xv),
            dict(op=k12.MAP_GET, a=mp, av=av, x=x, xv=xv, p=[0, 0, 0, 0, 0, m]),
            dict(op=k12.CONTAINS, a=a, av=av, x=x, xv=xv),
            dict(op=k12.POSITION, a=a, av=av, x=x, xv=xv),
            dict(op=k12.SORT, a=a), dict(op=k12.DISTINCT, a=a),
            dict(op=k12.SLICE, a=a, p=[-3, 2]), dict(op=k12.SLICE, a=a, p=[2, 9]),
            dict(op=k12.COERCE, a=a, out_dtype=torch.float64, p=[0, 0, 0, 0, 0, m]),
            dict(op=k12.COERCE, a=a, out_dtype=torch.int64, p=[k12.C_UP, 100, 0, 0, 0, m]),
            dict(op=k12.COERCE, a=mp, out_dtype=torch.float64,
                 p=[k12.C_ASTYPE, 0, k12.C_DEC2DBL, k12.double_bits(100.0), 1, m]),
            dict(op=k12.CONCAT, a=a, b=b, out_m=2 * m),
            dict(op=k12.MAP_HALF, a=mp, out_dtype=torch.float64, p=[1, 0, 0, 0, 0, m]),
            dict(op=k12.CONSTRUCT, y=y2, yv=y2v, out_m=m, p=[1]),
            dict(op=k12.CONSTRUCT, y=y2, yv=y2v, out_m=2, p=[0]),
            dict(op=k12.CONSTRUCT_MAP, a=a, b=b, out_m=m),
            dict(op=k12.ROW_FIELD, a=a, av=av, p=[3]),
            dict(op=k12.COMPACT, a=a, y=yb, yv=yv, off=off, out_m=m),
            dict(op=k12.COMPACT_PAIRS, a=mp, y=yb, yv=yv, off=off, out_m=m,
                 p=[0, 0, 0, 0, 0, m]),
            dict(op=k12.SETOP, a=a, b=b, c=a, out_m=m, p=[k12.S_INTERSECT]),
            dict(op=k12.SETOP, a=a, b=b, c=a, out_m=m, p=[k12.S_EXCEPT]),
            dict(op=k12.OVERLAP, a=a, av=av, b=b, bv=xv, c=a),
            dict(op=k12.REMOVE, a=a, av=av, x=x, xv=xv),
            dict(op=k12.MAP_CONCAT, a=mp, b=mp.flip(0).contiguous(), out_m=m,
                 p=[0, 0, 0, 0, m, m]),
            dict(op=k12.TKEYS, a=mp, y=yd, yv=yv, off=off, out_m=m, p=[0, 0, 0, 0, 0, m]),
            dict(op=k12.SEQUENCE, x=x, out_m=5, out_dtype=torch.int64, p=[3, -2]),
            dict(op=k12.REPEAT, x=x, xv=xv, out_m=4, out_dtype=dtype, p=[3]),
            dict(op=k12.ASSEMBLE, y=yd, yv=yv, off=off, out_m=m),
            dict(op=k12.ASSEMBLE, a=mp, y=yd, yv=yv, off=off, out_m=m,
                 p=[1, k12._KIND[dtype]]),
            dict(op=k12.MATCH, av=av, y=yb, yv=yv, off=off, p=[k12.M_ALL, m]),
            dict(op=k12.SLOT, a=a, p=[2]),
            dict(op=k12.TABLE, a=b[:1000].contiguous(), x=x.abs(), xv=xv),
        ] + [dict(op=k12.REDUCE, a=a, av=av, p=[r]) for r in range(4)]
        for kw in cases:
            got = k12.container_eval(**kw)
            same_bits(got, _k12_plain(kw), f"container_eval {k12.OP_NAMES[kw['op']]} {dtype}")
            checks += 1
        want = k13.unnest_expand_plain(rm, [(a, av, m, [(1, dtype)])], [(x, xv)], True)
        same_bits([t for c in outs[0] + outs[1] for t in c] + [outs[2], outs[4]],
                  [t for c in want[0] + want[1] for t in c] + [want[2], want[4]],
                  f"unnest_expand {dtype}")
        gid = torch.sort(torch.randint(0, n // 5, (n,), generator=g)).values
        starts = torch.searchsorted(gid, torch.arange(n // 5 + 1)).to(device)
        order = torch.randperm(n, generator=g).to(device)
        for halves in ([(x, xv)], [(x, rm), (a[:, 1].contiguous(), xv)]):
            same_bits(k14.group_collect(order, starts, rm, halves, 16, dtype),
                      k14.group_collect_plain(order, starts, rm, halves, 16, dtype),
                      f"group_collect {dtype}")
        parts = torch.cat([torch.clamp(a[:, :1], max=8), a[:, 1:]], 1).contiguous()
        same_bits(k14.group_collect_merge(order, starts, rm, parts, 8),
                  k14.group_collect_merge_plain(order, starts, rm, parts, 8),
                  f"group_collect_merge {dtype}")
        checks += 4
    return checks


def _k12_plain(kw):
    from presto_tpu_torch.kernels import container_eval as k12

    pp = list(kw.get("p", [])) + [0] * (6 - len(kw.get("p", [])))
    return k12.plain(kw["op"], kw.get("a"), kw.get("av"), kw.get("b"), kw.get("bv"),
                     kw.get("c"), kw.get("x"), kw.get("xv"), kw.get("y"), kw.get("yv"),
                     kw.get("off"), kw.get("out_m", 0), kw.get("out_dtype"), pp)


def check_container_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the tenth slice: :func:`container_sweep` (every opcode,
    exact), then the kernels at the main path's shapes, each against its
    twin (bit for bit) and timed: K12's per-row opcodes over a whole
    2^23-row lineitem split (ct_row_ops' array construction, subscript,
    contains, map lookup and ROW field), over part's p_name codes
    (split's table) and over 2^22 of the 15M arrays ct_array_agg builds
    (cardinality, array_sum, array_sort, reduce's slot, and the lambdas'
    assembly, compaction and match over K13's flattening); K13 over the
    same arrays WITH ORDINALITY; K14's collect over the split grouped by
    l_orderkey (K6's runs) and its merge of two splits' partials."""
    from presto_tpu_torch.expr.containers import split_parts
    from presto_tpu_torch.expr.ir import AggCall, ColumnRef
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import group_collect as k14
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.kernels import unnest_expand as k13
    from presto_tpu_torch.ops.aggregate import grouped_aggregate
    from presto_tpu_torch.ops.join import key_columns
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.types import parse_type

    t0 = time.perf_counter()
    log(f"container sweep: {container_sweep(mem.device)} checks equal their twins")
    page = mem.page_for_split("lineitem", 0)
    names = [c for c, _ in mem.schema("lineitem")]
    n = page.capacity
    dev = page.device

    def col(c):
        b = page.blocks[names.index(c)]
        return b.data, b.valid

    def row(name, kw, library=None, reads=None):
        """One K12 row; ``reads``: the bytes of the containers the opcode
        must read, where it reads only some of their slots (else every
        input counts whole)."""
        got = k12.container_eval(**kw)
        err = same_bits(got, _k12_plain(kw), name)
        keys = ("av", "b", "bv", "c", "x", "xv", "y", "yv", "off")
        ins = [kw.get(k) for k in keys + (() if reads is not None else ("a",))]
        outs = got if isinstance(got, tuple) else (got,)
        report.add(name, "cuda", "presto_tpu_torch/csrc/container_eval.cu", err,
                   cuda_ms(lambda: k12.container_eval(**kw), 10),
                   cuda_ms(lambda: _k12_plain(kw), 2),
                   nbytes(*ins) + nbytes(*outs) + (reads or 0),
                   cuda_ms(library, 10) if library is not None else None,
                   f"container_eval:{k12.OP_NAMES[kw['op']]}")
        return got

    # ct_row_ops' per-row work over the split
    pk_, pkv = col("l_partkey")
    sk, skv = col("l_suppkey")
    ln, lnv = col("l_linenumber")
    rf, rfv = col("l_returnflag")
    y = torch.stack([pk_.to(torch.int64), sk.to(torch.int64)], 1).contiguous()
    yv = torch.stack([pkv, skv], 1).contiguous()
    arr2 = row("container_eval@construct", dict(op=k12.CONSTRUCT, y=y, yv=yv, out_m=2, p=[1]))
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    two = torch.full((n,), 2, dtype=torch.int64, device=dev)
    row("container_eval@subscript", dict(op=k12.SUBSCRIPT, a=arr2, av=ones, x=two, xv=ones),
        library=lambda: torch.gather(arr2, 1, two[:, None]), reads=16 * n)  # length, slot
    lits = torch.tensor([3, 1, 5, 7], dtype=torch.int64, device=dev)
    const = lits[None, :].expand(n, 4).contiguous()
    row("container_eval@contains", dict(op=k12.CONTAINS, a=const, av=ones, x=ln, xv=lnv),
        library=lambda: torch.isin(ln, lits[1:]))
    mp = torch.tensor([3, 0, 1, 2, 1, 2, 3], dtype=torch.int64,
                      device=dev)[None, :].expand(n, 7).contiguous()
    row("container_eval@map_get", dict(op=k12.MAP_GET, a=mp, av=ones, x=rf, xv=rfv,
                                       p=[0, 0, 0, 0, 0, 3]), reads=40 * n)  # length, keys, value
    row("container_eval@row_field", dict(op=k12.ROW_FIELD, a=y, av=ones, p=[0]), reads=8 * n)
    # split's table over part's p_name codes
    part = mem.page_for_split("part", 0)
    pname = part.blocks[[c for c, _ in mem.schema("part")].index("p_name")]
    t1 = time.perf_counter()
    _, table_np = split_parts(pname.dictionary, " ", 8)
    log(f"split's parts table over p_name's {len(pname.dictionary)} values built on the host "
        f"in {time.perf_counter() - t1:.2f} s (ct_words' first run pays it; later runs, and "
        f"ct_words here, find it cached)")
    table = torch.from_numpy(table_np).to(torch.int64).to(dev)
    codes = pname.data.to(torch.int64)
    row("container_eval@table", dict(op=k12.TABLE, a=table, x=pname.data, xv=pname.valid),
        library=lambda: torch.index_select(table, 0, codes))
    # the arrays ct_array_agg builds (the first 2^22 of them)
    sql = "select l_orderkey, array_agg(l_partkey) a from lineitem group by l_orderkey"
    runner = QueryRunner(query_catalog(mem, sql), device="cuda")
    agg = runner.executor.run_to_page(runner.plan(sql))
    cut = min(1 << 22, agg.capacity)
    arrs = agg.blocks[1].data[:cut].contiguous()
    av = agg.blocks[1].valid[:cut] & agg.row_mask[:cut]
    okeys = (agg.blocks[0].data[:cut].contiguous(), agg.blocks[0].valid[:cut].contiguous())
    log(f"ct_array_agg's arrays: {agg.capacity} groups, state {tuple(agg.blocks[1].data.shape)}"
        f" {agg.blocks[1].data.dtype}; the checks take the first {cut}")
    # the slots an opcode must read: the lengths, and the live elements
    live = 8 * (cut + int(torch.clamp(k12.lengths(arrs), max=64).sum()))
    row("container_eval@card", dict(op=k12.CARD, a=arrs, av=av), reads=8 * cut)
    row("container_eval@reduce", dict(op=k12.REDUCE, a=arrs, av=av, p=[k12.R_SUM]), reads=live)
    row("container_eval@sort", dict(op=k12.SORT, a=arrs),
        library=lambda: torch.sort(arrs[:, 1:], dim=1), reads=live)
    row("container_eval@slot", dict(op=k12.SLOT, a=arrs, p=[1]), reads=16 * cut)
    args = [(arrs, av, 64, [(1, torch.int64)])]
    got = k13.unnest_expand(av, args, [okeys], True)
    want = k13.unnest_expand_plain(av, args, [okeys], True)
    err = same_bits([t for c in got[0] + got[1] for t in c] + [got[2], got[4]],
                    [t for c in want[0] + want[1] for t in c] + [want[2], want[4]],
                    "unnest_expand")
    total, off = got[3], got[4]
    counts = off[1:] - off[:-1]
    # the bound: the length slots, validity and keys read once, each
    # element read once, the rows' key, element and ordinality (and
    # their validity) written once, the offsets
    moved = nbytes(arrs[:, 0], av, *okeys) + total * (8 + 3 * 8 + 3) + off.numel() * 8
    report.add("unnest_expand", "cuda", "presto_tpu_torch/csrc/unnest_expand.cu", err,
               cuda_ms(lambda: k13.unnest_expand(av, args, [okeys], True), 5),
               cuda_ms(lambda: k13.unnest_expand_plain(av, args, [okeys], True), 2), moved,
               cuda_ms(lambda: torch.repeat_interleave(okeys[0], counts), 5), "unnest_expand")
    log(f"unnest_expand: {cut} arrays to {total} rows")
    (ed, ev), = got[1]
    yd = ed * 2
    yb = (ed % 2) == 0
    row("container_eval@assemble", dict(op=k12.ASSEMBLE, y=yd, yv=ev, off=off, out_m=64))
    row("container_eval@compact", dict(op=k12.COMPACT, a=arrs, y=yb, yv=ev, off=off,
                                       out_m=64), reads=live)
    row("container_eval@match", dict(op=k12.MATCH, av=av, y=yb, yv=ev, off=off,
                                     p=[k12.M_ANY, 64]))
    del agg, arrs, got, want, ed, ev, yd, yb, runner
    # K14: the split grouped by l_orderkey, then two splits' partials merged
    okey = ColumnRef(type=parse_type("bigint"), index=names.index("l_orderkey"))
    keys = key_columns(page, [okey], [None])
    _, _, groups, (order, starts) = k6.sorted_group_agg(keys, page.row_mask,
                                                        [(k6.S_ONE, None, None)], runs=True)
    halves = [col("l_partkey")]
    got = k14.group_collect(order, starts, page.row_mask, halves, 64, torch.int64)
    err = same_bits(got, k14.group_collect_plain(order, starts, page.row_mask, halves, 64,
                                                 torch.int64), "group_collect")
    live = int(starts[-1])
    gidx = torch.repeat_interleave(torch.arange(groups, device=dev), starts[1:] - starts[:-1])
    rank = torch.arange(live, device=dev) - starts[:-1][gidx]
    vals = halves[0][0][order[:live]].to(torch.int64)
    table64 = torch.empty_like(got)
    report.add("group_collect", "cuda", "presto_tpu_torch/csrc/group_collect.cu", err,
               cuda_ms(lambda: k14.group_collect(order, starts, page.row_mask, halves, 64,
                                                 torch.int64), 10),
               cuda_ms(lambda: k14.group_collect_plain(order, starts, page.row_mask, halves, 64,
                                                       torch.int64), 2),
               nbytes(order, starts, page.row_mask, *halves[0], got),
               cuda_ms(lambda: table64.index_put_((gidx, 1 + rank), vals), 10), "group_collect")
    acall = AggCall(fn="array_agg", arg=ColumnRef(type=parse_type("bigint"),
                                                  index=names.index("l_partkey")),
                    type=parse_type("array(bigint, 64)"))
    parts = [grouped_aggregate(mem.page_for_split("lineitem", i), [okey], [acall], 1 << 14,
                               key_domains=[None], mode="partial") for i in (0, 1)]
    cat = concat_pages_device(parts)
    mkeys = key_columns(cat, [ColumnRef(type=okey.type, index=0)], [None])
    _, _, _, (morder, mstarts) = k6.sorted_group_agg(mkeys, cat.row_mask, [], runs=True)
    pm = cat.blocks[1].data
    got = k14.group_collect_merge(morder, mstarts, cat.row_mask, pm, 64)
    err = same_bits(got, k14.group_collect_merge_plain(morder, mstarts, cat.row_mask, pm, 64),
                    "group_collect_merge")
    elements = int(torch.clamp(pm[:, 0], min=0).sum())
    report.add("group_collect@merge", "cuda", "presto_tpu_torch/csrc/group_collect.cu", err,
               cuda_ms(lambda: k14.group_collect_merge(morder, mstarts, cat.row_mask, pm, 64),
                       10),
               cuda_ms(lambda: k14.group_collect_merge_plain(morder, mstarts, cat.row_mask, pm,
                                                             64), 2),
               nbytes(morder, mstarts, cat.row_mask, pm[:, 0], got) + 8 * elements, None,
               "group_collect:merge")
    log(f"group_collect: {groups} groups in split 0; merge of {cat.capacity} partial rows; "
        f"the container checks took {time.perf_counter() - t0:.1f} s")


def check_fn_rows(label, got, ref, where: str = "") -> None:
    """The function queries' rows: exact, but the FN_APPROX columns
    (a transcendental's doubles) within a relative 1e-12; ``where``
    names the scale in the messages."""
    import math

    approx = FN_APPROX.get(label, ())
    label += where
    if len(got.rows) != len(ref.rows) or not ref.rows:
        raise AssertionError(f"{label}: {len(got.rows)} card rows, {len(ref.rows)} CPU rows")
    for g, r in zip(got.rows, ref.rows):
        for j, (a, b) in enumerate(zip(g, r)):
            ok = math.isclose(a, b, rel_tol=1e-12, abs_tol=0) if j in approx else a == b
            if not ok:
                raise AssertionError(f"{label}: card row {g} != CPU row {r}")


def plan_required(plan) -> tuple:
    """The kernels a TPC-DS plan's shape must launch: K4 for a join,
    K2 or K6 for a grouping, K10 for a window, K7 for a top-N."""
    from presto_tpu_torch.planner.plan import AggregationNode, JoinNode, TopNNode, WindowNode

    req = []
    if find_all(plan, JoinNode):
        req.append("join_build")
    if any(a.group_exprs for a in find_all(plan, AggregationNode)):
        req.append("packed_group_agg|sorted_group_agg")
    if find_all(plan, WindowNode):
        req.append("window_eval")
    if find_all(plan, TopNNode):
        req.append("topn")
    return tuple(req)


def profile_query(runner, sql: str) -> str:
    """One traced run of ``sql``: device-busy share of its wall time
    and the device time of its heaviest kernels (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # an operator's row repeats the device time of its kernels
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    if not rows:
        return "device time not measured (the profiler saw no device activity)"
    busy = sum(us for us, _, _ in rows)
    top = ", ".join(f"{k} {us / 1e3:.3f} ms x{c}" for us, k, c in sorted(rows, reverse=True)[:6])
    return (f"traced wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.3f} ms "
            f"({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%); {top}")


def counters():
    from presto_tpu_torch.kernels import (
        container_eval, expr_eval, group_collect, join_build, join_expand, join_probe, keys,
        packed_fold_finalize, packed_group_agg, sorted_group_agg, spill_partition, topn,
        unnest_expand, window_eval,
    )

    return {"expr_eval": expr_eval, "packed_group_agg": packed_group_agg,
            "packed_fold_finalize": packed_fold_finalize, "join_build": join_build,
            "join_probe": join_probe, "sorted_group_agg": sorted_group_agg, "topn": topn,
            "join_expand": join_expand, "hash_keys": keys, "window_eval": window_eval,
            "spill_partition": spill_partition, "container_eval": container_eval,
            "unnest_expand": unnest_expand, "group_collect": group_collect}


# counters of one kind of launch: (kernel, attribute, name in the counts)
SUB_COUNTS = (("expr_eval", "in_launches", "expr_eval:in"),
              ("packed_group_agg", "minmax_launches", "packed_group_agg:minmax"),
              ("sorted_group_agg", "minmax_launches", "sorted_group_agg:minmax"),
              ("sorted_group_agg", "presorted_launches", "sorted_group_agg:presorted"),
              ("topn", "wide_launches", "topn:n>32"),
              ("expr_eval", "double_launches", "expr_eval:double"),
              ("topn", "double_launches", "topn:double"),
              ("packed_fold_finalize", "double_avg_launches", "packed_fold_finalize:avg_double"),
              ("packed_group_agg", "variance_launches", "packed_group_agg:variance"),
              ("packed_group_agg", "double_sum_launches", "packed_group_agg:double_sum"),
              ("sorted_group_agg", "variance_launches", "sorted_group_agg:variance"),
              ("sorted_group_agg", "variance_merge_launches", "sorted_group_agg:variance_merge"),
              ("sorted_group_agg", "double_sum_launches", "sorted_group_agg:double_sum"),
              ("packed_fold_finalize", "chan_fold_launches", "packed_fold_finalize:chan"),
              ("packed_fold_finalize", "sum0_launches", "packed_fold_finalize:sum0"),
              ("packed_fold_finalize", "collapse_launches", "packed_fold_finalize:collapse"),
              ("packed_fold_finalize", "variance_launches", "packed_fold_finalize:variance"),
              ("hash_keys", "double_launches", "hash_keys:double"),
              ("spill_partition", "gather_launches", "spill_partition:gather"),
              ("join_build", "null_flags_launches", "join_build:null_flags"),
              ("group_collect", "merge_launches", "group_collect:merge"))


# kernels that count their launches by kind in a dict, by its attribute
KIND_DICTS = (("join_probe", "kind_launches"), ("expr_eval", "op_launches"),
              ("packed_group_agg", "kind_launches"), ("sorted_group_agg", "kind_launches"),
              ("packed_fold_finalize", "kind_launches"), ("container_eval", "op_launches"))


def reset_counts() -> None:
    mods = counters()
    for mod in mods.values():
        mod.launches = 0
    for kernel, attr in KIND_DICTS:
        getattr(mods[kernel], attr).clear()
    for kernel, attr, _ in SUB_COUNTS:
        setattr(mods[kernel], attr, 0)


def read_counts() -> dict:
    mods = counters()
    out = {k: mod.launches for k, mod in mods.items()}
    for kernel, attr in KIND_DICTS:
        for kind, n in getattr(mods[kernel], attr).items():
            out[f"{kernel}:{kind}"] = n
    for kernel, attr, name in SUB_COUNTS:
        out[name] = getattr(mods[kernel], attr)
    return out


def streamed_tables(plan) -> set:
    """The tables a presorted (streaming) aggregation of ``plan`` scans."""
    from presto_tpu_torch.planner.plan import AggregationNode, TableScanNode

    return {scan.handle.table for agg in find_all(plan, AggregationNode) if agg.presorted
            for scan in find_all(agg, TableScanNode)}


def query_catalog(conn, sql: str, ordered=(), tables=None, name: str = "tpch"):
    """A catalog over ``conn``'s tables pruned to the columns ``sql``
    names (TPC-H's and TPC-DS's column names are unique words), plus
    the declared sort order's columns of the ``ordered`` tables (those a
    streaming aggregation reads): a MemoryConnector on ``conn``'s device
    whose pages share ``conn``'s tensors."""
    import re

    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector

    pruned = MemoryConnector(device=conn.device)
    for table, columns in (TABLES if tables is None else tables).items():
        named = [c for c in columns if re.search(rf"\b{c}\b", sql)
                 or (table in ordered and c in conn.sort_order(table))]
        if named:
            pruned.load_from(conn, table, columns=named)
    catalog = Catalog()
    catalog.register(name, pruned)
    return catalog


def ds_tables(queries=None) -> dict:
    """The TPC-DS tables ``queries`` (default: every slice's) read, each
    with the columns any of them names."""
    import re

    from presto_tpu_torch.connectors.tpcds import SCHEMAS

    sqls = list((queries if queries is not None
                 else {**DS_QUERIES, **DS2_QUERIES, **DS3_QUERIES}).values())
    out = {}
    for table, schema in SCHEMAS.items():
        if any(re.search(rf"\b{table}\b", sql) for sql in sqls):
            out[table] = [c for c, _ in schema
                          if any(re.search(rf"\b{c}\b", sql) for sql in sqls)]
    return out


def run_counted(runners, queries, required, launches, results, wall) -> None:
    """Each query once with every launch counter set to 0 just before
    it and read just after; fails unless it launched its path's kernels."""
    for label, sql in queries.items():
        runners[label].execute(sql)  # plans and warms the allocator
    torch.cuda.synchronize()
    for label, sql in queries.items():
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results[label] = runners[label].execute(sql)
        wall[label] = [time.perf_counter() - t0]
        launches[label] = read_counts()
        log(f"{label} launches: {launches[label]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, pool peak "
            f"{runners[label].executor.last_peak_bytes / 2**30:.2f} GiB")
        missing = [k for k in required[label]
                   if not any(launches[label].get(a, 0) for a in k.split("|"))]
        if missing:
            raise AssertionError(f"{label}: kernels of its path not launched: {missing}")


def check_rows(label, got, ref, may_be_empty=False) -> None:
    if ref.rows != got.rows:
        raise AssertionError(f"{label}: card rows {got.rows} != CPU rows {ref.rows}")
    if not got.rows and not may_be_empty:
        raise AssertionError(f"{label}: no rows")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpcds import Tpcds
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.kernels import build
    from presto_tpu_torch.runner import QueryRunner

    t_all = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; {name}")

    # phase 2 runs beside the host-side data generation
    build_err = []

    def do_build():
        try:
            build.build_all()
        except Exception as e:  # reported on the main thread
            build_err.append(e)

    t0 = time.perf_counter()
    build_thread = threading.Thread(target=do_build)
    build_thread.start()
    host, host_check, host_ds = (MemoryConnector(device="cpu") for _ in range(3))
    for conn, sf in ((host, SF), (host_check, TPCH_CHECK_SF)):
        tpch = Tpch(sf=sf, split_rows=SPLIT_ROWS)
        for table, columns in TABLES.items():
            conn.load_from(tpch, table, columns=columns)
    ds_cols = ds_tables()
    tpcds = Tpcds(sf=DS_SF, split_rows=DS_SPLIT_ROWS)
    for table, columns in ds_cols.items():
        host_ds.load_from(tpcds, table, columns=columns)
    # the sixth and seventh slices' tables again at DS_CHECK_SF, for
    # their row check
    host_ds_check = MemoryConnector(device="cpu")
    ds2_cols = ds_tables({**DS2_QUERIES, **DS3_QUERIES})
    tpcds_check = Tpcds(sf=DS_CHECK_SF, split_rows=DS_SPLIT_ROWS)
    for table, columns in ds2_cols.items():
        host_ds_check.load_from(tpcds_check, table, columns=columns)
    del tpch, tpcds, tpcds_check  # the generators: only their tables stay
    gen_s = time.perf_counter() - t0
    build_thread.join()
    if build_err:
        raise build_err[0]
    build_s = time.perf_counter() - t0
    for kname in build.KERNELS:
        log(f"--- ptxas {kname}\n{build.ptxas_report.get(kname, '(cached build)').strip()}")
    lineitem_rows = host.row_count("lineitem")
    log(f"sf={SF}: " + ", ".join(f"{t} {host.row_count(t)} rows in {host.num_splits(t)} "
                                 f"splits" for t in TABLES))
    log(f"TPC-DS sf={DS_SF}: " + ", ".join(
        f"{t} {host_ds.row_count(t)} rows in {host_ds.num_splits(t)} splits" for t in ds_cols)
        + f"; TPC-DS sf={DS_CHECK_SF} (the sixth and seventh slices' check): " + ", ".join(
        f"{t} {host_ds_check.row_count(t)} rows" for t in ds2_cols)
        + f"; generated in {gen_s:.1f} s; kernels built by {build_s:.1f} s")

    mem, mem_check, mem_ds, mem_ds_check = (MemoryConnector(device="cuda") for _ in range(4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for conn, src, tables in ((mem, host, TABLES), (mem_check, host_check, TABLES),
                              (mem_ds, host_ds, ds_cols),
                              (mem_ds_check, host_ds_check, ds2_cols)):
        for table in tables:
            conn.load_from(src, table)
    torch.cuda.synchronize()
    log(f"tables on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # the SF10 TPC-H tables live on the card from here on: their host
    # copy leaves, for the CPU row checks' room (the machine has 96 GiB)
    del host
    release_host_memory()
    torch.cuda.reset_peak_memory_stats()
    catalog = Catalog()
    catalog.register("tpch", mem)
    runner = QueryRunner(catalog, device="cuda")
    # each query over the columns it names, on the same tensors
    ordered = {label: streamed_tables(runner.plan(sql)) for label, sql in QUERIES.items()}
    runners = {label: QueryRunner(query_catalog(mem, sql, ordered[label]), device="cuda")
               for label, sql in QUERIES.items()}
    ds_runners = {label: QueryRunner(query_catalog(mem_ds, sql, tables=ds_cols, name="tpcds"),
                                     device="cuda") for label, sql in DS_QUERIES.items()}
    ds2_runners = {label: QueryRunner(query_catalog(mem_ds, sql, tables=ds_cols, name="tpcds"),
                                      device="cuda") for label, sql in DS2_QUERIES.items()}
    ds3_runners = {label: QueryRunner(query_catalog(mem_ds, sql, tables=ds_cols, name="tpcds"),
                                      device="cuda") for label, sql in DS3_QUERIES.items()
                   if label not in DS3_SCALE}
    ds3_required = {label: plan_required(r.plan(DS3_QUERIES[label]))
                    for label, r in ds3_runners.items()}

    report = KernelReport()
    check_kernels(report, runner, mem)
    check_join_kernels(report, runners)
    check_slice_kernels(report, runners)
    check_aggregation_kernels(report, runners)
    check_window_kernels(report, ds_runners, mem_ds)
    check_sixth_slice_kernels(report, ds2_runners, mem_ds)
    check_spill_kernels(report, mem, mem_ds)
    check_function_kernels(report, mem)
    check_tail_kernels(report, mem)
    check_container_kernels(report, mem)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"phase 3 done at {time.perf_counter() - t_all:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # phase 4: the main path, each query counted on its own, then timed
    # and traced; TPC-H's SF10 tables leave the card before TPC-DS runs
    from presto_tpu_torch.planner.plan import TableScanNode

    results, wall, launches, scans, spill_wall = {}, {}, {}, {}, {}

    def drive(rs, queries, required, reps=REPS, trace=True):
        run_counted(rs, queries, required, launches, results, wall)
        for label, sql in queries.items():
            for _ in range(reps):
                t0 = time.perf_counter()
                rs[label].execute(sql)
                wall[label].append(time.perf_counter() - t0)
        for label, sql in queries.items():
            if trace:
                log(f"{label} trace: {profile_query(rs[label], sql)}")
            scans[label] = {n.handle.table for n in find_all(rs[label].plan(sql),
                                                               TableScanNode)}

    drive(runners, QUERIES, REQUIRED)
    # the functions phase over the same SF10 tables
    fn_runners = {label: QueryRunner(query_catalog(mem, sql), device="cuda")
                  for label, sql in FN_QUERIES.items()}
    drive(fn_runners, FN_QUERIES, FN_REQUIRED, reps=2, trace=False)
    del fn_runners
    log(f"functions phase done at {time.perf_counter() - t_all:.1f} s")
    # the dates, string tables and aggregate tail over the same tables
    dt_runners = {label: QueryRunner(query_catalog(mem, sql), device="cuda")
                  for label, sql in DT_QUERIES.items()}
    drive(dt_runners, DT_QUERIES, DT_REQUIRED, reps=2, trace=False)
    del dt_runners
    log(f"dates and aggregate tail phase done at {time.perf_counter() - t_all:.1f} s")
    # the containers phase over the same tables (split's parts table over
    # p_name's dictionary was built, and timed, in phase 3)
    ct_runners = {label: QueryRunner(query_catalog(mem, sql), device="cuda")
                  for label, sql in CT_QUERIES.items()}
    drive(ct_runners, CT_QUERIES, CT_REQUIRED, reps=2, trace=False)
    del ct_runners
    gc.collect()
    torch.cuda.empty_cache()
    log(f"containers phase done at {time.perf_counter() - t_all:.1f} s")
    # the spill phase over the same SF10 tables, before they leave
    run_spill_phase(mem, launches, spill_wall)
    log(f"spill phase done at {time.perf_counter() - t_all:.1f} s")
    del runner, runners, catalog, mem
    gc.collect()
    torch.cuda.empty_cache()
    drive(ds_runners, DS_QUERIES, DS_REQUIRED)
    drive(ds2_runners, DS2_QUERIES, DS2_REQUIRED)
    # the seventh slice's 49: counted and timed once more, untraced
    drive(ds3_runners, {k: v for k, v in DS3_QUERIES.items() if k not in DS3_SCALE},
          ds3_required, reps=1, trace=False)
    # the queries cut in scale, with the SF10 tables off the card: each
    # at its scale, then its check scale's tables stay for the row check
    del ds_runners, ds2_runners, ds3_runners, mem_ds
    gc.collect()
    torch.cuda.empty_cache()
    scaled_checks = {}
    for label, (sf, check_sf) in DS3_SCALE.items():
        sql = DS3_QUERIES[label]
        cols = ds_tables({label: sql})
        conns = {}
        for scale in (sf, check_sf):
            h, m = MemoryConnector(device="cpu"), MemoryConnector(device="cuda")
            gen = Tpcds(sf=scale, split_rows=DS_SPLIT_ROWS)
            for table, columns in cols.items():
                h.load_from(gen, table, columns=columns)
                m.load_from(h, table)
            conns[scale] = (h, m)
        rs = {label: QueryRunner(query_catalog(conns[sf][1], sql, tables=cols, name="tpcds"),
                                 device="cuda")}
        drive(rs, {label: sql}, {label: plan_required(rs[label].plan(sql))}, reps=1,
              trace=False)
        log(f"{label} ran at sf={sf} (does not fit the card at sf={DS_SF}); its rows are "
            f"checked at sf={check_sf}")
        scaled_checks[label] = (sql, cols, conns[check_sf])
        del rs, conns
        gc.collect()
        torch.cuda.empty_cache()
    for row in report.rows.values():
        kname = report.counters.get(row["name"], row["name"].split("@")[0])
        row["launches_by_query"] = {q: launches[q].get(kname, 0) for q in launches}
        row["launches"] = sum(row["launches_by_query"].values())

    # the rows against the port's CPU run over the same generated pages
    # (each query over its columns): TPC-H at TPCH_CHECK_SF, where the
    # card runs the 22 queries again (and a query's variant where it
    # finds no row); TPC-DS at DS_SF, the rows of the counted run
    t0 = time.perf_counter()
    variants = empty_variants(TPCH_CHECK_SF)
    cat_check = Catalog()
    cat_check.register("tpch", mem_check)
    ordered_check = {label: streamed_tables(QueryRunner(cat_check, device="cuda").plan(sql))
                     for label, sql in QUERIES.items()}
    checks = {}  # label -> (sql, ordered tables, may find no row)
    for label, sql in QUERIES.items():
        checks[label] = (sql, ordered_check[label], label in variants)
        if variants.get(label, sql) != sql:
            checks[f"{label}_variant"] = (variants[label], (), False)
    for label, (sql, ordr, may_be_empty) in checks.items():
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_check, sql, ordr), device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_check, sql, ordr), device="cpu").execute(sql)
        check_rows(f"{label} at sf={TPCH_CHECK_SF}", got, ref, may_be_empty)
        log(f"{label} at sf={TPCH_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    for label, sql in {**FN_QUERIES, **DT_QUERIES, **CT_QUERIES}.items():
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_check, sql), device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_check, sql), device="cpu").execute(sql)
        check_fn_rows(label, got, ref, f" at sf={TPCH_CHECK_SF}")
        log(f"{label} at sf={TPCH_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    # the host's tables leave as their checks end: the CPU runs of the
    # TPC-DS checks need the room (q47's at SF10 most)
    del host_check, mem_check, cat_check
    release_host_memory()
    # the sixth and seventh slices at DS_CHECK_SF: the card runs their
    # queries again over those tables, the CPU once
    for label, sql in {**DS2_QUERIES, **DS3_QUERIES}.items():
        if label in DS3_SCALE or label in DS3_CHECK_AT_DS_SF:
            continue
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_ds_check, sql, tables=ds2_cols, name="tpcds"),
                          device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_ds_check, sql, tables=ds2_cols, name="tpcds"),
                          device="cpu").execute(sql)
        check_rows(f"{label} at sf={DS_CHECK_SF}", got, ref,
                   label in DS2_EMPTY_AT_CHECK + DS3_EMPTY_AT_CHECK)
        log(f"{label} at sf={DS_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    del host_ds_check, mem_ds_check
    for label, (sql, cols, (h, m)) in scaled_checks.items():
        t1 = time.perf_counter()
        check_sf = DS3_SCALE[label][1]
        got = QueryRunner(query_catalog(m, sql, tables=cols, name="tpcds"),
                          device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(h, sql, tables=cols, name="tpcds"),
                          device="cpu").execute(sql)
        check_rows(f"{label} at sf={check_sf}", got, ref)
        log(f"{label} at sf={check_sf}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    del scaled_checks
    gc.collect()
    torch.cuda.empty_cache()
    for label, sql in {**DS_QUERIES, **{q: DS3_QUERIES[q] for q in DS3_CHECK_AT_DS_SF}}.items():
        t1 = time.perf_counter()
        ref = QueryRunner(query_catalog(host_ds, sql, tables=ds_cols, name="tpcds"),
                          device="cpu").execute(sql)
        check_rows(label, results[label], ref)
        log(f"{label}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s on the CPU)")
    log(f"rows equal the CPU run ({time.perf_counter() - t0:.1f} s)")
    for label in list(QUERIES) + list(FN_QUERIES) + list(DT_QUERIES) + list(CT_QUERIES) \
            + list(DS_QUERIES) + list(DS2_QUERIES) + list(DS3_QUERIES):
        med = statistics.median(wall[label])
        fact, rows = ("lineitem", lineitem_rows) if label in QUERIES or label in FN_QUERIES \
            or label in DT_QUERIES or label in CT_QUERIES else (
            "store_sales", host_ds.row_count("store_sales"))
        rate = f", {rows / med / 1e6:.1f} M {fact} rows/s" if fact in scans[label] else ""
        shown = results[label].rows
        log(f"{label}: {len(shown)} rows: {shown[:5]}{' ...' if len(shown) > 5 else ''}")
        log(f"{label}: wall {med * 1e3:.2f} ms median of {len(wall[label])} "
            f"({', '.join(f'{w * 1e3:.2f}' for w in wall[label])}){rate}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": list(report.rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
