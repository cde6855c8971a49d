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
   sorted_group_agg (Q3's partial over that probe output, timed also in
   three parts, pack and compaction, the sort of the live keys and K6's
   own kernels; the same with its runs ``(order, starts)``; and its merge
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
   partials; and the eleventh slice's (``check_type_kernels``): K1's
   cast to REAL (F32R), REAL arithmetic, CASTN to SMALLINT and IN over a
   double (DIN), K9 over TINYINT and SMALLINT keys, K2's REAL, SMALLINT
   and interval states and its global double sum of a REAL, K3's fold
   and finalize of them, K6's REAL and SMALLINT states by l_suppkey, K7
   with a REAL key and K10's running REAL sum over orders, K7's top 100
   of a lineitem split by l_returnflag descending then l_orderkey
   (millions of rows tie on the flag), REALs bit for bit, and the sorted
   top 1000 past K7's 100 rows (``torch.sort``, a log line: no kernel of
   its own); and the twelfth slice's
   (``check_sketch_kernels``): K15 group_topn over a lineitem split by
   l_suppkey and by the two flags and its merge of two splits' lanes,
   K1's digest hash, K16 kmv_lanes by l_shipmode and its merge, K14's
   wide value half and map_union over the sk queries' inner pages, and
   K12's hll_card, kmv_card and sd_pair over their sketches; and the
   thirteenth slice's (``check_decimal38_kernels``) over lineitem splits
   with l_quantity and l_extendedprice as decimal(38,2): K1's five-limb
   instance (the cast S2D38, Q1's wide x short product, Q6's wide
   compare as a filter, the up-scale to decimal(38,18), the double, the
   narrowing to bigint), K2's wide sum, min and max by Q1's flags, K3's
   fold and wide finalizes, K6's wide states by l_suppkey and their
   merge, K7's top 100 by the merged wide revenue; and the fifteenth
   slice's (``check_ml_geo_kernels``): K18 geo_contains over a 2^23-row
   trips split with a 1024-vertex literal and over geo_join's 68.9M
   (zone, trip) rows by code, K19 ml_state's partials (packed-direct,
   sort path, evaluate) and merge, K20 ml_finalize, K12's REGRESS and
   CLASSIFY (the class off the near ties, the log-likelihood within 2
   ulp); and the sixteenth slice's (``check_mesh_kernels``): K21
   exchange_partition over a whole lineitem split keyed by l_orderkey
   into 8 parts, every column, at a bucket_cap of the fill and of half
   of it, and K22 merge_sorted over two of ``DIST_ORDER_SQL``'s
   per-shard sorted runs;
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
   the lambdas over the aggregated arrays); the types phase over the
   same tables (``TY_QUERIES``: Q1's aggregates over REALs, REAL
   extremes and sums by l_suppkey, SMALLINT and TINYINT keys, a shipping
   delay as intervals, IN over a double, a top 1000, a REAL top 100, a
   running REAL sum per customer); the sketch phase over the same
   tables, traced (``SK_QUERIES``: max/min(x, 5) per supplier,
   max_by/min_by(x, y, n) by the two flags, approx_set with
   cardinality and merge, set digests per ship mode, jaccard_index and
   intersection_cardinality, multimap_agg, map_union); the wide
   decimals phase, traced (``D38_QUERIES`` over ``lineitem_d38``, built
   on the card from lineitem's splits by the port's casts and freed
   after the phase: Q1 and Q6 over the wide columns, revenue per
   supplier with its top 100, Spark's decimal(38,18), the casts out,
   CASE/abs/coalesce/greatest, a 38-digit literal with a top 1000, the
   join with orders); the raw varchar phase, traced (``RAW_QUERIES``);
   the ML and geospatial phase, traced (``ML_GEO_QUERIES``: regressors
   by the two flags and by supplier, a classifier by ship mode, its
   evaluation and a regression over lineitem cross-joined with their
   models; a point-in-polygon count over 2^24 trips, a spatial join of
   263 zones with 2^18 trips, areas, a nearest-100; the zones and trips
   generated from ``GEO_SEED`` and freed after the phase; ml_regressor
   timed again with its ML states forced onto the sort path,
   ``ml_path_walls``); the distributed phase, after the spill phase,
   over the same tables (``DIST_QUERIES`` through ``QueryRunner`` under ``SET
   SESSION distributed = true`` on 8 shards of the card: q6, q1, q14
   and q3 with broadcast joins, q3 and q9 with every join FIXED_HASH,
   an ORDER BY of ~1.1e5 lineitem rows merged from 8 sorted runs, a
   window stage and a union stage, and the ORDER BY again on the local
   runner under ``distributed_sort``; each distributed, its rows equal
   to the local port's on the card, K21 and K22 launched, each wall a
   median of 4); then (TPC-H's tables freed)
   all 99 TPC-DS queries (``tests/tpcds_queries.py``) at SF10 but q72,
   which runs at sf 0.1 (at SF10 its expansion does not fit one card),
   through ``QueryRunner.execute`` under the default memory pool, each
   over a ``MemoryConnector`` that holds only the columns its SQL names
   (the tensors on the card are shared, not copied); every kernel
   launch counter is set to 0 just before each query and read just
   after it, and the run fails unless each query launched the kernels
   of its path; each query's pool peak is printed beside the card's;
   ds_q51, whose ORDER BY reads two pages, with ``distributed_sort``
   (the runs merged on K22) and without it, interleaved
   (``merge_path_walls``);
5. check rows against the same queries run by the port on the CPU over
   the same generated data, exactly (doubles included): the fifth slice's
   TPC-DS queries but q47 and q57, and q29, at SF10 (the rows of phase
   4), TPC-H at SF 1 (the card runs the 22 queries again over the SF 1
   tables; Q22, which finds no row there, also without its anti join),
   the other TPC-DS queries, q47 and q57 among them, at SF 1 (run again
   there on the card), q72 at sf 0.01; the functions, the dates and aggregate tail, the containers,
   the types, the sketch and the wide decimals phases at SF 1 (the
   latter over lineitem_d38 built on both sides), the raw and the ML and
   geo phases at SF 1 (the point tables at 1/16), exact but for
   skewness's doubles (``FN_APPROX``: its pow, a relative 1e-12) and
   evaluate_classifier_predictions' counts (within the rows at a near
   tie of the classifier's log-likelihoods);
6. print per-query wall time, fact rows/s and a trace summary, a
   ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the ``presto_tpu`` package.
"""

from __future__ import annotations

import contextlib
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM float64 instructions a second outside the tensor cores: the
# data sheet's 34 TFLOP/s counts a fused multiply-add as two operations;
# an add, a multiply, a compare or a divide (counted as one) is one
FP64_OPS_PER_S = 34e12 / 2
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
# the fifth slice's queries whose CPU runs at DS_SF took most of the
# smoke's time (on the H100 machine's host, q47's 166.9 s and q57's
# 60.5 s of a 1270 s run): their rows are checked at DS_CHECK_SF, the
# card running them again there
DS_CHECK_AT_CHECK_SF = ("ds_q47", "ds_q57")
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


# the eleventh slice, REAL, SMALLINT, TINYINT and INTERVAL values, IN
# over a double and ORDER BY ... LIMIT past K7's 100 rows, at SF10 over
# the same resident tables, no cut (rows checked at TPCH_CHECK_SF with
# check_fn_rows): Q1's aggregates over REALs (K6: a keyed REAL sum is a
# double state), REAL min/max/sum by l_suppkey folded globally (K6,
# then K2's global double sum of REALs), SMALLINT and TINYINT keys (K9)
# and sums, a shipping delay in days (intervals) with REAL and SMALLINT
# extremes by l_shipmode and l_linenumber (K2's packed slots, K3's fold
# and finalize; an interval sum is one int64 of microseconds, as the
# reference's: by l_shipmode alone, ~8.6M rows of ~15 days pass 2^63 at
# SF10 and wrap), IN over a double, a report's top 1000 rows (the sort
# past MAX_N), a REAL top 100 (K7) and a running REAL sum per customer
# (K10)
_DELAY = "l_receiptdate - l_shipdate"
_SUPP_PRICE = "cast(l_extendedprice * (1 - l_discount) as real)"
TY_QUERIES = {
    "ty_real_q1": "select l_returnflag, l_linestatus, sum(cast(l_quantity as real)), "
                  "sum(cast(l_extendedprice as real)), sum(cast(l_extendedprice as real) * "
                  "(1 - cast(l_discount as real))), avg(cast(l_quantity as real)), "
                  "avg(cast(l_extendedprice as real)), avg(cast(l_discount as real)), "
                  "min(cast(l_tax as real)), max(cast(l_tax as real)), count(*) from lineitem "
                  "where l_shipdate <= date '1998-09-02' group by l_returnflag, l_linestatus "
                  "order by l_returnflag, l_linestatus",
    "ty_real_supplier": f"select count(*), sum(mn), sum(mx), sum(s) from (select l_suppkey, "
                        f"min({_SUPP_PRICE}) mn, max({_SUPP_PRICE}) mx, sum({_SUPP_PRICE}) s "
                        "from lineitem group by l_suppkey)",
    "ty_narrow": "select cast(l_linenumber as tinyint) ln, cast(l_quantity as smallint) q, "
                 "count(*), sum(cast(l_quantity as smallint)), min(cast(l_discount as real)), "
                 "max(cast(l_tax as real)) from lineitem group by 1, 2 order by 1, 2",
    "ty_delay": f"select l_shipmode, l_linenumber, sum({_DELAY}), avg({_DELAY}), "
                f"min({_DELAY}), max({_DELAY}), max(l_receiptdate - l_commitdate), "
                "min(cast(l_discount as real)), max(cast(l_quantity as smallint)) from lineitem "
                "group by l_shipmode, l_linenumber order by l_shipmode, l_linenumber",
    "ty_in_double": "select count(*), sum(l_extendedprice) from lineitem "
                    "where cast(l_discount as double) in (0.02e0, 0.05e0, 0.07e0)",
    "ty_top1000": "select l_orderkey, l_linenumber, l_extendedprice from lineitem "
                  "order by l_extendedprice desc, l_orderkey, l_linenumber limit 1000",
    "ty_real_top": "select o_orderkey, cast(o_totalprice as real) r from orders "
                   "order by r desc, o_orderkey limit 100",
    "ty_real_window": "select count(*), max(rs) from (select sum(cast(o_totalprice as real)) "
                      "over (partition by o_custkey order by o_orderdate, o_orderkey) rs "
                      "from orders)",
}


# the twelfth slice, the sketch and heap aggregates, at SF10 over the
# same resident tables, no cut (rows checked at TPCH_CHECK_SF with
# check_fn_rows, exact): the top 5 and bottom 5 prices of each of the
# 100k suppliers (K15 over K6's runs, merged across the 8 splits),
# max_by / min_by over the four flag groups of up to 30M rows (the
# skewed case), approx_set with cardinality and its merge (K14's
# hll_sketch, K13's UNNEST of the sketches, K12's hll_card), a set
# digest per ship mode (K1's digest hash, K16, K12's kmv_card), the
# jaccard and intersection of the AIR and RAIL suppliers' digests and
# the union of the modes' digests (K12's sd_pair, K16's merge),
# multimap_agg (K14's wide value half) and map_union (K14 over the
# input maps)
SK_QUERIES = {
    "sk_max_n": "select l_suppkey, max(l_extendedprice, 5), min(l_extendedprice, 5) "
                "from lineitem group by l_suppkey",
    "sk_by_n": "select l_returnflag, l_linestatus, max_by(l_orderkey, l_extendedprice, 10), "
               "min_by(l_orderkey, l_quantity, 3) from lineitem group by 1, 2",
    "sk_approx_set": "select o_orderpriority, cardinality(approx_set(o_custkey)) from orders "
                     "group by 1",
    "sk_hll_merge": "select cardinality(merge(s)) from (select o_orderpriority, "
                    "approx_set(o_custkey) s from orders group by 1)",
    "sk_digest": "select l_shipmode, cardinality(make_set_digest(l_partkey)) from lineitem "
                 "group by 1",
    "sk_jaccard": "select jaccard_index(a, b), intersection_cardinality(a, b), "
                  "cardinality(m) from (select make_set_digest(l_suppkey) a from lineitem "
                  "where l_shipmode = 'AIR'), (select make_set_digest(l_suppkey) b from "
                  "lineitem where l_shipmode = 'RAIL'), (select merge_set_digest(d) m from "
                  "(select l_shipmode, make_set_digest(l_suppkey) d from lineitem group by 1))",
    "sk_multimap": "select l_returnflag, multimap_agg(l_shipmode, l_linenumber) from lineitem "
                   "group by 1",
    "sk_map_union": "select l_returnflag, map_union(m) from (select l_returnflag, "
                    "l_suppkey % 50 g, map_agg(l_linenumber, l_quantity) m from lineitem "
                    "group by 1, 2) group by 1",
}


# the thirteenth slice, DECIMAL(37..38) at SF10 over ``lineitem_d38``
# (lineitem with l_quantity and l_extendedprice as decimal(38,2), five
# limbs each, resident on the card beside lineitem's other columns; no
# cut; rows checked at TPCH_CHECK_SF with check_fn_rows, exact): Q1 and
# Q6 over the wide columns (wide x short products, wide sums and avgs,
# a wide compare against a short literal), revenue, min and max per
# supplier with the top 100 by a wide key, Spark's default
# decimal(38,18) (an up-scale by 16 digits, a wide difference, a compare
# across widths), the casts out of the wide layout, CASE with negation,
# abs, coalesce and greatest, a 38-digit literal in a filter with a
# decimal(36,4) literal added and a top 1000 (the sort over five
# limbs), and the wide price through the join with orders
D38_TABLE = "lineitem_d38"
D38_COLUMNS = ("l_quantity", "l_extendedprice")
D38_QUERIES = {
    "d38_q1": "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
              "sum(l_extendedprice) as sum_base_price, "
              "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
              "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge, "
              "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
              "avg(l_discount) as avg_disc, count(*) as count_order from lineitem_d38 "
              "where l_shipdate <= date '1998-09-02' group by l_returnflag, l_linestatus "
              "order by l_returnflag, l_linestatus",
    "d38_q6": "select sum(l_extendedprice * l_discount) as revenue from lineitem_d38 "
              "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
              "and l_discount between 0.05 and 0.07 and l_quantity < 24",
    "d38_supplier_top": "select l_suppkey, sum(l_extendedprice * (1 - l_discount)) as rev, "
                        "min(l_extendedprice) as lo, max(l_extendedprice) as hi "
                        "from lineitem_d38 group by l_suppkey order by rev desc, l_suppkey "
                        "limit 100",
    "d38_spark_scale": "select l_returnflag, sum(cast(l_extendedprice as decimal(38,18)) "
                       "- cast(l_quantity as decimal(38,18))) as spread, "
                       "max(cast(l_extendedprice as decimal(38,18))) as top, count(*) as n "
                       "from lineitem_d38 where cast(l_extendedprice as decimal(38,18)) > "
                       "l_tax * 250000 group by l_returnflag order by l_returnflag",
    "d38_casts": "select l_linestatus, sum(cast(l_extendedprice as double)) as dbl, "
                 "sum(cast(l_extendedprice as decimal(12,2))) as short_sum, "
                 "sum(cast(l_quantity as bigint)) as qty, "
                 "max(cast(l_extendedprice as decimal(38,0))) as whole "
                 "from lineitem_d38 group by l_linestatus order by l_linestatus",
    "d38_case": "select l_shipmode, sum(case when l_returnflag = 'R' then -l_extendedprice "
                "else l_extendedprice end) as net, max(abs(l_quantity - l_extendedprice)) "
                "as gap, min(coalesce(l_extendedprice, l_quantity)) as first_price, "
                "max(greatest(l_extendedprice, cast(l_tax as decimal(38,2)) + 50000)) as top "
                "from lineitem_d38 group by l_shipmode order by l_shipmode",
    "d38_literal": "select l_orderkey, l_linenumber, l_extendedprice + "
                   "123456789012345678.0000 as shifted from lineitem_d38 "
                   "where l_extendedprice < 1234567890123456789012345678901234.5678 "
                   "and l_shipdate >= date '1998-06-01' "
                   "order by shifted desc, l_orderkey, l_linenumber limit 1000",
    "d38_join": "select o_orderpriority, sum(l_extendedprice) as price, "
                "max(l_extendedprice) as top, count(*) as n from lineitem_d38 "
                "join orders on l_orderkey = o_orderkey where o_orderdate >= date '1995-01-01' "
                "and o_orderdate < date '1995-04-01' group by o_orderpriority "
                "order by o_orderpriority",
}


def make_lineitem_d38(conn, name: str = D38_TABLE) -> None:
    """Register ``name`` in ``conn`` (a MemoryConnector holding
    lineitem): lineitem with ``D38_COLUMNS`` cast to decimal(38,2) by the
    port's own casts (K1's S2D38 on a card), five limbs a row each; the
    other columns are lineitem's own tensors, not copies."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import Call, ColumnRef
    from presto_tpu_torch.page import Block, Page
    from presto_tpu_torch.types import DecimalType

    wide = DecimalType(38, 2)
    schema = conn.schema("lineitem")
    cols = [c for c, _ in schema]
    pages = []
    for split in range(conn.num_splits("lineitem")):
        page = conn.page_for_split("lineitem", split)
        compiler = ExprCompiler.for_page(page)
        blocks = list(page.blocks)
        for c in D38_COLUMNS:
            i = cols.index(c)
            cast = Call(type=wide, fn="cast_decimal", args=(ColumnRef(type=schema[i][1],
                                                                      index=i),))
            data, valid = compiler.compile(cast)(page)
            blocks[i] = Block(data, valid, wide)
        pages.append(Page(tuple(blocks), page.row_mask))
    domains = {c: conn.column_domain("lineitem", c) for c in cols if c not in D38_COLUMNS}
    conn.create_table(name, [(c, wide if c in D38_COLUMNS else t) for c, t in schema], pages,
                      domains, conn.primary_key("lineitem"),
                      sort_order=conn.sort_order("lineitem"))


# the fourteenth slice: raw (non-dictionary) VARCHAR copies of TPC-H's
# per-row text at its declared widths (varchar(79), (25), (40), (15),
# (55)); the table's other columns are the source's own tensors
RAW_TABLES = {"orders_raw": ("orders", {"o_comment": 79}),
              "customer_raw": ("customer", {"c_name": 25, "c_address": 40, "c_phone": 15}),
              "part_raw": ("part", {"p_name": 55}),
              "supplier_raw": ("supplier", {"s_name": 25})}
_CNTRY = "('13', '31', '23', '29', '30', '18', '17')"
RAW_QUERIES = {
    "raw_q13": "select c_count, count(*) as custdist from (select c_custkey, "
               "count(o_orderkey) as c_count from customer left outer join orders_raw on "
               "c_custkey = o_custkey and o_comment not like '%special%requests%' "
               "group by c_custkey) as c_orders group by c_count "
               "order by custdist desc, c_count desc",
    "raw_q9": "select nation, o_year, sum(amount) as sum_profit from (select n_name as nation, "
              "extract(year from o_orderdate) as o_year, l_extendedprice * (1 - l_discount) "
              "- ps_supplycost * l_quantity as amount from part_raw, supplier, lineitem, "
              "partsupp, orders, nation where s_suppkey = l_suppkey and ps_suppkey = l_suppkey "
              "and ps_partkey = l_partkey and p_partkey = l_partkey and o_orderkey = l_orderkey "
              "and s_nationkey = n_nationkey and p_name like '%green%') as profit "
              "group by nation, o_year order by nation, o_year desc",
    "raw_q10": "select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue, "
               "c_acctbal, n_name, c_address, c_phone from customer_raw, orders, lineitem, "
               "nation where c_custkey = o_custkey and l_orderkey = o_orderkey "
               "and o_orderdate >= date '1993-10-01' "
               "and o_orderdate < date '1993-10-01' + interval '3' month "
               "and l_returnflag = 'R' and c_nationkey = n_nationkey "
               "group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address "
               "order by revenue desc, c_custkey limit 20",
    "raw_q22": "select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal from ("
               "select substring(c_phone from 1 for 2) as cntrycode, c_acctbal "
               "from customer_raw where substring(c_phone from 1 for 2) in " + _CNTRY +
               " and c_acctbal > (select avg(c_acctbal) from customer_raw "
               "where c_acctbal > 0.00 and substring(c_phone from 1 for 2) in " + _CNTRY +
               ")) as custsale group by cntrycode order by cntrycode",
    "raw_q20": "select s_name, s_address from supplier_raw, nation where s_suppkey in ("
               "select ps_suppkey from partsupp where ps_partkey in (select p_partkey "
               "from part_raw where p_name like 'forest%') and ps_availqty > (select 0.5 * "
               "sum(l_quantity) from lineitem where l_partkey = ps_partkey "
               "and l_suppkey = ps_suppkey and l_shipdate >= date '1994-01-01' "
               "and l_shipdate < date '1994-01-01' + interval '1' year)) "
               "and s_nationkey = n_nationkey and n_name = 'CANADA' order by s_name",
    "raw_extremes": "select c_nationkey, min(c_phone) as lo_phone, max(c_name) as hi_name, "
                    "min(c_address) as lo_address, count(distinct c_address) as addresses "
                    "from customer_raw group by c_nationkey order by c_nationkey",
    "raw_order": "select c_custkey, c_address from customer_raw order by c_address limit 100",
    "raw_order_sorted": "select c_custkey, c_name from customer_raw order by c_name desc "
                        "limit 1000",
    "raw_functions": "select c_custkey, upper(c_name) || ' / ' || c_phone as tag, "
                     "length(c_address) as len, strpos(c_address, 'a') as pos, "
                     "codepoint(c_name) as cp, ends_with(c_address, 'e') as tail, "
                     "starts_with(c_phone, '1') as one, case when c_acctbal > 0 then c_name "
                     "else 'in debt' end as who, coalesce(nullif(c_phone, '10-100-100-1000'), "
                     "'none') as phone from customer_raw order by c_custkey limit 100",
    "raw_join": "select count(*) as pairs, count_if(a.c_custkey <> b.c_custkey) as shared "
                "from customer_raw a join customer_raw b on a.c_phone = b.c_phone",
    "raw_window": "select c_custkey, c_phone, rank() over (partition by c_nationkey "
                  "order by c_phone) as r from customer_raw order by c_custkey limit 100",
}
# what each raw query must launch (K17's modes by name)
_K17 = "raw_string_eval:"
RAW_REQUIRED = {
    "raw_q13": (_K17 + "like", "join_build", "sorted_group_agg|packed_group_agg"),
    "raw_q9": (_K17 + "like", "join_build", "sorted_group_agg|packed_group_agg"),
    "raw_q10": (_K17 + "hash", "sorted_group_agg", "topn"),
    "raw_q22": (_K17 + "substr", _K17 + "in", _K17 + "hash", "sorted_group_agg"),
    "raw_q20": (_K17 + "like", _K17 + "pack", "join_build"),
    "raw_extremes": ("packed_group_agg:lanes", "sorted_group_agg:lanes", _K17 + "hash",
                     _K17 + "pack", _K17 + "unpack"),
    "raw_order": ("topn:lanes", _K17 + "pack"),
    "raw_order_sorted": ("topn:sorted", _K17 + "pack"),
    "raw_functions": (_K17 + "case_map", _K17 + "concat", _K17 + "len", _K17 + "strpos",
                      _K17 + "codepoint", _K17 + "suffix", _K17 + "prefix", _K17 + "select",
                      _K17 + "cmp", "topn"),
    "raw_join": (_K17 + "hash", "join_build"),
    "raw_window": ("window_eval:lanes", _K17 + "pack", "window_eval"),
}


def make_raw_tables(conn) -> None:
    """Register ``RAW_TABLES`` in ``conn`` (a MemoryConnector holding their
    sources): each text column's dictionary values encoded once on the
    host (``encode_strings``), then each row's bytes gathered by its code
    on the connector's device."""
    from presto_tpu_torch.ops.rawstring import encode_strings
    from presto_tpu_torch.page import Block, Page
    from presto_tpu_torch.types import VarcharType

    for name, (src, widths) in RAW_TABLES.items():
        schema = conn.schema(src)
        cols = [c for c, _ in schema]
        encoded = {}  # (column, id(dictionary)) -> its values' byte rows
        pages = []
        for split in range(conn.num_splits(src)):
            page = conn.page_for_split(src, split)
            blocks = list(page.blocks)
            for c, w in widths.items():
                b = blocks[cols.index(c)]
                key = (c, id(b.dictionary))
                if key not in encoded:
                    encoded[key] = torch.from_numpy(
                        encode_strings(list(b.dictionary.values), w)).to(conn.device)
                table = encoded[key]
                codes = torch.clamp(b.data.to(torch.int64), 0, table.shape[0] - 1)
                blocks[cols.index(c)] = Block(table[codes], b.valid, VarcharType(w, raw=True))
            pages.append(Page(tuple(blocks), page.row_mask))
        domains = {c: conn.column_domain(src, c) for c in cols if c not in widths}
        conn.create_table(name, [(c, VarcharType(widths[c], raw=True) if c in widths else t)
                                 for c, t in schema], pages, domains, conn.primary_key(src),
                          sort_order=conn.sort_order(src))


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
TY_REQUIRED = {
    "ty_real_q1": ("expr_eval:f32r", "expr_eval:narrow", "sorted_group_agg:narrow",
                   "sorted_group_agg:double_sum", "packed_fold_finalize:narrow"),
    "ty_real_supplier": ("expr_eval:f32r", "sorted_group_agg:narrow",
                         "packed_group_agg:narrow", "packed_group_agg:double_sum",
                         "packed_fold_finalize"),
    "ty_narrow": ("expr_eval:castn", "hash_keys:narrow", "sorted_group_agg:narrow",
                  "packed_fold_finalize:narrow"),
    "ty_delay": ("expr_eval:narrow", "packed_group_agg:narrow", "packed_fold_finalize:narrow"),
    "ty_in_double": ("expr_eval:din", "packed_group_agg"),
    "ty_top1000": ("topn:sorted",),
    "ty_real_top": ("topn:real", "expr_eval:f32r"),
    "ty_real_window": ("window_eval:narrow", "expr_eval:f32r"),
}
SK_REQUIRED = {
    "sk_max_n": ("sorted_group_agg", "group_topn", "group_topn:merge"),
    "sk_by_n": ("sorted_group_agg", "group_topn", "group_topn:merge"),
    "sk_approx_set": ("expr_eval:hll", "group_collect", "container_eval:hll_card"),
    "sk_hll_merge": ("group_collect", "unnest_expand", "container_eval:hll_card"),
    "sk_digest": ("expr_eval:digest_hash", "kmv_lanes", "kmv_lanes:merge",
                  "container_eval:kmv_card"),
    "sk_jaccard": ("kmv_lanes", "kmv_lanes:merge", "container_eval:sd_pair",
                   "container_eval:kmv_card"),
    "sk_multimap": ("group_collect", "group_collect:wide"),
    "sk_map_union": ("group_collect", "group_collect:union"),
}
# the fifteenth slice: the ML aggregates over the resident lineitem, and
# the geospatial functions over generated zones and trips
_FEATS = "features(l_quantity, l_discount, l_tax)"
ML_QUERIES = {
    "ml_regressor": f"select l_returnflag, l_linestatus, learn_regressor(l_extendedprice, "
                    f"{_FEATS}) as m, count(*) as n from lineitem group by l_returnflag, "
                    "l_linestatus order by l_returnflag, l_linestatus",
    # 100k models, reduced on the card: their count and first weights' sum
    "ml_regressor_supp": "select count(*) as suppliers, sum(m[1]) as w_quantity from ("
                         f"select l_suppkey, learn_regressor(l_extendedprice, {_FEATS}) as m "
                         "from lineitem group by l_suppkey) t",
    "ml_classifier": f"select l_shipmode, learn_classifier(l_linenumber - 1, {_FEATS}) as m "
                     "from lineitem group by l_shipmode order by l_shipmode",
    "ml_evaluate": f"select evaluate_classifier_predictions(l_linenumber - 1, classify(m, "
                   f"{_FEATS})) as summary from lineitem cross join (select "
                   f"learn_classifier(l_linenumber - 1, {_FEATS}) as m from lineitem) t",
    "ml_regress": f"select l_returnflag, avg(regress(m, {_FEATS})) as fit from lineitem "
                  f"cross join (select learn_regressor(l_extendedprice, {_FEATS}) as m "
                  "from lineitem) t group by l_returnflag order by l_returnflag",
}
# the zones and trips: the shape of the NYC TLC trip records against the
# city's 263 taxi zones (generated from GEO_SEED, nothing downloaded)
GEO_SEED = 263
GEO_ZONES = 263
GEO_TRIPS = 1 << 24
GEO_SAMPLE = 1 << 18
GEO_CHECK_DIV = 16  # the row check's point tables: 1/16 of each
GEO_TABLES = {"zones": ["zid", "geom"], "trips": ["tid", "x", "y"],
              "trips_sample": ["tid", "x", "y"]}


def _star_ring(rng, cx, cy, r, nv):
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, nv))
    rad = r * rng.uniform(0.6, 1.0, nv)
    pts = [(float(cx + a * np.cos(t)), float(cy + a * np.sin(t))) for a, t in zip(rad, ang)]
    return "(" + ", ".join(f"{x!r} {y!r}" for x, y in pts + pts[:1]) + ")"


def geo_polygon(seed: int = GEO_SEED, nv: int = 1024) -> str:
    """geo_contains' literal: a star polygon of ``nv`` vertices around
    the extent's centre."""
    rng = np.random.default_rng(seed + 1)
    return "POLYGON (" + _star_ring(rng, 50.0, 50.0, 30.0, nv) + ")"


def geo_zones(seed: int = GEO_SEED, zones: int = GEO_ZONES) -> list:
    """The zones' WKT: star polygons of 64 to 512 vertices on a jittered
    17 x 16 grid over the 100 x 100 extent, one in eight with a hole,
    two of them MULTIPOLYGONs of two parts (the first ``zones``)."""
    rng = np.random.default_rng(seed)
    out = []
    for z in range(zones):
        cx = 3.0 + 94.0 * (z % 17 + rng.uniform(0.2, 0.8)) / 17
        cy = 3.0 + 94.0 * (z // 17 + rng.uniform(0.2, 0.8)) / 16
        r = rng.uniform(2.0, 3.2)
        shell = _star_ring(rng, cx, cy, r, int(rng.integers(64, 513)))
        if z % 8 == 3:  # a hole, inside every star's inner radius
            ang = np.linspace(0.0, 2 * np.pi, 9)[:-1]
            pts = [(float(cx + 0.3 * r * np.cos(t)), float(cy + 0.3 * r * np.sin(t)))
                   for t in ang]
            hole = "(" + ", ".join(f"{x!r} {y!r}" for x, y in pts + pts[:1]) + ")"
            out.append(f"POLYGON ({shell}, {hole})")
        elif z in (40, 200):  # a second part beside the first
            part = _star_ring(rng, cx + 0.8 * r, cy + 0.8 * r, 0.5 * r, 64)
            out.append(f"MULTIPOLYGON (({shell}), ({part}))")
        else:
            out.append(f"POLYGON ({shell})")
    return out


GEO_QUERIES = {
    "geo_contains": "select count(*) as inside from trips where ST_Contains("
                    f"ST_GeometryFromText('{geo_polygon()}'), ST_Point(x, y))",
    "geo_join": "select zid, count(*) as trips from zones, trips_sample "
                "where ST_Contains(geom, ST_Point(x, y)) group by zid order by zid",
    "geo_area": "select zid % 10 as bucket, sum(ST_Area(geom)) as area, count(*) as zones "
                "from zones group by zid % 10 order by bucket",
    "geo_nearest": "select tid, ST_Distance(ST_Point(x, y), ST_Point(50, 50)) as d "
                   "from trips order by d, tid limit 100",
}
ML_GEO_QUERIES = {**ML_QUERIES, **GEO_QUERIES}
_K19 = "ml_state:"
ML_GEO_REQUIRED = {
    "ml_regressor": (_K19 + "regressor", _K19 + "merge", "ml_finalize:regressor",
                     "container_eval:construct", "packed_group_agg"),
    "ml_regressor_supp": (_K19 + "regressor", _K19 + "merge", "ml_finalize:regressor",
                          "sorted_group_agg", "container_eval:subscript"),
    "ml_classifier": (_K19 + "classifier", _K19 + "merge", "ml_finalize:classifier"),
    "ml_evaluate": (_K19 + "classifier", "ml_finalize:classifier", "container_eval:classify",
                    _K19 + "evaluate", _K19 + "merge_i64"),
    "ml_regress": (_K19 + "regressor", "ml_finalize:regressor", "container_eval:regress",
                   "packed_group_agg|sorted_group_agg"),
    "geo_contains": ("geo_contains", "packed_group_agg"),
    "geo_join": ("geo_contains:column", "expr_eval", "packed_group_agg|sorted_group_agg"),
    "geo_area": ("expr_eval:dvlut", "packed_group_agg|sorted_group_agg"),
    "geo_nearest": ("expr_eval:dun", "expr_eval:dmul", "topn"),
}


# the sixteenth slice: the mesh tier over DIST_SHARDS shards of the card
# (hash_partition_count; the reference tests' 8-device mesh), each
# query through QueryRunner under SET SESSION distributed = true,
# checked against the local port's rows on the card at SF10
DIST_SHARDS = 8
# ~1.1e5 lineitem rows at SF10 in a total order: eight sorted runs (one
# a shard of the wave over lineitem's eight splits) merged on K22
DIST_ORDER_SQL = ("select l_orderkey, l_linenumber, l_extendedprice, l_shipdate from lineitem "
                  "where l_quantity = 1 and l_discount = 0.05 "
                  "order by l_extendedprice desc, l_orderkey, l_linenumber")
DIST_QUERIES = {
    "dist_q6": (SQL[6], "AUTOMATIC"),
    "dist_q1": (SQL[1], "AUTOMATIC"),
    # the builds replicated to every shard (BROADCAST)
    "dist_q14": (SQL[14], "BROADCAST"),
    "dist_q3": (SQL[3], "BROADCAST"),
    # every join FIXED_HASH: sharded builds, the probe rows exchanged on
    # the join key inside the wave (K21)
    "dist_q3_fixed_hash": (SQL[3], "PARTITIONED"),
    "dist_q9_fixed_hash": (SQL[9], "PARTITIONED"),
    "dist_order": (DIST_ORDER_SQL, "AUTOMATIC"),
    # a window stage (rows routed to shards by o_custkey, K11, then
    # K10 a shard) under an aggregation stage
    "dist_window": ("select count(*), sum(r), max(s), min(c) from (select o_custkey c, "
                    "rank() over (partition by o_custkey order by o_totalprice desc, "
                    "o_orderkey) r, sum(o_totalprice) over (partition by o_custkey) s "
                    "from orders)", "AUTOMATIC"),
    # a union stage (two legs into one exchange) under an aggregation stage
    "dist_union": ("select count(*), sum(k), min(k), max(k) from (select o_orderkey k "
                   "from orders where o_orderstatus = 'F' union all select l_orderkey k "
                   "from lineitem where l_linenumber = 7)", "AUTOMATIC"),
}
# the local port's run each mesh query's rows must equal: the main
# path's counted SF10 run, or a local run in the phase
DIST_LOCAL = {"dist_q6": "q6", "dist_q1": "q1", "dist_q14": "q14", "dist_q3": "q3",
              "dist_q3_fixed_hash": "q3", "dist_q9_fixed_hash": "q9"}
DIST_REQUIRED = {
    "dist_q6": ("expr_eval", "packed_group_agg", "packed_fold_finalize"),
    "dist_q1": ("packed_group_agg", "exchange_partition", "sorted_group_agg"),
    "dist_q14": ("join_build", "join_probe"),
    "dist_q3": ("join_probe", "exchange_partition", "sorted_group_agg", "topn"),
    "dist_q3_fixed_hash": ("exchange_partition", "join_build", "join_probe"),
    "dist_q9_fixed_hash": ("exchange_partition", "join_build", "join_probe|join_expand"),
    "dist_order": ("merge_sorted",),
    "dist_window": ("spill_partition", "window_eval"),
    "dist_union": ("expr_eval", "packed_group_agg"),
    # the local runner's ORDER BY under distributed_sort
    "local_sort": ("merge_sorted",),
}


def geo_points(div: int = 1) -> np.ndarray:
    """The trips' (2, n) coordinates, uniform over the extent, for
    ``GEO_TRIPS // div`` trips (``trips_sample`` is their first rows)."""
    return np.random.default_rng(GEO_SEED + 2).uniform(0.0, 100.0, (2, GEO_TRIPS // div))


def make_geo_tables(conn, div: int = 1, zones: int = GEO_ZONES) -> None:
    """Register ``zones`` (zid, geom: a dictionary varchar of WKT),
    ``trips`` (tid, x, y: points uniform over the extent) and
    ``trips_sample`` (its first rows) in ``conn``, the point tables cut
    to 1/``div`` of their rows; the points are made in bulk from the seed
    on the host and moved to the connector's device."""
    from presto_tpu_torch.page import Block, Dictionary, Page
    from presto_tpu_torch.types import BIGINT, DOUBLE, VARCHAR

    dev = conn.device
    live = torch.ones(zones, dtype=torch.bool, device=dev)
    page = Page((Block(torch.arange(1, zones + 1, dtype=torch.int64, device=dev), live, BIGINT),
                 Block(torch.arange(zones, dtype=torch.int32, device=dev), live, VARCHAR,
                       Dictionary(geo_zones(zones=zones)))), live)
    conn.create_table("zones", [("zid", BIGINT), ("geom", VARCHAR)], [page],
                      {"zid": (1, zones)})
    n = GEO_TRIPS // div
    xy = torch.from_numpy(geo_points(div))
    x, y = xy[0].to(dev), xy[1].to(dev)
    tid = torch.arange(n, dtype=torch.int64, device=dev)
    for name, rows in (("trips", n), ("trips_sample", GEO_SAMPLE // div)):
        pages = []
        for lo in range(0, rows, SPLIT_ROWS):
            hi = min(rows, lo + SPLIT_ROWS)
            live = torch.ones(hi - lo, dtype=torch.bool, device=dev)
            pages.append(Page((Block(tid[lo:hi], live, BIGINT),
                               Block(x[lo:hi], live, DOUBLE), Block(y[lo:hi], live, DOUBLE)),
                              live))
        conn.create_table(name, [("tid", BIGINT), ("x", DOUBLE), ("y", DOUBLE)], pages,
                          {"tid": (0, rows - 1)})


D38_REQUIRED = {
    "d38_q1": ("expr_eval:d38mul", "packed_group_agg:d38", "packed_fold_finalize:d38"),
    "d38_q6": ("expr_eval:d38cmp", "expr_eval:d38mul", "packed_group_agg:d38",
               "packed_fold_finalize:d38"),
    "d38_supplier_top": ("expr_eval:d38mul", "sorted_group_agg:d38", "topn:d38"),
    "d38_spark_scale": ("expr_eval:d38up", "expr_eval:d38add", "expr_eval:d38cmp",
                        "packed_group_agg:d38|sorted_group_agg:d38"),
    "d38_casts": ("expr_eval:d382d", "expr_eval:d38narrow", "expr_eval:d38down",
                  "packed_group_agg:d38|sorted_group_agg:d38"),
    "d38_case": ("expr_eval:d38neg", "expr_eval:d38sign", "expr_eval:gl",
                 "packed_group_agg:d38|sorted_group_agg:d38"),
    "d38_literal": ("expr_eval:lit_d38", "expr_eval:d38cmp", "topn:sorted"),
    "d38_join": ("join_probe", "packed_group_agg:d38|sorted_group_agg:d38"),
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
    "expr_eval@cast_real": "presto_tpu/expr/compile.py:1111",
    "expr_eval@real_arith": "presto_tpu/expr/compile.py:3005",
    "expr_eval@castn": "presto_tpu/expr/compile.py:1111",
    "expr_eval@din": "presto_tpu/expr/compile.py:2952",
    "hash_keys@narrow": "presto_tpu/ops/aggregate.py:1686",
    "packed_group_agg@narrow": "presto_tpu/ops/aggregate.py:454",
    "packed_group_agg@real_sum": "presto_tpu/ops/aggregate.py:446",
    "sorted_group_agg@narrow": "presto_tpu/ops/aggregate.py:454",
    "packed_fold_finalize@narrow_fold": "presto_tpu/ops/aggregate.py:870",
    "packed_fold_finalize@narrow_finalize": "presto_tpu/ops/aggregate.py:1393",
    "topn@real": "presto_tpu/ops/sort.py:43",
    "window_eval@real": "presto_tpu/ops/window.py:343",
    "group_topn": "presto_tpu/ops/aggregate.py:1020",
    "group_topn@merge": "presto_tpu/ops/aggregate.py:1254",
    "kmv_lanes": "presto_tpu/ops/aggregate.py:944",
    "kmv_lanes@merge": "presto_tpu/ops/aggregate.py:1235",
    "expr_eval@digest_hash": "presto_tpu/ops/aggregate.py:935",
    "group_collect@wide": "presto_tpu/ops/aggregate.py:684",
    "group_collect@union": "presto_tpu/ops/aggregate.py:709",
    "container_eval@hll_card": "presto_tpu/expr/compile.py:1916",
    "container_eval@kmv_card": "presto_tpu/expr/compile.py:1940",
    "container_eval@sd_pair": "presto_tpu/expr/compile.py:1960",
    "expr_eval@d38_widen": "presto_tpu/expr/compile.py:802",
    "expr_eval@d38_mul": "presto_tpu/ops/decimal128.py:190",
    "expr_eval@d38_cmp": "presto_tpu/expr/compile.py:2654",
    "expr_eval@d38_upscale": "presto_tpu/ops/decimal128.py:216",
    "expr_eval@d38_double": "presto_tpu/ops/decimal128.py:298",
    "expr_eval@d38_narrow": "presto_tpu/expr/compile.py:3493",
    "packed_group_agg@d38": "presto_tpu/ops/aggregate.py:434",
    "packed_fold_finalize@d38_fold": "presto_tpu/ops/aggregate.py:887",
    "packed_fold_finalize@d38_finalize": "presto_tpu/ops/aggregate.py:1580",
    "sorted_group_agg@d38": "presto_tpu/ops/aggregate.py:1644",
    "sorted_group_agg@d38_merge": "presto_tpu/ops/aggregate.py:1062",
    "topn@d38": "presto_tpu/ops/sort.py:121",
    "raw_string_eval": "presto_tpu/ops/rawstring.py:65",
    "raw_string_eval@like": "presto_tpu/expr/compile.py:2842",
    "raw_string_eval@cmp": "presto_tpu/ops/rawstring.py:65",
    "raw_string_eval@in": "presto_tpu/expr/compile.py:2956",
    "raw_string_eval@substr": "presto_tpu/ops/rawstring.py:91",
    "raw_string_eval@case_map": "presto_tpu/ops/rawstring.py:111",
    "raw_string_eval@concat": "presto_tpu/ops/rawstring.py:131",
    "raw_string_eval@len": "presto_tpu/expr/compile.py:2870",
    "raw_string_eval@strpos": "presto_tpu/expr/compile.py:2870",
    "raw_string_eval@codepoint": "presto_tpu/expr/compile.py:2870",
    "raw_string_eval@prefix": "presto_tpu/expr/compile.py:2842",
    "raw_string_eval@suffix": "presto_tpu/expr/compile.py:2842",
    "raw_string_eval@pack": "presto_tpu/ops/rawstring.py:157",
    "raw_string_eval@unpack": "presto_tpu/ops/rawstring.py:177",
    "raw_string_eval@hash": "presto_tpu/ops/rawstring.py:147",
    "raw_string_eval@select": "presto_tpu/expr/compile.py:3416",
    "packed_group_agg@raw_lanes": "presto_tpu/ops/aggregate.py:1627",
    "sorted_group_agg@raw_lanes": "presto_tpu/ops/aggregate.py:1627",
    "sorted_group_agg@raw_lanes_merge": "presto_tpu/ops/aggregate.py:1085",
    "topn@raw": "presto_tpu/ops/sort.py:77",
    "window_eval@raw": "presto_tpu/ops/window.py:127",
    "geo_contains": "presto_tpu/geo.py:137",
    "geo_contains@column": "presto_tpu/expr/compile.py:1734",
    "ml_state": "presto_tpu/ops/aggregate.py:600",
    "ml_state@evaluate": "presto_tpu/ops/aggregate.py:574",
    "ml_state@merge": "presto_tpu/ops/aggregate.py:1176",
    "ml_finalize": "presto_tpu/ops/aggregate.py:1506",
    "ml_finalize@classifier": "presto_tpu/ops/aggregate.py:1517",
    "container_eval@regress": "presto_tpu/expr/compile.py:1628",
    "container_eval@classify": "presto_tpu/expr/compile.py:1663",
    "exchange_partition": "presto_tpu/parallel/exchange.py:59",
    "merge_sorted": "presto_tpu/ops/merge.py:123",
}


def release_host_memory() -> None:
    """Collect garbage and hand freed heap pages back to the system, so
    the later CPU row checks (TPC-DS's at SF10 most) find the room."""
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
            library_ms=None, counter=None, bound_ops=0):
        """``bound_ops``: the float64 operations the inputs need, where
        they may bound the kernel before its bytes do."""
        if counter is not None:
            self.counters[name] = counter
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = bound_ops / FP64_OPS_PER_S * 1e3
        self.rows[name] = {
            "name": name, "route": route, "source": source,
            "replaces": REPLACES.get(name, REPLACES[name.split("@")[0]]),
            "launches": 0, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bound_ms else "bytes",
            "library_ms": library_ms,
        }
        bound_ms = max(bound_ms, ops_ms)
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


def first_split(ex, node, split: int = 0):
    """The page the streaming chain of ``node`` produces from its first
    split (or split ``split``), as the executor runs it."""
    pages = ex._source_pages(ex._chain_leaf(node))
    for _ in range(split):
        next(pages)
    return ex._build_stage(node)(next(pages))


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


def k6_parts(label, keys, mask, states) -> None:
    """Logs K6's time over ``mask`` in three parts: the key pack and the
    compaction of the live rows (with the live count's read), the
    ``torch.sort`` of the live keys, and K6's own kernels past them (the
    whole call less the two)."""
    from presto_tpu_torch.kernels import sorted_group_agg as k6

    total = cuda_ms(lambda: k6.sorted_group_agg(keys, mask, states), 10)
    compact = cuda_ms(lambda: k6.compact_live(keys, mask), 10)
    live_keys, _, _, m = k6.compact_live(keys, mask)
    sort = cuda_ms(lambda: torch.sort(live_keys, stable=True), 10)
    log(f"{label}: K6 {total:.4f} ms = pack and compaction {compact:.4f} ms + torch.sort of "
        f"{m} live keys {sort:.4f} ms + K6's own kernels {total - compact - sort:.4f} ms "
        f"(of {mask.shape[0]} rows)")


def check_join_kernels(report: KernelReport, runners) -> None:
    """Phase 3, the joins' slice: K1's new opcodes, K4, K5, K6 (also with
    its runs, and Q3's partial timed in parts) and K7 against their plain
    versions at Q14's and Q3's shapes."""
    from presto_tpu_torch.kernels import join_build as k4
    from presto_tpu_torch.kernels import join_probe as k5
    from presto_tpu_torch.kernels import keys as pk
    from presto_tpu_torch.kernels import sorted_group_agg as k6
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
    k6_parts("q3 partial of split 0", keys, page.row_mask, states)
    # the runs (order, starts) the collecting aggregates walk: the live
    # rows' ids in key order, then the dead rows' ids in input order
    got = k6.sorted_group_agg(keys, page.row_mask, states, runs=True)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, runs=True)
    err = same((got[0], got[1], got[3]), (want[0], want[1], want[3]), "sorted_group_agg@runs")
    report.add("sorted_group_agg@runs", "cuda", src + "sorted_group_agg.cu", err,
               cuda_ms(lambda: k6.sorted_group_agg(keys, page.row_mask, states, runs=True), 5),
               cuda_ms(lambda: k6.sorted_group_agg_plain(keys, page.row_mask, states,
                                                         runs=True), 2),
               nbytes(page.row_mask, *[t for k in keys for t in k[:2]], *state_tensors(states))
               + nbytes(*[t for o in got[0] for t in o], *got[1], *got[3]))
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
    """:func:`same` with doubles and REALs compared by their bits (NaN
    and -0.0 included)."""
    def bits(x):
        if isinstance(x, torch.Tensor):
            return x.view(torch.int64) if x.dtype == torch.float64 else \
                x.view(torch.int32) if x.dtype == torch.float32 else x
        return [bits(y) for y in x]

    return same(bits(a), bits(b), what)


def k10_row(report: KernelReport, name: str, inputs, counter=None) -> None:
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
               in_bytes + nbytes(*[t for o in got for t in o]), counter=counter)
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


def check_type_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the eleventh slice, over whole 2^23-row lineitem splits
    (orders' first split for K7 and K10), each against its twin, REALs
    and doubles by their bits: K1's narrowing casts (cast to REAL of a
    decimal, F32R; to SMALLINT, CASTN), REAL arithmetic and IN over a
    double (DIN); K9 over TINYINT and SMALLINT keys; K2's REAL, SMALLINT
    and interval states by l_shipmode and its global double sum of a
    REAL; K6's REAL and SMALLINT states by l_suppkey; K3's fold of two
    splits' K2 tables and its finalize (FIN_VALUE, an interval's avg);
    K7 with a REAL key; K10's running REAL sum per customer; and the
    sorted top 1000 past K7's MAX_N beside ``torch.sort`` and a slice (a
    log line: ``torch.sort``, no kernel of its own)."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import Call, ColumnRef, Literal
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import keys as kk
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.kernels import topn as k7
    from presto_tpu_torch.ops import sort as port_sort
    from presto_tpu_torch.ops.window import WindowFunc, window_inputs
    from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, INTERVAL_DAY_SECOND, \
        parse_type

    real, smallint, tinyint = (parse_type(t) for t in ("real", "smallint", "tinyint"))
    names = [c for c, _ in mem.schema("lineitem")]
    types = dict(mem.schema("lineitem"))

    def col(c, tps=types, nms=names):
        return ColumnRef(type=tps[c], index=nms.index(c))

    def call(fn, t, *args):
        return Call(type=t, fn=fn, args=tuple(args))

    def lit(v, t):
        return Literal(type=parse_type(t), value=v)

    def lane(page, expr):
        return ExprCompiler.for_page(page).compile(expr)(page)

    pages = [mem.page_for_split("lineitem", i) for i in (0, 1)]
    page = pages[0]
    n = page.capacity
    raw = {c: page.blocks[names.index(c)] for c in ("l_extendedprice", "l_discount")}
    real_disc = call("cast_real", real, col("l_discount"))
    real_tax = call("cast_real", real, col("l_tax"))
    qty16 = call("cast_smallint", smallint, col("l_quantity"))
    delay = call("mul", INTERVAL_DAY_SECOND, call(
        "sub", BIGINT, call("cast_bigint", BIGINT, col("l_receiptdate")),
        call("cast_bigint", BIGINT, col("l_shipdate"))), lit(86_400_000_000, "bigint"))
    wanted = torch.tensor([2, 5, 7], dtype=torch.int64, device=page.device)
    # name: (expression, a filter, library call, counter)
    rows = {
        "cast_real": (call("cast_real", real, col("l_extendedprice")), False,
                      lambda: raw["l_extendedprice"].data.to(torch.float32), "f32r"),
        "real_arith": (call("mul", real, call("cast_real", real, col("l_extendedprice")),
                            call("sub", real, lit(1, "bigint"), real_disc)), False, None,
                       "f32r"),
        "castn": (qty16, False, None, "castn"),
        "din": (call("in", BOOLEAN, call("cast_double", DOUBLE, col("l_discount")),
                     lit(0.02, "double"), lit(0.05, "double"), lit(0.07, "double")), True,
                lambda: torch.isin(raw["l_discount"].data, wanted), "din"),
    }
    for label, (expr, filt, library, counter) in rows.items():
        name = f"expr_eval@{label}"
        prog, cols = ExprCompiler.for_page(page).lower(expr)
        ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
        mask = page.row_mask if filt else None
        got = k1.expr_eval(prog, ins, n, row_mask=mask)
        err = same_bits(got, k1.expr_eval_plain(prog, ins, n, row_mask=mask), name)
        report.add(name, "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err,
                   cuda_ms(lambda: k1.expr_eval(prog, ins, n, row_mask=mask), 20),
                   cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n, row_mask=mask), 3),
                   nbytes(*[t for c in ins for t in c], mask) + nbytes(
                       *(got if isinstance(got, tuple) else (got,))),
                   cuda_ms(library, 20) if library is not None else None,
                   f"expr_eval:{counter}")
        log(f"{name}: {prog}")

    # K9: the TINYINT and SMALLINT keys of ty_narrow
    ln8 = lane(page, call("cast_tinyint", tinyint, col("l_linenumber")))
    q16 = lane(page, qty16)
    keys = [(ln8[0], ln8[1], 0, 0), (q16[0], q16[1], 0, 0)]
    got = kk.hash_keys(keys, page.row_mask)
    err = same(got, kk.masked_plain(keys, page.row_mask, False)[0], "hash_keys@narrow")
    report.add("hash_keys@narrow", "cuda", "presto_tpu_torch/csrc/keys.cu", err,
               cuda_ms(lambda: kk.hash_keys(keys, page.row_mask), 20),
               cuda_ms(lambda: kk.masked_plain(keys, page.row_mask, False), 3),
               nbytes(page.row_mask, ln8[0], ln8[1], q16[0], q16[1], got), None,
               "hash_keys:narrow")

    # K2: REAL, SMALLINT and interval states by l_shipmode (8 slots), a
    # REAL's double sum in the global slot; K3 folds two splits' tables
    mode_col = page.blocks[names.index("l_shipmode")]
    card = len(mode_col.dictionary.values) + 1

    def k2_args(pg):
        disc, tax, q, dl = (lane(pg, e) for e in (real_disc, real_tax, qty16, delay))
        return [(k2.MIN_DOUBLE, disc[0], disc[1]), (k2.MAX_DOUBLE, tax[0], tax[1]),
                (k2.MIN_SHORT, q[0], q[1]), (k2.SUM_SHORT, q[0], q[1]),
                (k2.MIN_SHORT, dl[0], dl[1]), (k2.SUM_SHORT, dl[0], dl[1])]

    def mode_keys(pg):
        mc = pg.blocks[names.index("l_shipmode")]
        return [(mc.data, mc.valid, 0, card)]

    args = k2_args(page)
    keys = mode_keys(page)
    disc = args[0]
    gid = torch.where(page.row_mask & disc[2], mode_col.data.to(torch.int64), card)
    table = torch.full((card + 1,), float("inf"), dtype=torch.float32, device=page.device)
    real_price = lane(page, call("cast_real", real, col("l_extendedprice")))
    for name, kys, ags, g, library in (
            ("packed_group_agg@narrow", keys, args, card,
             lambda: table.scatter_reduce_(0, gid, disc[1], "amin")),
            ("packed_group_agg@real_sum", [], [(k2.SUM_DOUBLE, real_price[0], real_price[1])],
             1, lambda: torch.sum(real_price[0], dtype=torch.float64))):
        got = k2.packed_group_agg(n, page.row_mask, kys, ags, g)
        err = same_bits(got, k2.packed_group_agg_plain(n, page.row_mask, kys, ags, g), name)
        report.add(name, "cuda", "presto_tpu_torch/csrc/packed_group_agg.cu", err,
                   cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, kys, ags, g), 10),
                   cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, kys, ags, g), 2),
                   nbytes(page.row_mask, *[t for k in kys for t in k[:2]],
                          *[t for a in ags for t in a[1:]])
                   + nbytes(*[t for st in got[0] for t in st], got[1]), cuda_ms(library, 10),
                   "packed_group_agg:narrow")
    tables = [k2.packed_group_agg(pg.capacity, pg.row_mask, mode_keys(pg), k2_args(pg), card)
              for pg in pages]
    kinds = [k3.COL_MIN_F64, k3.COL_I64, k3.COL_MAX_F64, k3.COL_I64, k3.COL_MIN_I64, k3.COL_I64,
             k3.COL_I64, k3.COL_I64, k3.COL_MIN_I64, k3.COL_I64, k3.COL_I64, k3.COL_I64]

    def cols_of(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for st in states for t in st])]

    fold = fold_row(report, "packed_fold_finalize@narrow_fold", cols_of(*tables[0]),
                    cols_of(*tables[1]), tables[0][1], tables[1][1],
                    "packed_fold_finalize:narrow")
    f = [d for d, _ in fold[0]]
    finalize_row(report, "packed_fold_finalize@narrow_finalize",
                 [(k3.FIN_VALUE, f[0], f[1]), (k3.FIN_VALUE, f[2], f[3]),
                  (k3.FIN_VALUE, f[4], f[5]), (k3.FIN_AVG_SHORT, f[10], f[11])], fold[1],
                 "packed_fold_finalize:narrow")

    # K6: REAL and SMALLINT states by l_suppkey (its exact domain)
    supp = page.blocks[names.index("l_suppkey")]
    dom = mem.column_domain("lineitem", "l_suppkey")
    supp_keys = [(supp.data, supp.valid, dom[0], dom[1] - dom[0] + 2)]
    q = lane(page, qty16)
    states = [(k6.S_MIN_F64, real_price[0], real_price[1]),
              (k6.S_MAX_F64, real_price[0], real_price[1]),
              (k6.S_DSUM, real_price[0], real_price[1]), (k6.S_MIN, q[0], q[1]),
              (k6.S_SUM, q[0], q[1]), (k6.S_VALID, None, real_price[1])]
    ok = page.row_mask & real_price[1]
    _, g6 = torch.unique(supp.data[ok], return_inverse=True)
    vals6 = real_price[0][ok]
    table6 = torch.full((int(g6.max()) + 1,), float("inf"), dtype=torch.float32,
                        device=page.device)
    groups = k6_bits_row(report, "sorted_group_agg@narrow", supp_keys, page.row_mask, states,
                         "sorted_group_agg:narrow",
                         cuda_ms(lambda: table6.scatter_reduce_(0, g6, vals6, "amin"), 10))
    log(f"K6 REAL and SMALLINT states: {groups} groups of {n} rows")

    # K7 with a REAL key, and K10's running REAL sum, over orders' first split
    onames = [c for c, _ in mem.schema("orders")]
    otypes = dict(mem.schema("orders"))
    opage = mem.page_for_split("orders", 0)
    price = call("cast_real", real, col("o_totalprice", otypes, onames))
    rkey = lane(opage, price)
    okey = opage.blocks[onames.index("o_orderkey")]
    keys7 = [(rkey[0], rkey[1], False, False), (okey.data, okey.valid, True, False)]
    got = k7.topn(keys7, opage.row_mask, 100)
    err = same(got, k7.topn_plain(keys7, opage.row_mask, 100), "topn@real")
    report.add("topn@real", "cuda", "presto_tpu_torch/csrc/topn.cu", err,
               cuda_ms(lambda: k7.topn(keys7, opage.row_mask, 100), 20),
               cuda_ms(lambda: k7.topn_plain(keys7, opage.row_mask, 100), 2),
               nbytes(opage.row_mask, rkey[0], rkey[1], okey.data, okey.valid, *got),
               cuda_ms(lambda: torch.topk(rkey[0], 100), 20), "topn:real")
    # K7's ties at scale: the top 100 of the lineitem split by l_returnflag
    # descending (three values, so millions of rows tie on it), then
    # l_orderkey
    from presto_tpu_torch.ops.sort import topn_keys

    keys7 = topn_keys(page, [col("l_returnflag"), col("l_orderkey")], [False, True],
                      [False, False])
    got = k7.topn(keys7, page.row_mask, 100)
    err = same(got, k7.topn_plain(keys7, page.row_mask, 100), "topn@flag_ties")
    report.add("topn@flag_ties", "cuda", "presto_tpu_torch/csrc/topn.cu", err,
               cuda_ms(lambda: k7.topn(keys7, page.row_mask, 100), 20),
               cuda_ms(lambda: k7.topn_plain(keys7, page.row_mask, 100), 2),
               nbytes(page.row_mask, *[t for k in keys7 for t in k[:2]], *got))
    log(f"topn@flag_ties: top 100 of {n} rows ({int(page.row_mask.sum())} live) by "
        f"l_returnflag desc ({int(torch.unique(keys7[0][0]).numel())} values), l_orderkey")
    inputs = window_inputs(opage, [col("o_custkey", otypes, onames)],
                           [col("o_orderdate", otypes, onames),
                            col("o_orderkey", otypes, onames)], [True, True],
                           [WindowFunc(kind="sum", arg=price)])
    k10_row(report, "window_eval@real", inputs)
    report.counters["window_eval@real"] = "window_eval:narrow"

    # ORDER BY ... LIMIT 1000 past K7's MAX_N: the page sorted, its first
    # 1000 live rows (torch.sort: no kernel of its own, so no kernels row)
    sort_exprs = [col("l_extendedprice"), col("l_orderkey"), col("l_linenumber")]
    top = port_sort.topn_page(page, sort_exprs, [False, True, True], 1000)
    cpu = port_sort.topn_page(page.to("cpu"), sort_exprs, [False, True, True], 1000)
    if top.to_pylist() != cpu.to_pylist():
        raise AssertionError("the sorted top 1000 differs from the CPU's")
    ms = cuda_ms(lambda: port_sort.topn_page(page, sort_exprs, [False, True, True], 1000), 5)
    lib = cuda_ms(lambda: torch.sort(raw["l_extendedprice"].data, descending=True,
                                     stable=True)[1][:1000], 5)
    moved = nbytes(page.row_mask, *[page.blocks[names.index(c)].data for c in
                                    ("l_extendedprice", "l_orderkey", "l_linenumber")],
                   *[page.blocks[names.index(c)].valid for c in
                     ("l_extendedprice", "l_orderkey", "l_linenumber")])
    log(f"sorted top-n (past MAX_N): top 1000 of a {n}-row lineitem split by three keys in "
        f"{ms:.4f} ms (torch.sort + slice of one key {lib:.4f} ms; bound "
        f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms), rows equal the CPU's")


def check_sketch_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the twelfth slice, at the sk_* queries' shapes, each
    kernel against its twin bit for bit: K15's partial over a whole
    lineitem split by l_suppkey (sk_max_n's max(l_extendedprice, 5)) and
    by the two flags (sk_by_n's max_by(l_orderkey, l_extendedprice, 10):
    four groups of ~2M rows), and its merge of two splits' max_by
    lanes; K1's digest hash and K16's make_set_digest(l_partkey) by
    l_shipmode over a split, and K16's merge of two splits' digests;
    K14's wide value half over sk_multimap's inner arrays and map_union
    over sk_map_union's inner maps; K12's hll_card, kmv_card and sd_pair
    over the sketches the sk queries build.  The host's two stable
    sorts beside K15 and K16 (``sorted_entries``: torch.sort, no kernel
    of their own) are timed on a log line."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import AggCall, ColumnRef, Literal
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import group_collect as k14
    from presto_tpu_torch.kernels import group_topn as k15
    from presto_tpu_torch.kernels import kmv_lanes as k16
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.ops import aggregate as agg_ops
    from presto_tpu_torch.ops.join import key_columns
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.types import parse_type

    t0 = time.perf_counter()
    names = [c for c, _ in mem.schema("lineitem")]
    types = dict(mem.schema("lineitem"))
    bigint = parse_type("bigint")

    def col(c):
        return ColumnRef(type=types[c], index=names.index(c))

    def runs(pg, exprs):
        keys = key_columns(pg, exprs, [None] * len(exprs))
        got = k6.sorted_group_agg(keys, pg.row_mask, [(k6.S_ONE, None, None)], runs=True)
        return got[2], got[3]

    def agg(fn, arg, arg2=None, arg3=None):
        call = AggCall(fn=fn, arg=arg, arg2=arg2, arg3=arg3, type=bigint)
        return AggCall(fn=fn, arg=arg, arg2=arg2, arg3=arg3, type=agg_ops.output_type(call))

    def lit(v):
        return Literal(type=bigint, value=v)

    pages = [mem.page_for_split("lineitem", i) for i in (0, 1)]
    page = pages[0]
    dev = page.device
    c = ExprCompiler.for_page(page)
    price = page.blocks[names.index("l_extendedprice")]
    okey = page.blocks[names.index("l_orderkey")]

    # K15's partial: sk_max_n's by l_suppkey, sk_by_n's by the two flags
    def topn_row(name, exprs, vals, keys, cap):
        groups, (order, starts) = runs(page, exprs)
        g, rows = agg_ops._run_positions(order, starts)
        k = keys if keys is not None else vals
        ok = (page.row_mask & price.valid)[rows]
        perm, bounds = k15.sorted_entries(g, k[rows], ok, groups)
        prm = rows[perm]
        got = k15.group_topn(prm, bounds, vals, keys, cap, True)
        err = same_bits(got, k15.group_topn_plain(prm, bounds, vals, keys, cap, True), name)
        lanes = int(torch.clamp(bounds[1:] - bounds[:-1], max=cap).sum())
        halves = 1 if keys is None else 2
        report.add(name, "cuda", "presto_tpu_torch/csrc/group_topn.cu", err,
                   cuda_ms(lambda: k15.group_topn(prm, bounds, vals, keys, cap, True), 20),
                   cuda_ms(lambda: k15.group_topn_plain(prm, bounds, vals, keys, cap, True), 3),
                   nbytes(bounds, got) + lanes * 8 * (1 + halves), None, "group_topn")
        sort_ms = cuda_ms(lambda: k15.sorted_entries(g, k[rows], ok, groups), 3)
        log(f"{name}: {groups} groups of {int(starts[-1])} rows, {lanes} lanes; the host's "
            f"two stable sorts (sorted_entries) {sort_ms:.4f} ms")

    topn_row("group_topn", [col("l_suppkey")], price.data, None, 5)
    topn_row("group_topn@by_n", [col("l_returnflag"), col("l_linestatus")],
             okey.data.to(torch.int64), price.data, 10)

    # K15's merge: two splits' max_by(l_orderkey, l_extendedprice, 10)
    # partials by the two flags, flattened into entries
    flags = [col("l_returnflag"), col("l_linestatus")]
    by_n = agg("max_by_n", col("l_orderkey"), col("l_extendedprice"), lit(10))
    parts = concat_pages_device([agg_ops.grouped_aggregate(pg, flags, [by_n], 1 << 14,
                                                           key_domains=[None, None],
                                                           mode="partial") for pg in pages])
    pkeys = [ColumnRef(type=b.type, index=i) for i, b in enumerate(parts.blocks[:2])]
    groups, (order, starts) = runs(parts, pkeys)
    g, rows = agg_ops._run_positions(order, starts)
    part = parts.blocks[2].data[rows]
    lens = torch.clamp(k14.lengths(part), max=10)
    lane_ok = (torch.arange(10, device=dev)[None, :] < lens[:, None]).reshape(-1)
    vals, keys = part[:, 1:11].reshape(-1), part[:, 11:21].reshape(-1)
    ge = g[:, None].expand(-1, 10).reshape(-1)
    perm, bounds = k15.sorted_entries(ge, keys, lane_ok, groups)
    got = k15.group_topn(perm, bounds, vals, keys, 10, True)
    err = same_bits(got, k15.group_topn_plain(perm, bounds, vals, keys, 10, True),
                    "group_topn@merge")
    report.add("group_topn@merge", "cuda", "presto_tpu_torch/csrc/group_topn.cu", err,
               cuda_ms(lambda: k15.group_topn(perm, bounds, vals, keys, 10, True, True), 20),
               cuda_ms(lambda: k15.group_topn_plain(perm, bounds, vals, keys, 10, True), 3),
               nbytes(bounds, got) + int(got[:, 0].sum()) * 8 * 3, None, "group_topn:merge")

    # K1's digest hash and K16 over sk_digest's make_set_digest(l_partkey)
    # by l_shipmode, then the merge of two splits' digests
    lw_prog, lw_cols = agg_ops.digest_hash_program(c, col("l_partkey"))
    ins = [(page.blocks[i].data, page.blocks[i].valid) for i in lw_cols]
    n = page.capacity
    hv = k1.expr_eval(lw_prog, ins, n)
    err = same_bits(hv, k1.expr_eval_plain(lw_prog, ins, n), "expr_eval@digest_hash")
    report.add("expr_eval@digest_hash", "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err,
               cuda_ms(lambda: k1.expr_eval(lw_prog, ins, n), 20),
               cuda_ms(lambda: k1.expr_eval_plain(lw_prog, ins, n), 3),
               nbytes(*[t for p in ins for t in p]) + nbytes(*hv), None,
               "expr_eval:digest_hash")
    groups, (order, starts) = runs(page, [col("l_shipmode")])
    g, rows = agg_ops._run_positions(order, starts)
    h = hv[0][rows]
    ok = (page.row_mask & hv[1])[rows]
    perm, bounds = k15.sorted_entries(g, h, ok, groups)
    # no count lane: make_set_digest counts each row once
    got = k16.kmv_lanes(perm, g, h, None, bounds, 64)
    err = same_bits(list(got), list(k16.kmv_lanes_plain(perm, g, h, None, bounds, 64)),
                    "kmv_lanes")
    report.add("kmv_lanes", "cuda", "presto_tpu_torch/csrc/kmv_lanes.cu", err,
               cuda_ms(lambda: k16.kmv_lanes(perm, g, h, None, bounds, 64), 10),
               cuda_ms(lambda: k16.kmv_lanes_plain(perm, g, h, None, bounds, 64), 2),
               nbytes(perm, g, h, bounds, *got), None, "kmv_lanes")
    sort_ms = cuda_ms(lambda: k15.sorted_entries(g, h, ok, groups), 3)
    log(f"kmv_lanes: {groups} groups of {int(starts[-1])} rows; the host's two stable sorts "
        f"{sort_ms:.4f} ms")
    digest = agg("make_set_digest", col("l_partkey"))
    parts = concat_pages_device([agg_ops.grouped_aggregate(pg, [col("l_shipmode")], [digest],
                                                           1 << 14, key_domains=[None],
                                                           mode="partial") for pg in pages])
    groups, (order, starts) = runs(parts, [ColumnRef(type=parts.blocks[0].type, index=0)])
    g, rows = agg_ops._run_positions(order, starts)
    ge, he, ce, oke = k16.digest_entries(parts.blocks[1].data[rows], g, parts.row_mask[rows], 64)
    perm, bounds = k15.sorted_entries(ge, he, oke, groups)
    got = k16.kmv_lanes(perm, ge, he, ce, bounds, 64)
    err = same_bits(list(got), list(k16.kmv_lanes_plain(perm, ge, he, ce, bounds, 64)),
                    "kmv_lanes@merge")
    report.add("kmv_lanes@merge", "cuda", "presto_tpu_torch/csrc/kmv_lanes.cu", err,
               cuda_ms(lambda: k16.kmv_lanes(perm, ge, he, ce, bounds, 64, True), 10),
               cuda_ms(lambda: k16.kmv_lanes_plain(perm, ge, he, ce, bounds, 64), 2),
               nbytes(perm, ge, he, ce, bounds, *got), None, "kmv_lanes:merge")

    # K14 and K12 over the sk queries' own inner pages and sketches
    def device_page(sql):
        r = QueryRunner(query_catalog(mem, sql), device="cuda")
        return r.executor.run_to_page(r.plan(sql))

    inner = device_page("select l_returnflag, l_shipmode, array_agg(l_linenumber) v "
                        "from lineitem group by 1, 2")
    ib = inner.blocks
    mm = agg("multimap_agg", ColumnRef(type=ib[1].type, index=1),
             ColumnRef(type=ib[2].type, index=2))
    groups, (order, starts) = runs(inner, [ColumnRef(type=ib[0].type, index=0)])
    sel, halves = agg_ops._collect_halves(ExprCompiler.for_page(inner), mm, inner)
    storage = agg_ops._torch_dtype(agg_ops.state_types(mm)[0])
    got = k14.group_collect(order, starts, sel, halves, 64, storage)
    err = same_bits(got, k14.group_collect_plain(order, starts, sel, halves, 64, storage),
                    "group_collect@wide")
    report.add("group_collect@wide", "cuda", "presto_tpu_torch/csrc/group_collect.cu", err,
               cuda_ms(lambda: k14.group_collect(order, starts, sel, halves, 64, storage), 20),
               cuda_ms(lambda: k14.group_collect_plain(order, starts, sel, halves, 64,
                                                       storage), 3),
               nbytes(order, starts, sel, *[t for hf in halves for t in hf], got), None,
               "group_collect:wide")
    inner = device_page("select l_returnflag, l_suppkey % 50 g, map_agg(l_linenumber, "
                        "l_quantity) m from lineitem group by 1, 2")
    ib = inner.blocks
    groups, (order, starts) = runs(inner, [ColumnRef(type=ib[0].type, index=0)])
    live = inner.row_mask & ib[2].valid
    maps = ib[2].data
    cap_in = ib[2].type.max_elems
    got = k14.group_collect_merge(order, starts, live, maps, 64, halves=2, in_cap=cap_in)
    err = same_bits(got, k14.group_collect_merge_plain(order, starts, live, maps, 64, 2, 1,
                                                       cap_in), "group_collect@union")
    entries = int(torch.where(live, torch.clamp(k14.lengths(maps), max=cap_in), 0).sum())
    report.add("group_collect@union", "cuda", "presto_tpu_torch/csrc/group_collect.cu", err,
               cuda_ms(lambda: k14.group_collect_merge(order, starts, live, maps, 64, halves=2,
                                                       in_cap=cap_in), 20),
               cuda_ms(lambda: k14.group_collect_merge_plain(order, starts, live, maps, 64, 2,
                                                             1, cap_in), 3),
               nbytes(order, starts, live, maps[:, 0], got) + entries * 16, None,
               "group_collect:union")
    sketches = device_page("select o_orderpriority, approx_set(o_custkey) s from orders "
                           "group by 1").blocks[1]
    air = device_page("select make_set_digest(l_suppkey) a from lineitem "
                      "where l_shipmode = 'AIR'").blocks[0]
    rail = device_page("select make_set_digest(l_suppkey) b from lineitem "
                       "where l_shipmode = 'RAIL'").blocks[0]
    modes = device_page("select l_shipmode, make_set_digest(l_partkey) d from lineitem "
                        "group by 1").blocks[1]
    for name, kw in (("container_eval@hll_card", dict(op=k12.HLL_CARD, a=sketches.data,
                                                      av=sketches.valid)),
                     ("container_eval@kmv_card", dict(op=k12.KMV_CARD, a=modes.data,
                                                      av=modes.valid)),
                     ("container_eval@sd_pair", dict(op=k12.SD_PAIR, a=air.data, av=air.valid,
                                                     b=rail.data, bv=rail.valid,
                                                     p=[k12.SD_INTERSECTION]))):
        got = k12.container_eval(**kw)
        err = same_bits(list(got), list(_k12_plain(kw)), name)
        report.add(name, "cuda", "presto_tpu_torch/csrc/container_eval.cu", err,
                   cuda_ms(lambda: k12.container_eval(**kw), 20),
                   cuda_ms(lambda: _k12_plain(kw), 3),
                   nbytes(*[v for k, v in kw.items() if isinstance(v, torch.Tensor)], *got),
                   None, f"container_eval:{name.split('@')[1]}")
    log(f"the sketch kernels' checks took {time.perf_counter() - t0:.1f} s")


def check_decimal38_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the thirteenth slice, over whole 2^23-row lineitem splits
    with l_quantity and l_extendedprice cast to decimal(38,2), each mode
    against its twin, bit for bit: K1's five-limb instance (the cast
    itself, S2D38; Q1's wide x short product; Q6's wide compare against a
    short literal, as a filter; the up-scale to decimal(38,18); the
    double; the narrowing to bigint), K2's wide sum, min and max by Q1's
    flags, K3's fold of two splits' tables and its wide sum and avg
    finalizes, K6's wide states by l_suppkey and their merge over two
    splits, and K7's top 100 by the merged wide revenue.  No single
    PyTorch call computes limb arithmetic with carries, so these rows
    have no library time."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import Call, ColumnRef, Literal
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.kernels import packed_fold_finalize as k3
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.kernels import topn as k7
    from presto_tpu_torch.page import Block, Page
    from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, DecimalType

    names = [c for c, _ in mem.schema("lineitem")]
    types = dict(mem.schema("lineitem"))
    wide, wide4, wide18 = DecimalType(38, 2), DecimalType(38, 4), DecimalType(38, 18)

    def col(c, t=None):
        return ColumnRef(type=t or types[c], index=names.index(c))

    def widen(pg):
        """The page with D38_COLUMNS as decimal(38,2) (K1's S2D38)."""
        blocks = list(pg.blocks)
        for c in D38_COLUMNS:
            d, v = ExprCompiler.for_page(pg).compile(
                Call(type=wide, fn="cast_decimal", args=(col(c),)))(pg)
            blocks[names.index(c)] = Block(d, v, wide)
        return Page(tuple(blocks), pg.row_mask)

    src = [mem.page_for_split("lineitem", i) for i in (0, 1)]
    pages = [widen(p) for p in src]
    page, n = pages[0], pages[0].capacity
    price, qty = col("l_extendedprice", wide), col("l_quantity", wide)
    one_minus = Call(type=DecimalType(18, 2), fn="sub", args=(
        Literal(type=BIGINT, value=1), col("l_discount")))
    # name: (expression over ``pg``, the page it reads, a filter, counter)
    rows = {
        "d38_widen": (Call(type=wide, fn="cast_decimal", args=(col("l_extendedprice"),)),
                      src[0], False, "s2d38"),
        "d38_mul": (Call(type=wide4, fn="mul", args=(price, one_minus)), page, False, "d38mul"),
        "d38_cmp": (Call(type=BOOLEAN, fn="lt", args=(qty, Literal(type=BIGINT, value=24))),
                    page, True, "d38cmp"),
        "d38_upscale": (Call(type=wide18, fn="cast_decimal", args=(price,)), page, False,
                        "d38up"),
        "d38_double": (Call(type=DOUBLE, fn="cast_double", args=(price,)), page, False,
                       "d382d"),
        "d38_narrow": (Call(type=BIGINT, fn="cast_bigint", args=(qty,)), page, False,
                       "d38narrow"),
    }
    for label, (expr, pg, filt, counter) in rows.items():
        name = f"expr_eval@{label}"
        prog, cols = ExprCompiler.for_page(pg).lower(expr)
        if prog.limbs != 5:
            raise AssertionError(f"{name}: {prog} is not a D38 program")
        ins = [(pg.blocks[i].data, pg.blocks[i].valid) for i in cols]
        mask = pg.row_mask if filt else None
        got = k1.expr_eval(prog, ins, n, row_mask=mask)
        err = same_bits(got, k1.expr_eval_plain(prog, ins, n, row_mask=mask), name)
        report.add(name, "cuda", "presto_tpu_torch/csrc/expr_eval.cu", err,
                   cuda_ms(lambda: k1.expr_eval(prog, ins, n, row_mask=mask), 20),
                   cuda_ms(lambda: k1.expr_eval_plain(prog, ins, n, row_mask=mask), 3),
                   nbytes(*[t for c in ins for t in c], mask) + nbytes(
                       *(got if isinstance(got, tuple) else (got,))), None,
                   f"expr_eval:{counter}")
        log(f"{name}: {prog}")

    # K2: Q1's wide sums and extremes by its two flags (3 x 2 codes), and
    # K3's fold of two splits' tables, then its finalizes
    def flag_keys(pg):
        out = []
        for c in ("l_returnflag", "l_linestatus"):
            b = pg.blocks[names.index(c)]
            out.append((b.data, b.valid, 0, len(b.dictionary.values) + 1))
        return out

    def k2_args(pg):
        p, q = pg.blocks[names.index("l_extendedprice")], pg.blocks[names.index("l_quantity")]
        return [(k2.SUM_D38, p.data, p.valid), (k2.MIN_D38, p.data, p.valid),
                (k2.MAX_D38, q.data, q.valid), (k2.SUM_D38, q.data, q.valid)]

    keys, args = flag_keys(page), k2_args(page)
    slots = keys[0][3] * keys[1][3]
    got = k2.packed_group_agg(n, page.row_mask, keys, args, slots)
    err = same(got, k2.packed_group_agg_plain(n, page.row_mask, keys, args, slots),
               "packed_group_agg@d38")
    report.add("packed_group_agg@d38", "cuda", "presto_tpu_torch/csrc/packed_group_agg.cu", err,
               cuda_ms(lambda: k2.packed_group_agg(n, page.row_mask, keys, args, slots), 10),
               cuda_ms(lambda: k2.packed_group_agg_plain(n, page.row_mask, keys, args, slots),
                       2),
               nbytes(page.row_mask, *[t for k in keys for t in k[:2]],
                      *[t for a in args for t in a[1:]])
               + nbytes(*[t for st in got[0] for t in st], got[1]), None,
               "packed_group_agg:d38")
    tables = [k2.packed_group_agg(pg.capacity, pg.row_mask, flag_keys(pg), k2_args(pg), slots)
              for pg in pages]
    kinds = [k3.COL_D38, k3.COL_I64, k3.COL_MIN_D38, k3.COL_I64, k3.COL_MAX_D38, k3.COL_I64,
             k3.COL_D38, k3.COL_I64]

    def cols_of(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for st in states for t in st])]

    fold = fold_row(report, "packed_fold_finalize@d38_fold", cols_of(*tables[0]),
                    cols_of(*tables[1]), tables[0][1], tables[1][1], "packed_fold_finalize:d38")
    f = [d for d, _ in fold[0]]
    finalize_row(report, "packed_fold_finalize@d38_finalize",
                 [(k3.FIN_SUM_D38, f[0], f[1]), (k3.FIN_AVG_D38, f[0], f[1]),
                  (k3.FIN_SUM_D38, f[2], f[3]), (k3.FIN_AVG_D38, f[6], f[7])], fold[1],
                 "packed_fold_finalize:d38")

    # K6: revenue (a wide x short product), min and max by l_suppkey over
    # two splits, then their merge; K7's top 100 by the merged revenue
    dom = mem.column_domain("lineitem", "l_suppkey")

    def supp_states(pg):
        rev = ExprCompiler.for_page(pg).compile(
            Call(type=wide4, fn="mul", args=(price, one_minus)))(pg)
        p = pg.blocks[names.index("l_extendedprice")]
        s = pg.blocks[names.index("l_suppkey")]
        return ([(s.data, s.valid, dom[0], dom[1] - dom[0] + 2)],
                [(k6.S_LIMBS_D38, rev[0], rev[1]), (k6.S_MIN_D38, p.data, p.valid),
                 (k6.S_MAX_D38, p.data, p.valid), (k6.S_VALID, None, p.valid)])

    skeys, states = supp_states(page)
    groups = k6_bits_row(report, "sorted_group_agg@d38", skeys, page.row_mask, states,
                         "sorted_group_agg:d38")
    parts = []
    for pg in pages:
        kk, st = supp_states(pg)
        parts.append(k6.sorted_group_agg(kk, pg.row_mask, st))
    key = torch.cat([p[0][0][0] for p in parts])
    kvalid = torch.cat([p[0][0][1] for p in parts])
    cols = [torch.cat([p[1][i] for p in parts]) for i in range(4)]
    live = cols[3] > 0
    mkeys = [(key, kvalid, dom[0], dom[1] - dom[0] + 2)]
    mstates = [(k6.S_LIMBS_D38, cols[0], live), (k6.S_MIN_D38, cols[1], live),
               (k6.S_MAX_D38, cols[2], live), (k6.S_SUM, cols[3], torch.ones_like(live))]
    mmask = torch.ones_like(live)
    merged = k6_bits_row(report, "sorted_group_agg@d38_merge", mkeys, mmask, mstates,
                         "sorted_group_agg:d38")
    log(f"K6 wide states: {groups} suppliers of {n} rows; merged {merged} of "
        f"{key.shape[0]} partial rows")
    out = k6.sorted_group_agg(mkeys, mmask, mstates)
    rev = out[1][0].contiguous()
    keys7 = [(rev, out[1][3] > 0, False, False), (out[0][0][0], out[0][0][1], True, False)]
    gmask = torch.ones(out[2], dtype=torch.bool, device=rev.device)
    got = k7.topn(keys7, gmask, 100)
    err = same(got, k7.topn_plain(keys7, gmask, 100), "topn@d38")
    report.add("topn@d38", "cuda", "presto_tpu_torch/csrc/topn.cu", err,
               cuda_ms(lambda: k7.topn(keys7, gmask, 100), 20),
               cuda_ms(lambda: k7.topn_plain(keys7, gmask, 100), 2),
               nbytes(gmask, *[t for k in keys7 for t in k[:2]], *got), None, "topn:d38")


def raw_query_tables(conn) -> dict:
    """The tables and columns the raw queries may read: TPC-H's and the
    raw copies ``conn`` holds."""
    return {**TABLES, **{t: [c for c, _ in conn.schema(t)] for t in RAW_TABLES}}


def raw_read_bytes(mode: int, a, kw) -> int:
    """The bytes of ``a``'s rows a K17 mode must read on this run's data
    (the rest of its bound counts the other inputs and the output
    once): a comparison up to each row's first differing byte (IN: the
    last literal to differ), a prefix its needle's bytes, codepoint the
    first character, substr the characters it keeps and the next one's
    lead, length, ends_with, LIKE and an absent needle up to each row's
    end (its first padding byte), a present one through its first
    occurrence; every other mode the whole width."""
    from presto_tpu_torch.kernels import raw_string_eval as k17

    n, w = a.shape
    ends = torch.clamp((a != 0).sum(1) + 1, max=w)  # through the first padding byte

    def first_diff(lit):
        diff = a != k17._pad(lit, w)[:, :w]
        return torch.where(diff.any(1), torch.argmax(diff.to(torch.int8), 1) + 1, w)

    if mode == k17.CMP:
        need = first_diff(kw["b"])
    elif mode == k17.IN:
        need = torch.stack([first_diff(kw["b"][j:j + 1]) for j in range(kw["b"].shape[0])],
                           1).max(1).values
    elif mode == k17.PREFIX:
        need = torch.full_like(ends, min(len(kw["tokens"]), w))
    elif mode == k17.CODEPOINT:
        lead = a[:, 0].to(torch.int64)
        need = torch.where(lead < 0xC0, 1, torch.where(lead < 0xE0, 2,
                                                       torch.where(lead < 0xF0, 3, 4)))
    elif mode == k17.SUBSTR and kw.get("flag"):
        starts = torch.cumsum(((a != 0) & ((a & 0xC0) != 0x80)).to(torch.int32), 1)
        last = kw.get("start", 1) - 1 + (kw["length"] if kw.get("length") is not None else w)
        need = torch.clamp((starts <= last).sum(1) + 1, max=w)
    elif mode == k17.STRPOS:
        # a one-byte (ASCII) needle: through its first occurrence, else the row's end
        hit = a == kw["tokens"][0]
        need = torch.where(hit.any(1), torch.argmax(hit.to(torch.int8), 1) + 1, ends)
    elif mode in (k17.LEN, k17.SUFFIX, k17.LIKE) and (mode != k17.LEN or kw.get("flag")):
        need = ends
    else:
        return a.numel() * a.element_size()
    return int(need.sum())


def check_rawstring_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the fourteenth slice, over ``orders_raw``'s first 2^23-row
    split (o_comment as raw_varchar(79)) and ``customer_raw`` (c_name
    (25), c_address (40), c_phone (15)): each K17 mode against its twin
    (run on the card), bit for bit, the raw queries' own calls; K2's raw
    extremes by c_nationkey, K6's by a hashed raw key and their merge
    over two halves of the rows; K7 and K10 over the pages and keys the
    raw_order query's top-n (c_address's five lanes) and the raw_window
    query's window (rank by c_phone's lanes) give them.  The library time:
    ``torch.isin`` over the first lane where an IN's values fit one lane
    (the second lane is padding in every row), ``torch.where`` for the
    row select; no single PyTorch call computes the other modes (byte
    rows compared lexicographically, UTF-8 decoded, FNV-1a hashed)."""
    from presto_tpu_torch.kernels import packed_group_agg as k2
    from presto_tpu_torch.kernels import raw_string_eval as k17
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.kernels import topn as k7
    from presto_tpu_torch.ops import rawstring as rs

    def column(table, col):
        page = mem.page_for_split(table, 0)
        return page, page.blocks[[c for c, _ in mem.schema(table)].index(col)]

    opage, comment = column("orders_raw", "o_comment")
    cpage, name = column("customer_raw", "c_name")
    _, addr = column("customer_raw", "c_address")
    _, phone = column("customer_raw", "c_phone")
    _, nation = column("customer_raw", "c_nationkey")
    _, acct = column("customer_raw", "c_acctbal")
    dev = name.data.device
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    head = rs.substr_chars(phone.data, 1, 2)
    lits = rs.literal_rows(codes, 15, dev)
    head0, lits0 = rs.pack_lanes(head)[:, 0].contiguous(), rs.pack_lanes(lits)[:, 0].contiguous()
    in_debt = rs.encode_literal("in debt", 25, dev)
    positive = acct.data > 0
    comment_lanes = rs.pack_lanes(comment.data)
    # label: (mode, rows, keyword arguments, the library call or None)
    rows = {
        "like": (k17.LIKE, comment.data, dict(tokens=rs.like_tokens("%special%requests%")),
                 None),
        "cmp": (k17.CMP, comment.data, dict(b=rs.encode_literal("m", 79, dev), op="lt"), None),
        "in": (k17.IN, head, dict(b=lits), lambda: torch.isin(head0, lits0)),
        "substr": (k17.SUBSTR, phone.data, dict(start=1, length=2, flag=True), None),
        "case_map": (k17.CASE_MAP, name.data, dict(flag=True), None),
        "concat": (k17.CONCAT, name.data, dict(b=phone.data), None),
        "len": (k17.LEN, addr.data, dict(flag=True), None),
        "strpos": (k17.STRPOS, addr.data, dict(tokens=rs.code_points("a")), None),
        "codepoint": (k17.CODEPOINT, name.data, {}, None),
        "prefix": (k17.PREFIX, phone.data, dict(tokens=rs.code_points("1")), None),
        "suffix": (k17.SUFFIX, addr.data, dict(tokens=rs.code_points("e")), None),
        "pack": (k17.PACK, comment.data, {}, None),
        "unpack": (k17.UNPACK, comment_lanes, dict(width=79), None),
        "hash": (k17.HASH, addr.data, {}, None),
        "select": (k17.SELECT, name.data, dict(b=in_debt, mask=positive, width=25),
                   lambda: torch.where(positive[:, None], name.data, in_debt)),
    }
    for label, (mode, a, kw, library) in rows.items():
        rname = f"raw_string_eval@{label}"
        got = k17.raw_string_eval(mode, a, **kw)
        err = same(got, k17.raw_string_eval_plain(mode, a, **kw), rname)
        others = [v for v in kw.values() if isinstance(v, torch.Tensor)]
        report.add(rname, "cuda", "presto_tpu_torch/csrc/raw_string_eval.cu", err,
                   cuda_ms(lambda: k17.raw_string_eval(mode, a, **kw), 20),
                   cuda_ms(lambda: k17.raw_string_eval_plain(mode, a, **kw), 1, warmup=1),
                   raw_read_bytes(mode, a, kw) + nbytes(*others) + nbytes(got),
                   None if library is None else cuda_ms(library, 20),
                   f"raw_string_eval:{k17.MODE_NAMES[mode]}")
    log(f"K17 over {comment.data.shape[0]} o_comment rows and {name.data.shape[0]} customer "
        "rows")

    # K2: the extremes by c_nationkey (25 nations, 27 slots), beside counts
    n = cpage.capacity
    dom = mem.column_domain("customer_raw", "c_nationkey")
    keys = [(nation.data, nation.valid, dom[0], dom[1] - dom[0] + 2)]
    slots = keys[0][3]
    args = [(k2.MIN_LANES, rs.pack_lanes(phone.data), phone.valid),
            (k2.MAX_LANES, rs.pack_lanes(name.data), name.valid),
            (k2.MIN_LANES, rs.pack_lanes(addr.data), addr.valid)]
    got = k2.packed_group_agg(n, cpage.row_mask, keys, args, slots)
    err = same(got, k2.packed_group_agg_plain(n, cpage.row_mask, keys, args, slots),
               "packed_group_agg@raw_lanes")
    report.add("packed_group_agg@raw_lanes", "cuda",
               "presto_tpu_torch/csrc/packed_group_agg.cu", err,
               cuda_ms(lambda: k2.packed_group_agg(n, cpage.row_mask, keys, args, slots), 5),
               cuda_ms(lambda: k2.packed_group_agg_plain(n, cpage.row_mask, keys, args, slots),
                       1),
               nbytes(cpage.row_mask, nation.data, nation.valid,
                      *[t for a in args for t in a[1:]])
               + nbytes(*[t for st in got[0] for t in st], got[1]), None,
               "packed_group_agg:lanes")

    # K6: the extremes by a hashed raw key (c_address's first three
    # characters), then the merge of two halves' partial states
    key = (rs.hash_bytes(rs.substr_chars(addr.data, 1, 3)), addr.valid, 0, 0)

    def states_of():
        return [(k6.S_MIN_LANES, rs.pack_lanes(phone.data), phone.valid),
                (k6.S_VALID, None, phone.valid),
                (k6.S_MAX_LANES, rs.pack_lanes(name.data), name.valid),
                (k6.S_VALID, None, name.valid)]

    states = states_of()
    groups = k6_bits_row(report, "sorted_group_agg@raw_lanes", [key], cpage.row_mask, states,
                         "sorted_group_agg:lanes")
    half = torch.arange(n, device=dev) < n // 2
    parts = [k6.sorted_group_agg([key], cpage.row_mask & m, states) for m in (half, ~half)]
    mkey = torch.cat([p[0][0][0] for p in parts])
    mvalid = torch.cat([p[0][0][1] for p in parts])
    cols = [torch.cat([p[1][i] for p in parts]) for i in range(4)]
    ones = torch.ones_like(mvalid)
    mstates = [(k6.S_MIN_LANES, cols[0].contiguous(), cols[1] > 0), (k6.S_SUM, cols[1], ones),
               (k6.S_MAX_LANES, cols[2].contiguous(), cols[3] > 0), (k6.S_SUM, cols[3], ones)]
    merged = k6_bits_row(report, "sorted_group_agg@raw_lanes_merge", [(mkey, mvalid, 0, 0)],
                         ones, mstates, "sorted_group_agg:lanes")
    log(f"K6 raw extremes: {groups} address prefixes of {n} rows; merged {merged} of "
        f"{mkey.shape[0]} partial rows")

    # K7 and K10 over the inputs the raw_order and raw_window queries give
    # them: the page each node's source yields, its keys as the operator
    # makes them
    from presto_tpu_torch.ops.sort import topn_keys
    from presto_tpu_torch.ops.window import window_inputs
    from presto_tpu_torch.planner.plan import TopNNode, WindowNode
    from presto_tpu_torch.runner import QueryRunner

    def node_input(label, cls):
        sql = RAW_QUERIES[label]
        runner = QueryRunner(query_catalog(mem, sql, tables=raw_query_tables(mem)),
                             device="cuda")
        node = find(runner.plan(sql), cls)
        return node, source_page(runner.executor, node.source)

    node, page = node_input("raw_order", TopNNode)
    keys7 = topn_keys(page, list(node.sort_exprs), list(node.ascending), node.nulls_first)
    got = k7.topn(keys7, page.row_mask, node.count)
    err = same(got, k7.topn_plain(keys7, page.row_mask, node.count), "topn@raw")
    report.add("topn@raw", "cuda", "presto_tpu_torch/csrc/topn.cu", err,
               cuda_ms(lambda: k7.topn(keys7, page.row_mask, node.count), 20),
               cuda_ms(lambda: k7.topn_plain(keys7, page.row_mask, node.count), 1),
               nbytes(page.row_mask, *[t for k in keys7 for t in k[:2]], *got), None,
               "topn:lanes")
    log(f"topn@raw (raw_order's input): {page.capacity} rows, "
        f"{int(page.row_mask.sum())} live, n = {node.count}, keys of "
        f"{[tuple(k[0].shape[1:]) or (1,) for k in keys7]} lanes")

    node, src = node_input("raw_window", WindowNode)
    k10_row(report, "window_eval@raw", window_inputs(
        src, list(node.partition_exprs), list(node.order_exprs), list(node.ascending),
        list(node.funcs), node.partition_domains), "window_eval:lanes")


def k18_ops(table, x, y, code) -> int:
    """The float64 operations K18's test needs on these inputs: four
    compares a row against its geometry's bbox; for a row inside it, one
    compare for each edge of its geometry (whether the edge's y-span
    holds the row's y), and seven more for each edge whose span does
    (two subtracts, a divide, a subtract, a multiply, an add and the
    compare with x)."""
    from presto_tpu_torch.kernels import geo_contains as k18

    n, dev = x.shape[0], x.device
    if code is None:
        groups = [(0, torch.arange(n, device=dev))]
    else:
        c = code.to(torch.int64)
        order = torch.argsort(c, stable=True)
        ids, counts = torch.unique_consecutive(c[order], return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        groups = [(g, order[s:s + k]) for g, s, k in
                  zip(ids.tolist(), starts.tolist(), counts.tolist()) if 0 <= g < len(table)]
    ops = 0
    for gi, rows in groups:
        geom = table.geoms[gi]
        if geom is None:
            continue
        ops += 4 * rows.shape[0]
        cand = rows[k18.bbox_mask(geom.bbox, x[rows], y[rows])]
        if geom.kind == "POINT":
            continue
        cy = y[cand]
        for ring in geom.rings:
            vy = torch.as_tensor(ring[:, 1], dtype=torch.float64, device=dev)
            vy2 = torch.roll(vy, -1)
            ops += cand.shape[0] * vy.shape[0]
            for i in range(0, cand.shape[0], 1 << 16):
                yy = cy[i:i + (1 << 16), None]
                ops += 7 * int(((vy[None, :] > yy) != (vy2[None, :] > yy)).sum())
    return ops


def check_ml_geo_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the fifteenth slice, over the inputs the ml_* and geo_*
    queries give their kernels (each from its plan, over the first
    split): K18 over the first 2^23 trips with geo_contains' 1024-vertex
    literal and over geo_join's 68.9M (zone, sampled trip) rows by each
    zone's code; K19's partial states of ml_regressor (packed-direct,
    12 slots) and ml_classifier (8 slots), of ml_regressor_supp on the
    sort path (K6's runs of l_suppkey), of ml_evaluate (classify's
    classes), and the merge of two splits' supplier partials; K20 over
    the merged supplier models and ml_classifier's slots; K12's
    REGRESS and CLASSIFY over ml_regress' and ml_evaluate's rows.  Each
    against its twin on the card, bit for bit (CLASSIFY: the class where
    the two best log-likelihoods lie more than 4 ulp apart, the winning
    log-likelihood within 2 ulp).  Bounds: bytes; K18 also its float64
    operations on these inputs (``k18_ops``).  Library calls:
    ``index_add_`` of the materialized lane matrix (K19), a batched
    ``torch.linalg.solve`` (K20's regressor)."""
    from presto_tpu_torch import geo
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import geo_contains as k18
    from presto_tpu_torch.kernels import ml_finalize as k20
    from presto_tpu_torch.kernels import ml_state as k19
    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.ops import aggregate as agg_ops
    from presto_tpu_torch.ops.join import key_tuples
    from presto_tpu_torch.page import concat_pages_device
    from presto_tpu_torch.planner.plan import AggregationNode
    from presto_tpu_torch.runner import QueryRunner

    tables = {**TABLES, **GEO_TABLES}

    # K18: geo_contains' literal over the first trips split
    page = mem.page_for_split("trips", 0)
    x, y = page.blocks[1].data, page.blocks[2].data
    lit = geo.GeometryTable([geo.parse_wkt(geo_polygon())])
    got = k18.geo_contains(lit, x, y)
    err = same(got, k18.geo_contains_plain(lit, x, y), "geo_contains")
    report.add("geo_contains", "cuda", "presto_tpu_torch/csrc/geo_contains.cu", err,
               cuda_ms(lambda: k18.geo_contains(lit, x, y), 10),
               cuda_ms(lambda: k18.geo_contains_plain(lit, x, y), 1, warmup=0),
               nbytes(x, y, *got), None, "geo_contains", bound_ops=k18_ops(lit, x, y, None))
    log(f"K18 literal: {int(got[0].sum())} of {x.shape[0]} trips inside a polygon of "
        f"{lit.vertices} vertices")
    # K18 by code: every (zone, sampled trip) row of geo_join
    zones = mem.page_for_split("zones", 0)
    table = geo.dictionary_table(zones.blocks[1].dictionary)
    sample = mem.page_for_split("trips_sample", 0)
    sx, sy = sample.blocks[1].data, sample.blocks[2].data
    nz = zones.capacity
    cx, cy = sx.repeat(nz), sy.repeat(nz)
    code = zones.blocks[1].data.repeat_interleave(sx.shape[0])
    got = k18.geo_contains(table, cx, cy, code)
    err = same(got, k18.geo_contains_plain(table, cx, cy, code), "geo_contains@column")
    report.add("geo_contains@column", "cuda", "presto_tpu_torch/csrc/geo_contains.cu", err,
               cuda_ms(lambda: k18.geo_contains(table, cx, cy, code), 5),
               cuda_ms(lambda: k18.geo_contains_plain(table, cx, cy, code), 1, warmup=0),
               nbytes(cx, cy, code, *got), None, "geo_contains:column",
               bound_ops=k18_ops(table, cx, cy, code))
    log(f"K18 by code: {int(got[0].sum())} of {cx.shape[0]} (zone, trip) rows inside, "
        f"{table.vertices} vertices in {nz} zones")
    del cx, cy, code, got

    def ml_node(label, fn):
        sql = ML_QUERIES[label]
        runner = QueryRunner(query_catalog(mem, sql, tables=tables), device="cuda")
        node = next(n for n in find_all(runner.plan(sql), AggregationNode)
                    if any(a.fn == fn for a in n.aggs))
        page = first_split(runner.executor, node.source)
        agg = next(a for a in node.aggs if a.fn == fn)
        return node, page, agg, ExprCompiler.for_page(page)

    def runs_of(node, page, c):
        key_cols = [c.compile_key(e)(page) for e in node.group_exprs]
        keys = key_tuples(key_cols, [e.type for e in node.group_exprs], node.key_domains)
        got = k6.sorted_group_agg(keys, page.row_mask, [(k6.S_ONE, None, None)], runs=True)
        return got[2], got[3]

    def k19_row(name, groups, kw, addr, counter, library=True):
        got = k19.ml_state(groups=groups, **kw, **addr)
        err = same_bits(got, k19.ml_state_plain(groups=groups, **kw, **addr), name)
        ins = [t for t in list(kw.values()) + list(addr.values()) if torch.is_tensor(t)]
        lib = None
        if library:
            mode = kw["mode"]
            lanes, ok = k19.row_lanes(mode, kw.get("k", 0), kw.get("label"), kw.get("y"),
                                      kw.get("feats"), kw.get("parts"))
            if "slot" in addr:
                at = addr["slot"] if addr["slot"] is not None else torch.zeros_like(
                    kw["sel"], dtype=torch.int64)
            else:  # each sorted position's group
                st = addr["starts"]
                g = torch.repeat_interleave(torch.arange(groups, device=st.device),
                                            st[1:] - st[:-1])
                at = torch.full_like(kw["sel"], groups, dtype=torch.int64)
                at[addr["order"][:int(st[-1])]] = g
            at = torch.where(kw["sel"] & ok & (at >= 0) & (at < groups), at,
                             torch.full_like(at, groups))
            acc = torch.zeros((groups + 1, lanes.shape[1]), dtype=lanes.dtype,
                              device=lanes.device)
            lib = cuda_ms(lambda: acc.index_add_(0, at, lanes), 5)
            del lanes
        report.add(name, "cuda", "presto_tpu_torch/csrc/ml_state.cu", err,
                   cuda_ms(lambda: k19.ml_state(groups=groups, **kw, **addr), 5),
                   cuda_ms(lambda: k19.ml_state_plain(groups=groups, **kw, **addr), 1,
                           warmup=0),
                   nbytes(*ins, *got), lib, counter)
        return got

    # K19 packed-direct: ml_regressor's and ml_classifier's partials
    for label, fn, name in (("ml_regressor", "learn_regressor", "ml_state"),
                            ("ml_classifier", "learn_classifier", "ml_state@classifier")):
        node, page, agg, c = ml_node(label, fn)
        keys, _ = agg_ops.kernel_inputs(page, node.group_exprs, [], node.key_domains)
        slots = int(np.prod([k[3] for k in keys]))
        kw = agg_ops._ml_inputs(c, agg, page)
        cstate = k19_row(name, slots, kw, dict(slot=agg_ops._packed_slots(keys, page.row_mask)),
                         f"ml_state:{k19.MODE_NAMES[kw['mode']]}")[0]
        log(f"{name}: {label}'s first split, {page.capacity} rows in {slots} slots")
    # K19 on the sort path: ml_regressor_supp's partials by l_suppkey, then
    # the merge of two splits' partials
    node, page, agg, c = ml_node("ml_regressor_supp", "learn_regressor")
    groups, (order, starts) = runs_of(node, page, c)
    kw = agg_ops._ml_inputs(c, agg, page)
    k19_row("ml_state@sort", groups, kw, dict(order=order, starts=starts),
            "ml_state:regressor")
    runner = QueryRunner(query_catalog(mem, ML_QUERIES["ml_regressor_supp"], tables=tables),
                         device="cuda")
    parts = []
    for split in range(min(2, mem.num_splits("lineitem"))):
        p = first_split(runner.executor, node.source, split)
        parts.append(agg_ops.grouped_aggregate(p, list(node.group_exprs), [agg],
                                               node.max_groups, node.key_domains,
                                               mode="partial"))
    both = concat_pages_device(parts)
    keys, _, _ = agg_ops.merge_inputs(both, 1, [agg], node.key_domains)
    got = k6.sorted_group_agg(keys, both.row_mask, [(k6.S_ONE, None, None)], runs=True)
    mgroups, (morder, mstarts) = got[2], got[3]
    mkw = dict(mode=k19.MERGE, sel=both.row_mask, parts=both.blocks[1].data,
               counts=both.blocks[2].data)
    merged = k19_row("ml_state@merge", mgroups, mkw, dict(order=morder, starts=mstarts),
                     "ml_state:merge")
    log(f"K19 sort path: {groups} suppliers in the first split; the merge of "
        f"{int(both.row_mask.sum())} partial rows into {mgroups}")
    # K20 over the merged supplier states and ml_classifier's states
    state = merged[0]
    dim = 4
    a = state[:, 1:1 + dim * dim].reshape(-1, dim, dim) + 1e-8 * torch.eye(
        dim, dtype=torch.float64, device=state.device)
    b = state[:, 1 + dim * dim:1 + dim * dim + dim, None]
    rows = {"ml_finalize": (k20.REGRESSOR, state, lambda: torch.linalg.solve(a, b)),
            "ml_finalize@classifier": (k20.CLASSIFIER, cstate, None)}
    for name, (mode, st, library) in rows.items():
        got = k20.ml_finalize(mode, st, 3)
        err = same_bits(got, k20.ml_finalize_plain(mode, st, 3), name)
        report.add(name, "cuda", "presto_tpu_torch/csrc/ml_finalize.cu", err,
                   cuda_ms(lambda: k20.ml_finalize(mode, st, 3), 10),
                   cuda_ms(lambda: k20.ml_finalize_plain(mode, st, 3), 1),
                   nbytes(st, got), None if library is None else cuda_ms(library, 10),
                   f"ml_finalize:{('regressor', 'classifier')[mode]}")
        log(f"{name}: {st.shape[0]} groups")
    # K19's evaluate and K12's CLASSIFY over ml_evaluate's rows, REGRESS
    # over ml_regress'
    node, page, agg, c = ml_node("ml_evaluate", "evaluate_classifier_predictions")
    kw = agg_ops._ml_inputs(c, agg, page)
    k19_row("ml_state@evaluate", 1, kw, dict(slot=None), "ml_state:evaluate")
    call = next(x for x in calls_in(agg.arg2) if x.fn == "classify")
    (md, mv), (fd, fv) = (c.compile(e)(page) for e in call.args)
    p = [3, 8, 1]
    got = k12.container_eval(k12.CLASSIFY, md, mv, b=fd, bv=fv, p=p)
    want = k12.plain(k12.CLASSIFY, md, mv, b=fd, bv=fv, p=p)
    ll = k12.classify_ll_plain(md, fd, 3, 8)
    top2 = torch.topk(ll, 2, 1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= 4 * torch.abs(torch.nextafter(
        top2[:, 0], torch.full_like(top2[:, 0], float("inf"))) - top2[:, 0])
    same(got[1], want[1], "container_eval@classify valid")
    if not torch.equal(got[0][~near], want[0][~near]):
        raise AssertionError("container_eval@classify: classes differ off the near ties")
    gap = ulp_gap(got[2], want[2])
    if gap > 2:
        raise AssertionError(f"container_eval@classify: log-likelihoods {gap} ulp apart")
    report.add("container_eval@classify", "cuda", "presto_tpu_torch/csrc/container_eval.cu",
               float((got[2] - want[2]).abs().max()),
               cuda_ms(lambda: k12.container_eval(k12.CLASSIFY, md, mv, b=fd, bv=fv, p=p), 5),
               cuda_ms(lambda: k12.plain(k12.CLASSIFY, md, mv, b=fd, bv=fv, p=p), 1),
               nbytes(md, mv, fd, fv, *got), None, "container_eval:classify")
    log(f"CLASSIFY over {md.shape[0]} rows: max_ulp {gap}, {int(near.sum())} rows with their "
        f"two best log-likelihoods within 4 ulp, {int((got[0] != want[0]).sum())} classes "
        "differ from the twin's")
    node, page, agg, c = ml_node("ml_regress", "avg")
    call = next(x for x in calls_in(agg.arg) if x.fn == "regress")
    (md, mv), (fd, fv) = (c.compile(e)(page) for e in call.args)
    p = [3, 8]
    got = k12.container_eval(k12.REGRESS, md, mv, b=fd, bv=fv, p=p)
    err = same_bits(got, k12.plain(k12.REGRESS, md, mv, b=fd, bv=fv, p=p),
                    "container_eval@regress")
    report.add("container_eval@regress", "cuda", "presto_tpu_torch/csrc/container_eval.cu",
               err, cuda_ms(lambda: k12.container_eval(k12.REGRESS, md, mv, b=fd, bv=fv, p=p),
                            10),
               cuda_ms(lambda: k12.plain(k12.REGRESS, md, mv, b=fd, bv=fv, p=p), 1),
               nbytes(md, mv, fd, fv, *got), None, "container_eval:regress")


def dist_runner(conn, sql: str, joins: str = "AUTOMATIC"):
    """A QueryRunner over ``sql``'s columns of ``conn`` that runs on the
    mesh tier: DIST_SHARDS shards of the card, joins distributed as
    ``joins`` says (join_distribution_type)."""
    from presto_tpu_torch.runner import QueryRunner

    r = QueryRunner(query_catalog(conn, sql), device=conn.device)
    for stmt in ("SET SESSION distributed = true",
                 f"SET SESSION hash_partition_count = {DIST_SHARDS}",
                 f"SET SESSION join_distribution_type = '{joins}'"):
        r.execute(stmt)
    return r


def check_mesh_kernels(report: KernelReport, mem) -> None:
    """Phase 3, the sixteenth slice, each exactly against its plain
    version: K21 exchange_partition over a whole lineitem split keyed by
    l_orderkey (packed over its domain), 8 parts, every column of the
    split, at a bucket_cap of the fill and of half of it (rows dropped);
    K22 merge_sorted over two of DIST_ORDER_SQL's per-shard sorted runs
    (the mesh tier's own sort stage producing them)."""
    from presto_tpu_torch.expr.ir import ColumnRef
    from presto_tpu_torch.kernels import exchange_partition as k21
    from presto_tpu_torch.kernels import merge_sorted as k22
    from presto_tpu_torch.ops.merge import merge_keys_for_pages
    from presto_tpu_torch.parallel.exchange import partition_key
    from presto_tpu_torch.planner.plan import SortNode

    page = mem.page_for_split("lineitem", 0)
    names = [c for c, _ in mem.schema("lineitem")]
    i = names.index("l_orderkey")
    key = partition_key(page, [ColumnRef(type=page.blocks[i].type, index=i)],
                        [mem.column_domain("lineitem", "l_orderkey")])
    mask = page.row_mask
    cols = [(b.data, b.valid) for b in page.blocks]
    parts = DIST_SHARDS
    t = k21.targets_plain(key, mask, parts).to(torch.int64)
    counts = torch.bincount(t, minlength=parts + 1)
    fill = int(counts[:parts].max())
    for name, cap in (("exchange_partition", fill), ("exchange_partition@half", fill // 2)):
        got = k21.exchange_partition(key, mask, parts, cap, cols)
        want = k21.partition_plain(key, None, mask, parts, cap, cols)
        err = max(same(got[0], want[0], f"{name} columns"), same(got[1], want[1], f"{name} mask"),
                  same(got[2], want[2], f"{name} fill"))
        if int(got[2]) != fill:
            raise AssertionError(f"{name}: fill {int(got[2])} != {fill}")
        ms = cuda_ms(lambda: k21.exchange_partition(key, mask, parts, cap, cols), 20)
        plain = cuda_ms(lambda: k21.partition_plain(key, None, mask, parts, cap, cols), 3)
        # the library chain for the same layout: a stable sort of the
        # targets, their counts, one index_put_ of each column (the
        # destination slots computed beforehand)
        order = torch.sort(t, stable=True).indices
        st = t[order]
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(t.shape[0], device=t.device) - starts[st]
        keep = (st < parts) & (slot < cap)
        dest = (st * cap + slot)[keep]
        outs = [(torch.zeros_like(od), torch.zeros_like(ov)) for od, ov in got[0]]

        def library():
            o = torch.sort(t, stable=True).indices
            torch.bincount(t, minlength=parts + 1)
            src = o[keep]
            for (d, v), (od, ov) in zip(cols, outs):
                od.index_put_((dest,), d[src])
                ov.index_put_((dest,), v[src])

        library_ms = cuda_ms(library, 5)
        moved = nbytes(key, mask, *[x for c in cols for x in c]) + nbytes(
            *[x for c in got[0] for x in c], got[1]) + 4
        report.add(name, "cuda", "presto_tpu_torch/csrc/exchange_partition.cu", err, ms, plain,
                   moved, library_ms, "exchange_partition")
        log(f"{name}: {int(mask.sum())} live rows of {mask.shape[0]} into {parts} x {cap}, "
            f"fill {fill}, {int(want[1].sum())} kept")

    # K22 over two of the ORDER BY's per-shard runs, made by the mesh
    # tier's sort stage (each shard's sorted wave output)
    runner = dist_runner(mem, DIST_ORDER_SQL)
    dist = runner._distributed()
    sort = find(runner.plan(DIST_ORDER_SQL), SortNode)
    runs = dist._run_chain_stage_once(sort.source, dist._stage_source(sort.source), sort=sort)
    runs = sorted(runs, key=lambda r: -int(r.row_mask.sum()))[:2]
    ka, kb = merge_keys_for_pages(runs, list(sort.sort_exprs), list(sort.ascending),
                                  sort.nulls_first)
    a = ([(b.data, b.valid) for b in runs[0].blocks], runs[0].row_mask, ka)
    b = ([(x.data, x.valid) for x in runs[1].blocks], runs[1].row_mask, kb)
    err = same(k22.merge_sorted(a, b), k22.merge_sorted_plain(a, b), "merge_sorted")
    ms = cuda_ms(lambda: k22.merge_sorted(a, b), 20)
    plain = cuda_ms(lambda: k22.merge_sorted_plain(a, b), 5)
    na, nb = ka.shape[0], kb.shape[0]
    outs = [torch.empty((na + nb,) + tuple(d.shape[1:]), dtype=d.dtype, device=d.device)
            for d, _ in a[0]]

    def library():
        pa = torch.searchsorted(kb, ka) + torch.arange(na, device=ka.device)
        pb = torch.searchsorted(ka, kb, right=True) + torch.arange(nb, device=kb.device)
        for (da, _), (db, _), o in zip(a[0], b[0], outs):
            o.index_put_((pa,), da)
            o.index_put_((pb,), db)

    library_ms = cuda_ms(library, 10)
    # each row read and written once; the binary searches' probes (log2
    # of the other run, 8 bytes each) are logged beside it: their upper
    # levels are shared by neighbouring rows and stay in cache
    probes = 8 * (na * max(nb, 1).bit_length() + nb * max(na, 1).bit_length())
    moved = 2 * nbytes(*[x for run in (a, b) for c in run[0] for x in c], a[1], a[2], b[1],
                       b[2])
    report.add("merge_sorted", "cuda", "presto_tpu_torch/csrc/merge_sorted.cu", err, ms, plain,
               moved, library_ms, "merge_sorted")
    log(f"merge_sorted: runs of {na} and {nb} rows ({int(a[1].sum())} and {int(b[1].sum())} "
        f"live), {len(a[0])} columns; {moved} bytes once, {probes} bytes of search probes "
        f"({probes / HBM_BYTES_PER_S * 1e3:.4f} ms if none were cached)")


def check_dist_rows(label, got, want, ordered: bool = False) -> None:
    """A mesh query's rows against the local port's: integers, decimals
    and strings exactly, doubles within a relative 1e-12; in order where
    the query orders them."""
    import math

    def key(row):
        return tuple((0, 0) if v is None else (1, round(v, 6) if isinstance(v, float) else v)
                     for v in row)

    g, w = got.rows, want.rows
    if len(g) != len(w) or not w:
        raise AssertionError(f"{label}: {len(g)} mesh rows, {len(w)} local rows")
    if not ordered:
        g, w = sorted(g, key=key), sorted(w, key=key)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            ok = math.isclose(x, y, rel_tol=1e-12, abs_tol=0) if isinstance(x, float) \
                and isinstance(y, float) else x == y
            if not ok:
                raise AssertionError(f"{label}: mesh row {a} != local row {b}")


def run_distributed_phase(mem, results, launches, wall, required=None) -> None:
    """The mesh tier over the resident SF10 tables: DIST_QUERIES on
    DIST_SHARDS shards of the card, and DIST_ORDER_SQL on the local
    runner under distributed_sort, each counted (every launch counter
    at 0 just before its run); each mesh query distributed (no
    fallback, at least one stage), its rows equal to the local port's
    on the card, and K21 and K22 launched in the phase."""
    from presto_tpu_torch.runner import QueryRunner

    required = DIST_REQUIRED if required is None else required
    runners = {label: dist_runner(mem, sql, joins)
               for label, (sql, joins) in DIST_QUERIES.items()}
    runners["local_sort"] = QueryRunner(query_catalog(mem, DIST_ORDER_SQL), device=mem.device)
    runners["local_sort"].execute("SET SESSION distributed_sort = true")
    queries = {**{label: sql for label, (sql, _) in DIST_QUERIES.items()},
               "local_sort": DIST_ORDER_SQL}
    run_counted(runners, queries, required, launches, results, wall)
    for label in DIST_QUERIES:
        out = results[label]
        if out.dist_fallback is not None or out.dist_stages < 1:
            raise AssertionError(f"{label}: not distributed ({out.dist_fallback}, "
                                 f"{out.dist_stages} stages)")
    local = {label: results[base] for label, base in DIST_LOCAL.items()}
    for label, (sql, _) in DIST_QUERIES.items():
        if label not in local:
            t0 = time.perf_counter()
            r = QueryRunner(query_catalog(mem, sql), device=mem.device)
            r.execute("SET SESSION distributed_sort = false")  # one sort of the concatenation
            local[label] = r.execute(sql)
            log(f"{label} on the local runner: {len(local[label].rows)} rows in "
                f"{time.perf_counter() - t0:.2f} s")
    local["local_sort"] = local["dist_order"]
    for label in queries:
        check_dist_rows(label, results[label], local[label],
                        ordered=label in ("dist_order", "local_sort"))
        stages = getattr(results[label], "dist_stages", None)
        log(f"{label}: {len(results[label].rows)} rows equal the local port's on the card; "
            f"{'' if stages is None else f'{stages} mesh stages, '}wall "
            f"{wall[label][0] * 1e3:.2f} ms; {results[label].rows[:3]}")
    moved = {k: sum(launches[q].get(k, 0) for q in queries)
             for k in ("exchange_partition", "merge_sorted")}
    log(f"distributed phase launches: {moved}")
    if not all(moved.values()):
        raise AssertionError(f"distributed phase: K21 or K22 never launched: {moved}")
    dist_walls(runners, queries, wall)


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


def classify_near_ties(conn, tables) -> int:
    """The rows of ml_evaluate over ``conn`` whose two best
    log-likelihoods under its model lie within 4 ulp (where the card's
    log and the CPU's may pick different classes)."""
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.planner.plan import AggregationNode
    from presto_tpu_torch.runner import QueryRunner

    sql = ML_QUERIES["ml_evaluate"]
    runner = QueryRunner(query_catalog(conn, sql, tables=tables), device=conn.device)
    node = next(n for n in find_all(runner.plan(sql), AggregationNode)
                if any(a.fn == "evaluate_classifier_predictions" for a in n.aggs))
    call = next(x for a in node.aggs for x in calls_in(a.arg2) if x.fn == "classify")
    near = 0
    for split in range(conn.num_splits("lineitem")):
        page = first_split(runner.executor, node.source, split)
        c = ExprCompiler.for_page(page)
        (md, _), (fd, _) = (c.compile(e)(page) for e in call.args)
        top2 = torch.topk(k12.classify_ll_plain(md, fd, 3, 8), 2, 1).values
        gap = torch.abs(torch.nextafter(top2[:, 0], torch.full_like(top2[:, 0],
                                                                    float("inf"))) - top2[:, 0])
        near += int(((top2[:, 0] - top2[:, 1]).abs() <= 4 * gap)[page.row_mask].sum())
    return near


def check_evaluate_rows(label, got, ref, near: int, where: str = "") -> None:
    """evaluate_classifier_predictions' text: exact, or, where ``near``
    rows lie at a near tie, each count within ``near`` of the CPU's."""
    import re

    label += where
    if len(got.rows) != len(ref.rows) or not ref.rows:
        raise AssertionError(f"{label}: {len(got.rows)} card rows, {len(ref.rows)} CPU rows")
    for g, r in zip(got.rows, ref.rows):
        if g == r:
            continue
        pairs = [re.findall(r"(\d+)/(\d+)", x[0]) for x in (g, r)]
        if near == 0 or len(pairs[0]) != len(pairs[1]) or any(
                abs(int(a) - int(b)) > near for pa, pb in zip(*pairs)
                for a, b in zip(pa, pb)):
            raise AssertionError(f"{label}: card row {g} != CPU row {r} ({near} near ties)")
        log(f"{label}: the card's counts differ from the CPU's within the {near} near ties")


def ml_path_walls(runner, sql: str, rounds: int = 3) -> dict:
    """ml_regressor's wall on its packed-direct path (K19 over K2's
    slots) and with its ML states forced onto the sort path (K6's runs,
    K19 over them), interleaved packed, sort, sort, packed ``rounds``
    times.  The sort runs must launch K6 and no K2, and both paths give
    the same groups and counts."""
    from unittest import mock

    from presto_tpu_torch.ops import aggregate as agg_ops

    walls, rows = {"packed": [], "sort": []}, {}
    for path in ("packed", "sort", "sort", "packed") * rounds:
        force = mock.patch.object(agg_ops, "_ml_direct", lambda *a: False) \
            if path == "sort" else contextlib.nullcontext()
        with force:
            reset_counts()
            t0 = time.perf_counter()
            got = runner.execute(sql)
            walls[path].append(time.perf_counter() - t0)
            c = read_counts()
        if path == "sort" and (c["sorted_group_agg"] == 0 or c["packed_group_agg"] != 0
                               or c["ml_state"] == 0):
            raise AssertionError(f"ml_regressor forced onto the sort path launched {c}")
        rows[path] = [(r[0], r[1], r[3]) for r in got.rows]
    if rows["packed"] != rows["sort"]:
        raise AssertionError(f"ml_regressor's groups differ across the paths: {rows}")
    out = {p: statistics.median(w) * 1e3 for p, w in walls.items()}
    log(f"ml_regressor by path: packed-direct {out['packed']:.2f} ms, sort path "
        f"{out['sort']:.2f} ms (medians of {2 * rounds}; packed "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls['packed'])}; sort "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls['sort'])})")
    return out


def ab_walls(label, runner, sql: str, modes: dict, check, rounds: int = 2) -> dict:
    """``sql``'s wall under each of two ``modes`` (name -> a function
    that puts ``runner`` in that mode), interleaved a, b, b, a
    ``rounds`` times after one warm run of each; ``check(mode, result,
    launches)`` holds every run, and both modes give the same rows."""
    (a, set_a), (b, set_b) = modes.items()
    walls, rows = {a: [], b: []}, {}
    for mode, put in ((a, set_a), (b, set_b)):
        put()
        runner.execute(sql)
    torch.cuda.synchronize()
    for mode in (a, b, b, a) * rounds:
        modes[mode]()
        reset_counts()
        t0 = time.perf_counter()
        got = runner.execute(sql)
        walls[mode].append(time.perf_counter() - t0)
        check(mode, got, read_counts())
        rows[mode] = got.rows
    if rows[a] != rows[b]:
        raise AssertionError(f"{label}: the rows differ between {a} and {b}")
    out = {m: statistics.median(w) * 1e3 for m, w in walls.items()}
    log(f"{label} by mode: {a} {out[a]:.2f} ms, {b} {out[b]:.2f} ms (medians of "
        f"{2 * rounds}; " + "; ".join(f"{m} " + ", ".join(f"{w * 1e3:.2f}" for w in walls[m])
                                      for m in (a, b)) + ")")
    return out


def merge_path_walls(runner, label: str, sql: str) -> dict:
    """A main-path ORDER BY over more than one page under the session's
    distributed_sort (each page sorted, the runs merged on K22) and
    without it (one sort of the concatenation), interleaved; the merge
    runs launch K22, the others do not."""
    def put(on):
        return lambda: runner.execute(f"SET SESSION distributed_sort = {str(on).lower()}")

    def check(mode, got, c):
        if (c["merge_sorted"] > 0) != (mode == "merge"):
            raise AssertionError(f"{label} ({mode}): K22 launched {c['merge_sorted']} times")

    out = ab_walls(label, runner, sql, {"merge": put(True), "one_sort": put(False)}, check)
    runner.execute("SET SESSION distributed_sort = true")
    return out


def dist_walls(runners, queries, wall, reps: int = 3) -> None:
    """Each phase query ``reps`` more times after its counted run: the
    median of the counted run and these."""
    for label, sql in queries.items():
        for _ in range(reps):
            t0 = time.perf_counter()
            runners[label].execute(sql)
            wall[label].append(time.perf_counter() - t0)
        log(f"{label}: wall {statistics.median(wall[label]) * 1e3:.2f} ms median of "
            f"{len(wall[label])} ({', '.join(f'{w * 1e3:.2f}' for w in wall[label])})")


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
    """One traced run of ``sql``: device-busy share of its wall time,
    the device time of its heaviest kernels (torch.profiler) and the
    port's kernels the run launched (the launch counters, set to 0 just
    before it and read just after), and those of them the trace does
    not show (the profiler misses some of this port's launches in a
    few queries, `PERF.md` §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        wall_us = (time.perf_counter() - t0) * 1e6
    counts = read_counts()
    counted = ", ".join(f"{k} {n}" for k, n in counts.items() if n)
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
        return ("device time not measured (the profiler saw no device activity); "
                f"launched: {counted}")
    busy = sum(us for us, _, _ in rows)
    top = ", ".join(f"{k} {us / 1e3:.3f} ms x{c}" for us, k, c in sorted(rows, reverse=True)[:6])
    untraced = [k for k, prefixes in KERNEL_SYMBOLS.items() if counts.get(k) and not any(
        name.removeprefix("void ").startswith(prefixes) for _, name, _ in rows)]
    return (f"traced wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.3f} ms "
            f"({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%); {top}; "
            f"launched: {counted}; launched but not traced: {', '.join(untraced) or 'none'}")


# each counted kernel's symbol prefixes in csrc/ (a trace row's name
# starts with the symbol, after "void " for a template)
KERNEL_SYMBOLS = {
    "expr_eval": ("k1_",), "packed_group_agg": ("k2_",),
    "packed_fold_finalize": ("k3_",), "join_build": ("k4_",), "join_probe": ("k5_",),
    "sorted_group_agg": ("k6_",), "topn": ("k7_",), "join_expand": ("k8_",),
    "hash_keys": ("k9_", "pk_"), "window_eval": ("k10_",), "spill_partition": ("k11_",),
    "container_eval": ("k12_",), "unnest_expand": ("k13_",),
    "group_collect": ("k14_",), "group_topn": ("k15_",), "kmv_lanes": ("k16_",),
    "raw_string_eval": ("k17_",), "geo_contains": ("k18_",), "ml_state": ("k19_",),
    "ml_finalize": ("k20_",), "exchange_partition": ("k21_",), "merge_sorted": ("k22_",)}


def counters():
    from presto_tpu_torch.kernels import (
        container_eval, exchange_partition, expr_eval, geo_contains, group_collect, group_topn,
        join_build, join_expand, join_probe, keys, kmv_lanes, merge_sorted, ml_finalize,
        ml_state, packed_fold_finalize, packed_group_agg, raw_string_eval, sorted_group_agg,
        spill_partition, topn, unnest_expand, window_eval,
    )

    return {"expr_eval": expr_eval, "packed_group_agg": packed_group_agg,
            "packed_fold_finalize": packed_fold_finalize, "join_build": join_build,
            "join_probe": join_probe, "sorted_group_agg": sorted_group_agg, "topn": topn,
            "join_expand": join_expand, "hash_keys": keys, "window_eval": window_eval,
            "spill_partition": spill_partition, "container_eval": container_eval,
            "unnest_expand": unnest_expand, "group_collect": group_collect,
            "group_topn": group_topn, "kmv_lanes": kmv_lanes, "raw_string_eval": raw_string_eval,
            "geo_contains": geo_contains, "ml_state": ml_state, "ml_finalize": ml_finalize,
            "exchange_partition": exchange_partition, "merge_sorted": merge_sorted}


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
              ("group_collect", "merge_launches", "group_collect:merge"),
              ("hash_keys", "narrow_launches", "hash_keys:narrow"),
              ("topn", "real_launches", "topn:real"),
              ("window_eval", "narrow_launches", "window_eval:narrow"),
              ("group_topn", "merge_launches", "group_topn:merge"),
              ("kmv_lanes", "merge_launches", "kmv_lanes:merge"),
              ("group_collect", "wide_launches", "group_collect:wide"),
              ("group_collect", "union_launches", "group_collect:union"),
              ("topn", "d38_launches", "topn:d38"),
              ("topn", "lanes_launches", "topn:lanes"),
              ("window_eval", "lanes_launches", "window_eval:lanes"),
              ("geo_contains", "column_launches", "geo_contains:column"))


# kernels that count their launches by kind in a dict, by its attribute
KIND_DICTS = (("join_probe", "kind_launches"), ("expr_eval", "op_launches"),
              ("packed_group_agg", "kind_launches"), ("sorted_group_agg", "kind_launches"),
              ("packed_fold_finalize", "kind_launches"), ("container_eval", "op_launches"),
              ("raw_string_eval", "mode_launches"), ("ml_state", "mode_launches"),
              ("ml_finalize", "mode_launches"))


def reset_counts() -> None:
    mods = counters()
    for mod in mods.values():
        mod.launches = 0
    for kernel, attr in KIND_DICTS:
        getattr(mods[kernel], attr).clear()
    for kernel, attr, _ in SUB_COUNTS:
        setattr(mods[kernel], attr, 0)
    from presto_tpu_torch.ops import sort

    sort.sorted_topn_runs = 0


def read_counts() -> dict:
    from presto_tpu_torch.ops import sort

    mods = counters()
    out = {k: mod.launches for k, mod in mods.items()}
    for kernel, attr in KIND_DICTS:
        for kind, n in getattr(mods[kernel], attr).items():
            out[f"{kernel}:{kind}"] = n
    for kernel, attr, name in SUB_COUNTS:
        out[name] = getattr(mods[kernel], attr)
    # ORDER BY ... LIMIT past K7's MAX_N: the page sorted (torch.sort),
    # no kernel of its own
    out["topn:sorted"] = sort.sorted_topn_runs
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
    ds2_cols = ds_tables({**DS2_QUERIES, **DS3_QUERIES,
                          **{q: DS_QUERIES[q] for q in DS_CHECK_AT_CHECK_SF}})
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
    check_type_kernels(report, mem)
    check_sketch_kernels(report, mem)
    check_decimal38_kernels(report, mem)
    t0 = time.perf_counter()
    make_raw_tables(mem)
    torch.cuda.synchronize()
    log(f"raw tables on the card in {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{t} {mem.row_count(t)} rows" for t in RAW_TABLES)
        + f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check_rawstring_kernels(report, mem)
    t0 = time.perf_counter()
    make_geo_tables(mem)
    torch.cuda.synchronize()
    log(f"geo tables on the card in {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{t} {mem.row_count(t)} rows" for t in GEO_TABLES))
    check_ml_geo_kernels(report, mem)
    check_mesh_kernels(report, mem)
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
    # the types phase over the same tables
    ty_runners = {label: QueryRunner(query_catalog(mem, sql), device="cuda")
                  for label, sql in TY_QUERIES.items()}
    drive(ty_runners, TY_QUERIES, TY_REQUIRED, reps=2, trace=False)
    del ty_runners
    gc.collect()
    torch.cuda.empty_cache()
    log(f"types phase done at {time.perf_counter() - t_all:.1f} s")
    # the sketch and heap aggregates over the same tables, traced
    sk_runners = {label: QueryRunner(query_catalog(mem, sql), device="cuda")
                  for label, sql in SK_QUERIES.items()}
    drive(sk_runners, SK_QUERIES, SK_REQUIRED)
    del sk_runners
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sketch phase done at {time.perf_counter() - t_all:.1f} s")
    # the wide decimals over lineitem_d38 at SF10, traced; the table
    # leaves the card after the phase
    t0 = time.perf_counter()
    make_lineitem_d38(mem)
    torch.cuda.synchronize()
    log(f"{D38_TABLE} on the card in {time.perf_counter() - t0:.1f} s: "
        f"{mem.row_count(D38_TABLE)} rows, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    d38_tables = {**TABLES, D38_TABLE: [c for c, _ in mem.schema(D38_TABLE)]}
    d38_runners = {label: QueryRunner(query_catalog(mem, sql, tables=d38_tables),
                                      device="cuda") for label, sql in D38_QUERIES.items()}
    drive(d38_runners, D38_QUERIES, D38_REQUIRED, reps=2)
    del d38_runners
    mem.drop_table(D38_TABLE)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"wide decimals phase done at {time.perf_counter() - t_all:.1f} s")
    # the raw varchar phase over the SF10 tables' raw copies (made in
    # phase 3), traced; the copies leave the card after it
    raw_tables = raw_query_tables(mem)
    raw_runners = {label: QueryRunner(query_catalog(mem, sql, tables=raw_tables),
                                      device="cuda") for label, sql in RAW_QUERIES.items()}
    drive(raw_runners, RAW_QUERIES, RAW_REQUIRED, reps=1)
    del raw_runners
    for t in RAW_TABLES:
        mem.drop_table(t)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"raw varchar phase done at {time.perf_counter() - t_all:.1f} s")
    # the ML aggregates over the SF10 lineitem and the geospatial functions
    # over the zones and trips (made in phase 3), traced; the geo tables
    # leave the card after it
    mg_tables = {**TABLES, **GEO_TABLES}
    mg_runners = {label: QueryRunner(query_catalog(mem, sql, tables=mg_tables), device="cuda")
                  for label, sql in ML_GEO_QUERIES.items()}
    drive(mg_runners, ML_GEO_QUERIES, ML_GEO_REQUIRED, reps=1)
    ml_path_walls(mg_runners["ml_regressor"], ML_GEO_QUERIES["ml_regressor"])
    del mg_runners
    for t in GEO_TABLES:
        mem.drop_table(t)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ml_geo phase done at {time.perf_counter() - t_all:.1f} s")
    # the spill phase over the same SF10 tables, before they leave
    run_spill_phase(mem, launches, spill_wall)
    log(f"spill phase done at {time.perf_counter() - t_all:.1f} s")
    # the mesh tier over the same SF10 tables: DIST_SHARDS shards of the card
    run_distributed_phase(mem, results, launches, wall)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"distributed phase done at {time.perf_counter() - t_all:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del runner, runners, catalog, mem
    gc.collect()
    torch.cuda.empty_cache()
    drive(ds_runners, DS_QUERIES, DS_REQUIRED)
    merge_path_walls(ds_runners["ds_q51"], "ds_q51", DS_QUERIES["ds_q51"])
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
    for label, sql in {**FN_QUERIES, **DT_QUERIES, **CT_QUERIES, **TY_QUERIES,
                       **SK_QUERIES}.items():
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_check, sql), device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_check, sql), device="cpu").execute(sql)
        check_fn_rows(label, got, ref, f" at sf={TPCH_CHECK_SF}")
        log(f"{label} at sf={TPCH_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    # the wide decimals at TPCH_CHECK_SF: lineitem_d38 built on both sides
    make_lineitem_d38(mem_check)
    make_lineitem_d38(host_check)
    for label, sql in D38_QUERIES.items():
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_check, sql, tables=d38_tables),
                          device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_check, sql, tables=d38_tables),
                          device="cpu").execute(sql)
        check_fn_rows(label, got, ref, f" at sf={TPCH_CHECK_SF}")
        log(f"{label} at sf={TPCH_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    # the raw varchar queries at TPCH_CHECK_SF: the raw copies built on both sides
    make_raw_tables(mem_check)
    make_raw_tables(host_check)
    for label, sql in RAW_QUERIES.items():
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_check, sql, tables=raw_tables),
                          device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_check, sql, tables=raw_tables),
                          device="cpu").execute(sql)
        check_fn_rows(label, got, ref, f" at sf={TPCH_CHECK_SF}")
        log(f"{label} at sf={TPCH_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    # the ML and geo queries at TPCH_CHECK_SF, the point tables at
    # 1/GEO_CHECK_DIV: the geo tables built on both sides
    make_geo_tables(mem_check, GEO_CHECK_DIV)
    make_geo_tables(host_check, GEO_CHECK_DIV)
    near = classify_near_ties(mem_check, mg_tables)
    log(f"ml_evaluate at sf={TPCH_CHECK_SF}: {near} rows with their two best "
        "log-likelihoods within 4 ulp")
    for label, sql in ML_GEO_QUERIES.items():
        t1 = time.perf_counter()
        got = QueryRunner(query_catalog(mem_check, sql, tables=mg_tables),
                          device="cuda").execute(sql)
        ref = QueryRunner(query_catalog(host_check, sql, tables=mg_tables),
                          device="cpu").execute(sql)
        if label == "ml_evaluate":
            check_evaluate_rows(label, got, ref, near, f" at sf={TPCH_CHECK_SF}")
        else:
            check_fn_rows(label, got, ref, f" at sf={TPCH_CHECK_SF}")
        log(f"{label} at sf={TPCH_CHECK_SF}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s)")
    # the host's tables leave as their checks end: the CPU runs of the
    # TPC-DS checks need the room (those at SF10 most)
    del host_check, mem_check, cat_check
    release_host_memory()
    # the sixth and seventh slices (and DS_CHECK_AT_CHECK_SF) at
    # DS_CHECK_SF: the card runs their queries again over those tables,
    # the CPU once
    for label, sql in {**DS2_QUERIES, **DS3_QUERIES,
                       **{q: DS_QUERIES[q] for q in DS_CHECK_AT_CHECK_SF}}.items():
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
        if label in DS_CHECK_AT_CHECK_SF:
            continue
        t1 = time.perf_counter()
        ref = QueryRunner(query_catalog(host_ds, sql, tables=ds_cols, name="tpcds"),
                          device="cpu").execute(sql)
        check_rows(label, results[label], ref)
        log(f"{label}: {len(ref.rows)} rows equal the CPU run's "
            f"({time.perf_counter() - t1:.1f} s on the CPU)")
    log(f"rows equal the CPU run ({time.perf_counter() - t0:.1f} s)")
    for label in list(QUERIES) + list(FN_QUERIES) + list(DT_QUERIES) + list(CT_QUERIES) \
            + list(TY_QUERIES) + list(SK_QUERIES) + list(D38_QUERIES) + list(RAW_QUERIES) \
            + list(ML_GEO_QUERIES) + list(DS_QUERIES) + list(DS2_QUERIES) + list(DS3_QUERIES):
        med = statistics.median(wall[label])
        fact, rows = ("lineitem", lineitem_rows) if label in QUERIES or label in FN_QUERIES \
            or label in DT_QUERIES or label in CT_QUERIES or label in TY_QUERIES \
            or label in SK_QUERIES or label in RAW_QUERIES or label in ML_QUERIES \
            else (D38_TABLE, lineitem_rows) if label in D38_QUERIES \
            else ("trips", GEO_TRIPS) if label in GEO_QUERIES \
            else ("store_sales", host_ds.row_count("store_sales"))
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
