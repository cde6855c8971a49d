"""The twelfth slice's SQL through the port's ``QueryRunner`` on the CPU
against the reference's: the sketch and heap aggregates of
``tests/test_function_breadth.py`` (:399-:700: approx_set with
cardinality and ``merge``, multimap_agg, map_union, max/min(x, n),
max_by/min_by(x, y, n)) and ``tests/test_setdigest.py`` (:37-:104:
make_set_digest, merge_set_digest, the digest's cardinality,
jaccard_index, intersection_cardinality, hash_counts), rewritten over
VALUES or the TPC-H tables where the suites build tables with CREATE
TABLE AS (which the port refuses), and the chip smoke's ``sk_*``
queries at TPC-H sf 0.001.  ``TpchPair``'s 4096-row splits put lineitem
in two splits, so its groupings merge partial states.  Rows are exact
(``tests/oracle.py`` ``assert_rows_match``: doubles within a relative
1e-9; a sketch's estimate is an integer, compared exactly)."""

import pytest

from torch_fn_parity import TpchPair

_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


_TA = ("(select x % 20 + 1 as v from (values 0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,"
       "18,19,20,21,22,23,24) t(x))")
_TB = ("(select x + 11 as v from (values 0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19) "
       "t(x))")
_GRP = "(values (1, 10), (1, 10), (1, 20), (2, 30), (2, 30), (2, 30)) grp(g, v)"
_BIG = ("(select x1 * 100 + x2 as v from (values 0,1,2,3,4,5,6,7,8,9) a(x1), (values "
        + ",".join(str(i) for i in range(100)) + ") b(x2))")

SKETCH_SQL = {
    # tests/test_function_breadth.py :404-:430
    "approx_set": "select cardinality(approx_set(o_custkey)) from orders",
    "approx_set_merge": "select cardinality(merge(s)) from (select o_orderpriority, "
                        "approx_set(o_custkey) as s from orders group by o_orderpriority) t",
    "multimap_agg": "select g, multimap_agg(k, v) from (values (1,1,10),(1,1,11),(1,2,20),"
                    "(2,3,30)) t(g,k,v) group by g order by g",
    # :577-:700
    "map_union_grouped": "select g, map_union(m) from (select g, map_agg(k, v) m from "
                         "(values (1,1,10),(1,2,20),(2,3,30),(2,4,40),(9,5,50)) t(g,k,v) "
                         "group by g, k) group by g order by g",
    "map_union_global": "select map_union(m) from (select map_agg(k, v) m from (values "
                        "(1,10),(2,20)) t(k,v) group by k)",
    "map_union_null_maps": "select a.g, map_union(b.m) from (values (1),(2)) a(g) left join "
                           "(select 1 g, map_agg(k, v) m from (values (1,10),(2,20)) t(k,v) "
                           "group by 1) b on a.g = b.g group by a.g order by a.g",
    "max_n_grouped": "select g, max(x, 2), min(x, 2) from (values (1,5),(1,3),(1,9),(1,1),"
                     "(2,7)) t(g,x) group by g order by g",
    "max_n_nulls_cap": "select max(x, 3) from (values (1),(null),(4),(2),(null)) t(x)",
    "max_n_lineitem": "select max(l_extendedprice, 5) from lineitem",
    "min_n_by_flag": "select l_returnflag, min(l_extendedprice, 3) from lineitem "
                     "group by 1 order by 1",
    "max_by_n": "select g, max_by(x, y, 2), min_by(x, y, 2) from (values (1, 100, 1.0), "
                "(1, 200, 3.0), (1, 300, 2.0), (2, 5, 9.0)) t(g, x, y) group by g order by g",
    "max_by_n_null_x": "select max_by(x, y, 2) from (values (null, 9), (7, 1)) t(x, y)",
    "max_n_many_groups": "select l_orderkey, max(l_extendedprice, 2) from lineitem "
                         "where l_orderkey <= 2000 group by 1 order by 1",
    "map_union_empty_maps": "select map_union(m) from (select map(slice(array[1], 1, 0), "
                            "slice(array[10], 1, 0)) m) t",
    # tests/test_setdigest.py :37-:104
    "digest_exact_below_k": f"select cardinality(make_set_digest(v)) from {_TA}",
    "digest_grouped": f"select g, cardinality(make_set_digest(v)) from {_GRP} group by g "
                      "order by g",
    "hash_counts": f"select map_values(hash_counts(make_set_digest(v))) from {_GRP}",
    "merge_set_digest": f"select cardinality(merge_set_digest(d)) from (select g, "
                        f"make_set_digest(v) as d from {_GRP} group by g)",
    "jaccard_intersection": f"select jaccard_index(da, db), intersection_cardinality(da, db) "
                            f"from (select make_set_digest(v) as da from {_TA}), "
                            f"(select make_set_digest(v) as db from {_TB})",
    "disjoint": f"select jaccard_index(da, db), intersection_cardinality(da, db) from "
                f"(select make_set_digest(v) as da from {_TA}), (select make_set_digest(v - "
                f"1000) as db from {_TA})",
    "identical": f"select jaccard_index(da, db) from (select make_set_digest(v) as da from "
                 f"{_TA}), (select make_set_digest(v) as db from {_TA})",
    "digest_beyond_k": f"select cardinality(make_set_digest(v)) from {_BIG}",
    # the chip smoke's sk_* queries
    "sk_max_n": "select l_suppkey, max(l_extendedprice, 5), min(l_extendedprice, 5) "
                "from lineitem group by l_suppkey order by l_suppkey",
    # l_extendedprice and l_quantity are tied across lineitem's two splits
    "sk_by_n": "select l_returnflag, l_linestatus, max_by(l_orderkey, l_extendedprice, 10), "
               "min_by(l_orderkey, l_quantity, 3) from lineitem group by 1, 2 order by 1, 2",
    "sk_approx_set": "select o_orderpriority, cardinality(approx_set(o_custkey)) from orders "
                     "group by 1 order by 1",
    "sk_digest": "select l_shipmode, cardinality(make_set_digest(l_partkey)) from lineitem "
                 "group by 1 order by 1",
    "sk_jaccard": "select jaccard_index(a, b), intersection_cardinality(a, b), "
                  "cardinality(m) from (select make_set_digest(l_suppkey) a from lineitem "
                  "where l_shipmode = 'AIR'), (select make_set_digest(l_suppkey) b from "
                  "lineitem where l_shipmode = 'RAIL'), (select merge_set_digest(d) m from "
                  "(select l_shipmode, make_set_digest(l_suppkey) d from lineitem group by 1))",
    "sk_multimap": "select l_returnflag, multimap_agg(l_shipmode, l_linenumber) from lineitem "
                   "group by 1 order by 1",
    "sk_map_union": "select l_returnflag, map_union(m) from (select l_returnflag, "
                    "l_suppkey % 50 g, map_agg(l_linenumber, l_quantity) m from lineitem "
                    "group by 1, 2) group by 1 order by 1",
    # no input row, NULL-only keys and groups: NULL states, as the reference's
    "empty_global": "select max(o_totalprice, 3), min_by(o_orderkey, o_totalprice, 2), "
                    "cardinality(make_set_digest(o_custkey)) from orders where o_orderkey < 0",
    "empty_approx_set": "select cardinality(approx_set(o_custkey)) from orders "
                        "where o_orderkey < 0",
    "null_keys_global": "select max(x, 2), max_by(y, x, 2), cardinality(make_set_digest(x)) "
                        "from (select case when y > 5 then y end x, y from (values 1, 2) t(y))",
    "null_keys_grouped": "select g, max(x, 2), max_by(y, x, 2), cardinality(make_set_digest(x)) "
                         "from (select y % 2 g, case when y > 2 then y end x, y from "
                         "(values 1, 2, 3) t(y)) group by g order by g",
    # a digest of a double, a varchar (its dictionary code, as the
    # reference's) and a date, merged across lineitem's two splits
    "digest_types": "select cardinality(make_set_digest(l_extendedprice)), "
                    "cardinality(make_set_digest(l_shipmode)), "
                    "cardinality(make_set_digest(l_shipdate)) from lineitem",
}


@pytest.mark.parametrize("name", sorted(SKETCH_SQL))
def test_sketch_sql_equals_reference(name):
    rows = _pair().check(SKETCH_SQL[name])
    assert rows


def test_suite_values_hold():
    """The suites' own assertions hold on the port: exact digests below
    64 hashes, the jaccard of 1..20 and 11..30, the sketch union equal to
    the global sketch, the top-n lanes in order."""
    port = _pair().port
    assert port.execute(SKETCH_SQL["digest_exact_below_k"]).rows == [(20,)]
    j, ic = port.execute(SKETCH_SQL["jaccard_intersection"]).rows[0]
    assert j == pytest.approx(10 / 30, abs=1e-9) and ic == 10
    assert port.execute(SKETCH_SQL["approx_set_merge"]).rows == \
        port.execute(SKETCH_SQL["approx_set"]).rows
    assert port.execute(SKETCH_SQL["max_n_grouped"]).rows == [(1, [9, 5], [1, 3]),
                                                              (2, [7], [7])]
    assert port.execute(SKETCH_SQL["max_by_n_null_x"]).rows == [([None, 7],)]
    est = port.execute(SKETCH_SQL["digest_beyond_k"]).rows[0][0]
    assert 750 <= est <= 1250, est


def test_topn_ties_keep_the_reference_order():
    """Among equal keys the max forms put the later row in the lower
    lane and the min forms the earlier row (one page: the same merges in
    both packages); -0.0 and 0.0 are equal keys."""
    sql = ("select max_by(x, y, 3), min_by(x, y, 3), max(z, 3), min(z, 3) from (values "
           "(1, 5, 0e0), (2, 5, -0e0), (3, 7, 1e0), (4, 5, 0e0)) t(x, y, z)")
    rows = _pair().check(sql)
    assert rows[0][0] == [3, 4, 2] and rows[0][1] == [1, 2, 4]


# two splits of 26552 and 14570 groups: capacities 32768 and 16384, so
# the reference's tower merges them once, where two pages of one
# capacity would merge twice; the keys mod 5 tie across the splits
TIED_TOWER = ("select (l_orderkey * 8 + l_linenumber) % 30011 g, max_by(l_orderkey * 10 + "
              "l_linenumber, l_quantity % 5, 2), min_by(l_orderkey * 10 + l_linenumber, "
              "l_quantity % 5, 1) from lineitem group by 1 order by 1")


def test_cross_split_ties_keep_the_reference_order():
    """Among keys tied across splits the lanes a group keeps, and their
    order, follow the reference runner's merges: its binary-counter
    tower for a keyed grouping off the packed-direct layout, with pages
    of unequal capacities; its running fold for the flags' packed-direct
    grouping (sk_by_n, in SKETCH_SQL) and for the global aggregate."""
    pair = TpchPair(sf=0.01, split_rows=45000)
    rows = pair.check(TIED_TOWER)
    assert len(rows) == 28247
    assert _pair().check("select max_by(l_orderkey, l_quantity, 7), min_by(l_orderkey, "
                         "l_quantity, 7), max(l_quantity, 9) from lineitem")
