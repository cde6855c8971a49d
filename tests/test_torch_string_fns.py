"""String functions over dictionaries in the port: K1's value tables
(VLUT, DVLUT: length, strpos, codepoint, the JSON sizes, from_base,
date_parse, from_iso8601_date, the edit distances against a literal,
CAST of a varchar column to bigint or double, crc32 / xxhash64 of
``to_utf8``), the boolean predicates (regexp_like, starts_with,
ends_with, is_json_scalar: LUT) and ``try``, against the reference's
``ExprCompiler`` over a page whose dictionary holds numbers that do and
do not parse, JSON, dates, unicode and the empty string, with NULLs and
dead rows; the reference suites' SQL of these families through both
``QueryRunner``s (TPC-H sf 0.001); and what stays out, pinned by name.

Tolerances: exact (valid masks everywhere, data where valid; a CAST
to double bit for bit)."""

import numpy as np
import pytest

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import C, F, L, TpchPair, build
from torch_parity import to_port

VALUES = ["", "a", "abc", "abcd", "ff", "-101", "z", "7", "42", "-9", "1.5e3", "Infinity",
          "NaN", " 7 ", "1_0", "99999999999999999999", "2020-02-29", "1999-01-08",
          "2021-13-01", "[1,2,3]", '{"a":[1,2,3]}', '{"a":5}', '{"a":null}', '"str"', "true",
          "null", "[]", "FRANCE", "ÉTÉ", "ALGERIA", "abcabc", "3.25", "-0.0", "1e309", "abc"]
PAGE_COLUMNS = [("s", "varchar"), ("k", "bigint")]
S = C("s")


def _string_page(seed: int, n: int = 1024):
    import jax.numpy as jnp

    from presto_tpu.page import Block, Dictionary, Page
    from torch_parity import with_nulls_and_dead_rows

    rng = np.random.default_rng(seed)
    blocks = (Block(jnp.asarray(rng.integers(0, len(VALUES), n).astype(np.int32)),
                    jnp.ones(n, jnp.bool_), ref_type("varchar"), Dictionary(VALUES)),
              Block(jnp.asarray(rng.integers(0, 9, n)), jnp.ones(n, jnp.bool_),
                    ref_type("bigint"), None))
    return with_nulls_and_dead_rows(Page(blocks, jnp.ones(n, jnp.bool_)), rng)


def _v(x):
    return L(x, "varchar")


SPECS = {
    "length": F("length", "bigint", S),
    "strpos": F("strpos", "bigint", S, _v("a")),
    "strpos_null_needle": F("strpos", "bigint", S, L(None, "varchar")),
    "codepoint": F("codepoint", "integer", S),
    "json_array_length": F("json_array_length", "bigint", S),
    "json_size": F("json_size", "bigint", S, _v("$.a")),
    "from_base_8": F("from_base", "bigint", S, L(8, "bigint")),
    "from_base_2": F("from_base", "bigint", S, L(2, "bigint")),
    "date_parse": F("date_parse", "timestamp", S, _v("%Y-%m-%d")),
    "from_iso8601_date": F("from_iso8601_date", "date", S),
    "levenshtein_col_lit": F("levenshtein_distance", "bigint", S, _v("abc")),
    "levenshtein_lit_col": F("levenshtein_distance", "bigint", _v("FRANCE"), S),
    "levenshtein_null": F("levenshtein_distance", "bigint", S, L(None, "varchar")),
    "hamming": F("hamming_distance", "bigint", S, _v("abcd")),
    "regexp_like": F("regexp_like", "boolean", S, _v("^[0-9]+$")),
    "starts_with": F("starts_with", "boolean", S, _v("a")),
    "ends_with": F("ends_with", "boolean", S, _v("}")),
    "is_json_scalar": F("is_json_scalar", "boolean", S),
    "cast_bigint": F("cast_bigint", "bigint", S),
    "cast_double": F("cast_double", "double", S),
    "crc32": F("crc32", "bigint", F("to_utf8", "varbinary", S)),
    "xxhash64": F("xxhash64", "bigint", F("to_utf8", "varbinary", S)),
    "try_length": F("try", "bigint", F("length", "bigint", S)),
    "length_of_transform": F("length", "bigint", F("upper", "varchar", S)),
    "cast_of_transform": F("cast_bigint", "bigint", F("substr", "varchar", S, L(1, "bigint"),
                                                      L(2, "bigint"))),
    "strpos_of_literal": F("add", "bigint", F("strpos", "bigint", _v("abcd"), _v("cd")),
                           C("k")),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_string_function_equals_reference(name):
    """The port's K1 twin against the reference's ExprCompiler, exact."""
    spec = SPECS[name]
    ref_page = _string_page(sum(map(ord, name)))
    port_page = to_port(ref_page)
    ref_e = build(spec, ref_ir, ref_type, PAGE_COLUMNS)
    port_e = build(spec, port_ir, port_type, PAGE_COLUMNS)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    live = np.asarray(ref_page.row_mask)
    rd, rv, pd, pv = np.asarray(rd), np.asarray(rv), pd.numpy(), pv.numpy()
    np.testing.assert_array_equal(pv[live], rv[live], err_msg=f"{name} valid")
    ok = live & rv
    if pd.dtype == np.float64:
        np.testing.assert_array_equal(pd[ok].view(np.int64), rd[ok].view(np.int64), name)
    else:
        np.testing.assert_array_equal(pd[ok], rd[ok].astype(pd.dtype), err_msg=name)


def test_unparseable_values_and_null_literals_are_null():
    """A value that does not parse (CAST, date_parse, from_base) and a
    NULL literal argument give NULL, as the reference's tables do."""
    page = to_port(_string_page(3))
    c = port_compile.ExprCompiler.for_page(page)
    codes = page.blocks[0].data.numpy()
    live = page.row_mask.numpy() & page.blocks[0].valid.numpy()
    for spec, bad in ((SPECS["cast_bigint"], {"abc", "1_0", " 7 ", "99999999999999999999"}),
                      (SPECS["date_parse"], {"2021-13-01", "abc"}),
                      (SPECS["from_base_2"], {"ff", "7"})):
        _, valid = c.compile(build(spec, port_ir, port_type, PAGE_COLUMNS))(page)
        for code, v in zip(codes[live], valid.numpy()[live]):
            if VALUES[code] in bad:
                assert not v, VALUES[code]
    _, valid = c.compile(build(SPECS["strpos_null_needle"], port_ir, port_type,
                               PAGE_COLUMNS))(page)
    assert not valid.numpy().any()


# the reference suites' SQL of these families (tests/test_scalar_functions.py,
# test_function_breadth.py, test_scalar_breadth2.py), and date_format over a column
SUITE_SQL = [
    "select c_custkey, length(c_name), strpos(c_phone, '-') from customer",
    "select n_name from nation where regexp_like(n_name, '^[A-C].*A$')",
    "select n_name, starts_with(n_name, 'A'), ends_with(n_name, 'A'), codepoint(n_name) "
    "from nation",
    "select n2 from (select levenshtein_distance(n_name, null) n2 from nation limit 1) t",
    "select n_name, crc32(to_utf8(n_name)) from nation",
    "select o_orderdate, date_format(o_orderdate, '%d/%m/%Y') from orders limit 200",
    "select s, date_parse(s, '%Y-%m-%d') from (values ('1999-01-08'), ('2020-02-29')) t(s)",
    "select n_name, levenshtein_distance(n_name, 'FRANCE'), levenshtein_distance('FRANCE', "
    "n_name) from nation",
    "select try(1/0)",
    "select try(cast('abc' as bigint))",
    "select n_name, cast(n_name as bigint) from nation limit 5",
    "select n_name, position('AN' in n_name) from nation",
    "select position('b' || 'c' in 'abcd')",
    "select cast(s as bigint) from (values ('7'), ('x')) t(s)",
    "select cast(s as bigint) from (values ('99999999999999999999'), ('7')) t(s)",
    "select count(*) from nation where try_cast(n_name as bigint) is null",
    "select levenshtein_distance(null, n_name) from nation limit 1",
    "select date_format(date '2020-07-05', '%c/%e')",
    "select date_parse('04/03/1995 13:30:15', '%d/%m/%Y %H:%i:%s')",
    # the same families over more columns and shapes
    "select date_format(o_orderdate, '%Y-%m') ym, count(*), sum(o_totalprice) from orders "
    "group by 1 order by 1",
    "select length(p_name) l, count(*) from part where strpos(p_name, 'green') > 0 "
    "or starts_with(p_type, 'PROMO') group by 1 order by 1",
    "select cast(substr(c_phone, 1, 2) as bigint) cc, sum(c_acctbal) from customer "
    "where regexp_like(c_name, '9$') group by 1 order by 1",
    "select cast(substr(c_phone, 1, 2) as double) + 0.5, xxhash64(to_utf8(c_mktsegment)) "
    "from customer where c_custkey < 40",
    "select n_name, json_array_length(n_comment), is_json_scalar(n_name) from nation",
    "select o_orderkey from orders where date_format(o_orderdate, '%Y') = '1996' "
    "and o_orderkey < 200",
]

_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


@pytest.mark.parametrize("i", range(len(SUITE_SQL)))
def test_suite_sql_equals_reference(i):
    _pair().check(SUITE_SQL[i])


def test_date_format_dictionary_is_shared():
    """One dictionary per format, shared by the planner's channel
    metadata and the compiler (the reference's cache), whose codes are
    the day minus DATE_FMT_BASE."""
    from presto_tpu_torch.kernels import expr_eval as k1

    d = port_compile.date_format_dictionary("%Y-%m-%d")
    assert d is port_compile.date_format_dictionary("%Y-%m-%d")
    assert len(d) == k1.DATE_FMT_SPAN
    assert d.values[-k1.DATE_FMT_BASE] == "1970-01-01"
    with pytest.raises(ValueError):
        port_compile.date_format_dictionary("%Y %H")


def test_raw_string_functions_stay_out():
    """A raw varchar (the byte-matrix form, B18) has no dictionary, so
    its functions stay out of the value tables: ``length`` runs in K17
    (code points, a sequence cut at the width one U+FFFD) and equals the
    reference's host callback over the same bytes."""
    import jax.numpy as jnp

    from presto_tpu.ops.rawstring import encode_strings
    from presto_tpu.page import Block, Page
    from presto_tpu_torch.page import page_from_numpy

    values = VALUES + ["héllo", "日本語", "😀x", None]
    data = encode_strings(values, 8)  # "日本語" and "😀x" cut at the width
    valid = np.array([v is not None for v in values])
    n = len(values)
    ref_page = Page((Block(jnp.asarray(data), jnp.asarray(valid), ref_type("raw_varchar(8)")),),
                    jnp.ones(n, jnp.bool_))
    port_page = page_from_numpy([data], [valid], np.ones(n, np.bool_), ["raw_varchar(8)"],
                                [None])
    spec = F("length", "bigint", C("s"))
    cols = [("s", "raw_varchar(8)")]
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(
        build(spec, ref_ir, ref_type, cols))(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(
        build(spec, port_ir, port_type, cols))(port_page)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pd.numpy()[pv.numpy()], np.asarray(rd)[np.asarray(rv)])
    with pytest.raises(NotPorted):  # still no dictionary for a value table
        port_compile.ExprCompiler([port_type("raw_varchar(8)")], [None]).lower(
            build(spec, port_ir, port_type, cols))


def test_from_base_past_int64_raises_in_both():
    """from_base of a value past int64's range (here "ffffffffffffffffff",
    base 16) makes neither package's table: the reference's jnp.asarray
    overflows building it, and the port's int64 table refuses it too (a
    reference fault, ROADMAP C: Presto raises out of range, per row)."""
    import jax.numpy as jnp

    from presto_tpu.page import Block, Dictionary, Page

    words = ["ff", "ffffffffffffffffff"]
    ref_page = Page((Block(jnp.asarray(np.array([0, 1], np.int32)), jnp.ones(2, jnp.bool_),
                           ref_type("varchar"), Dictionary(words)),), jnp.ones(2, jnp.bool_))
    spec = F("from_base", "bigint", S, L(16, "bigint"))
    cols = [("s", "varchar")]
    with pytest.raises(OverflowError):
        ref_compile.ExprCompiler.for_page(ref_page).compile(
            build(spec, ref_ir, ref_type, cols))(ref_page)
    port_page = to_port(ref_page)
    with pytest.raises(ValueError):  # torch: "Overflow when unpacking long long"
        port_compile.ExprCompiler.for_page(port_page).compile(
            build(spec, port_ir, port_type, cols))(port_page)
