"""The fourteenth slice's raw (non-dictionary) VARCHAR values through the
port's twins on the CPU, against the reference's functions on the same
seeded numpy byte matrices: ``ops/rawstring.py``'s functions (K17's
plain twins), K17's modes behind the port's ``ExprCompiler`` against
the reference's compiler over pages holding raw columns (LIKE, length,
strpos and codepoint against the reference's host callbacks), the raw
extremes through K2's and K6's twins against ``grouped_aggregate`` /
``merge_aggregate``, the K7 key against ``topn_page`` and the hash lane
against ``pack_or_hash_keys``.

The edge values: empty strings, NULLs and dead rows, rows filling the
width, multibyte UTF-8 (é, ß, 日本, an emoji), a sequence cut at the
width, the Latin-1 case pairs with ÷ and ×, two widths in one
comparison, and LIKE patterns with ``_`` over a multibyte character.
Everything compares exactly."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.ops import rawstring as ref_rs
from presto_tpu.ops import sort as ref_sort
from presto_tpu.page import Block as RefBlock, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import keys as kk
from presto_tpu_torch.kernels import packed_group_agg as k2
from presto_tpu_torch.kernels import raw_string_eval as k17
from presto_tpu_torch.kernels import sorted_group_agg as k6
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.ops import join as port_join
from presto_tpu_torch.ops import rawstring as rs
from presto_tpu_torch.ops import sort as port_sort
from presto_tpu_torch.page import page_from_numpy
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import C, F, L, build

EDGES = ["", "a", "ab", "héllo wörld", "ÀÉÎÕÜ mixed", "日本語テスト", "naïve café", "ß÷×Þþ",
         "😀 emoji", "Customer#000000001", "Customer#000000002", "abc%_x", "öß and þorn",
         "zzzzzzzzzzzzzzzzzzzzzzzzzzzzzz", "alpha", "alpha ", "Bravo", "日", "é"]
WORDS = ["alpha", "Bravo", "charlie", "é", "日本", "x", "", "ÿ", "Ü"]
# the seeded page's columns: s and t raw of two widths, w narrow enough
# to cut multibyte sequences
COLUMNS = [("id", "bigint"), ("g", "bigint"), ("s", "raw_varchar(24)"),
           ("t", "raw_varchar(12)"), ("w", "raw_varchar(5)")]


def strings(rng: np.random.Generator, n: int) -> list:
    return [EDGES[i % len(EDGES)] if i % 3 == 0 else
            " ".join(rng.choice(WORDS, rng.integers(0, 5))) for i in range(n)]


def raw_pages(seed: int, n: int = 600):
    """The same state as a reference page and a port page: NULLs in every
    column, dead rows, raw columns encoded by the reference."""
    rng = np.random.default_rng(seed)
    cols = [np.arange(n, dtype=np.int64), rng.integers(0, 6, n)]
    for _, t in COLUMNS[2:]:
        vals = strings(rng, n)
        rng.shuffle(vals)
        cols.append(ref_rs.encode_strings(vals, ref_type(t).value_shape[0]))
    valids = [rng.random(n) >= 0.1 for _ in COLUMNS]
    mask = rng.random(n) >= 0.1
    ref = RefPage(tuple(RefBlock(jnp.asarray(c), jnp.asarray(v), ref_type(t))
                        for c, v, (_, t) in zip(cols, valids, COLUMNS)), jnp.asarray(mask))
    port = page_from_numpy(cols, valids, mask, [t for _, t in COLUMNS], [None] * len(cols))
    return ref, port


def matrix(seed: int, n: int, width: int) -> np.ndarray:
    return ref_rs.encode_strings(strings(np.random.default_rng(seed), n), width)


# -- ops/rawstring.py: K17's plain twins ----------------------------------------

@pytest.mark.parametrize("width", [5, 12, 24])
def test_encode_decode_lengths_equal_the_reference(width):
    vals = EDGES + [None]
    got = rs.encode_strings(vals, width)
    np.testing.assert_array_equal(got, ref_rs.encode_strings(vals, width))
    assert rs.decode_strings(got) == ref_rs.decode_strings(got)
    np.testing.assert_array_equal(rs.lengths(torch.from_numpy(got)).numpy(),
                                  np.asarray(ref_rs.lengths(got)))


@pytest.mark.parametrize("wa,wb", [(24, 24), (24, 12), (5, 24)])
def test_compare_and_concat_equal_the_reference(wa, wb):
    a, b = matrix(1, 400, wa), matrix(2, 400, wb)
    lt, eq = rs.compare(torch.from_numpy(a), torch.from_numpy(b))
    rlt, req = ref_rs.compare(a, b)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(rlt))
    np.testing.assert_array_equal(eq.numpy(), np.asarray(req))
    np.testing.assert_array_equal(rs.concat(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(ref_rs.concat(a, b)))


@pytest.mark.parametrize("start,length", [(1, None), (2, 3), (3, None), (0, 2), (5, 1),
                                          (30, None), (2, 0)])
def test_substr_equals_the_reference(start, length):
    for width in (5, 24):
        a = matrix(3, 300, width)
        np.testing.assert_array_equal(rs.substr_chars(torch.from_numpy(a), start,
                                                      length).numpy(),
                                      np.asarray(ref_rs.substr_chars(a, start, length)))
        np.testing.assert_array_equal(rs.substr(torch.from_numpy(a), start, length).numpy(),
                                      np.asarray(ref_rs.substr(a, start, length)))


def test_case_hash_and_lanes_equal_the_reference():
    for width in (5, 12, 25):
        a = matrix(4, 300, width)
        t = torch.from_numpy(a)
        for up in (True, False):
            np.testing.assert_array_equal(rs.change_case(t, up).numpy(),
                                          np.asarray(ref_rs.change_case(a, up)))
        np.testing.assert_array_equal(rs.hash_bytes(t).numpy(), np.asarray(ref_rs.hash_bytes(a)))
        lanes = rs.pack_lanes(t)
        np.testing.assert_array_equal(lanes.numpy(), np.asarray(ref_rs.pack_lanes(a)))
        np.testing.assert_array_equal(rs.unpack_lanes(lanes, width).numpy(),
                                      np.asarray(ref_rs.unpack_lanes(lanes.numpy(), width)))


def test_character_functions_equal_the_reference_host_path():
    """length, codepoint, strpos, starts_with, ends_with and LIKE (K17's
    twins) against the Python functions the reference runs on each
    decoded row: a sequence cut at the width is one U+FFFD."""
    for width in (5, 12, 24):
        a = matrix(5, 400, width)
        t = torch.from_numpy(a)
        dec = ref_rs.decode_strings(a)
        assert rs.char_lengths(t).tolist() == [len(s) for s in dec]
        assert rs.codepoint(t).tolist() == [ord(s[0]) if s else 0 for s in dec]
        for needle in ("", "a", "é", "日本", "😀", "�", "alpha ", "Customer#"):
            assert rs.strpos(t, needle).tolist() == [s.find(needle) + 1 for s in dec]
            assert rs.starts_with(t, needle).tolist() == [s.startswith(needle) for s in dec]
            assert rs.ends_with(t, needle).tolist() == [s.endswith(needle) for s in dec]
        for pat in ("%", "", "a%", "%a%", "_", "__", "h_llo%", "%_", "日%", "_本%", "%�",
                    "%%a%", "a_c%_", "Customer#%1", "%a%l%p%", "___"):
            rx = ref_compile._like_to_regex(pat)
            assert rs.like(t, pat).tolist() == [rx.match(s) is not None for s in dec], pat


def test_k17_checks_its_limits():
    a = torch.zeros((4, k17.MAX_WIDTH + 1), dtype=torch.uint8)
    with pytest.raises(ValueError):
        k17.raw_string_eval(k17.HASH, a)
    with pytest.raises(ValueError):
        k17.raw_string_eval(k17.LIKE, a[:, :8], tokens=[97] * (k17.MAX_TOKENS + 1))
    lits = torch.zeros((k17.MAX_IN + 1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        k17.raw_string_eval(k17.IN, a[:, :8], lits)
    assert rs.isin(a[:, :8], lits).all()  # isin splits its literals across launches


# -- K17 behind the compiler ------------------------------------------------------

V = "varchar"
EXPRS = {
    "eq_lit": F("eq", "boolean", C("s"), L("alpha", V)),
    "lt_lit": F("lt", "boolean", C("s"), L("charlie", V)),
    "ge_lit_left": F("ge", "boolean", L("Bravo", V), C("t")),
    "ne_multibyte": F("ne", "boolean", C("w"), L("日本", V)),
    "lt_two_widths": F("lt", "boolean", C("s"), C("t")),
    "eq_two_widths": F("eq", "boolean", C("t"), C("w")),
    "in": F("in", "boolean", C("s"), L("alpha", V), L("", V), L("日本", V), L("x é", V)),
    "like_prefix": F("like", "boolean", C("s"), L("a%", V)),
    "like_inner": F("like", "boolean", C("s"), L("%a_%", V)),
    "like_multibyte_one": F("like", "boolean", C("w"), L("_本%", V)),
    "like_cut": F("like", "boolean", C("w"), L("%_", V)),
    "regexp_like": F("regexp_like", "boolean", C("s"), L("[a-z]{3}$", V)),
    "starts_with": F("starts_with", "boolean", C("s"), L("al", V)),
    "ends_with": F("ends_with", "boolean", C("t"), L("é", V)),
    "length": F("length", "bigint", C("w")),
    "length_s": F("length", "bigint", C("s")),
    "strpos": F("strpos", "bigint", C("s"), L("a", V)),
    "strpos_multibyte": F("strpos", "bigint", C("t"), L("本", V)),
    "codepoint": F("codepoint", "bigint", C("w")),
    "is_null": F("is_null", "boolean", C("t")),
    "and_of_bridges": F("and", "boolean", F("like", "boolean", C("s"), L("%a%", V)),
                        F("gt", "boolean", F("length", "bigint", C("t")), L(2, "bigint"))),
    "substr": F("substr", "raw_varchar(24)", C("s"), L(2, "bigint"), L(3, "bigint")),
    "substr_tail": F("substr", "raw_varchar(5)", C("w"), L(2, "bigint")),
    "upper": F("upper", "raw_varchar(24)", C("s")),
    "lower": F("lower", "raw_varchar(12)", C("t")),
    "trim": F("trim", "raw_varchar(24)", C("s")),
    "replace": F("replace", "raw_varchar(24)", C("s"), L(" ", V), L("_", V)),
    "concat": F("concat", "raw_varchar(37)", C("s"), L("#", V), C("t")),
    "concat_cut": F("concat", "raw_varchar(10)", C("w"), C("w")),
    "nullif": F("nullif", "raw_varchar(24)", C("s"), L("alpha", V)),
    "coalesce": F("coalesce", "raw_varchar(24)", C("s"), L("none", V)),
    "case": F("case", "raw_varchar(24)", F("lt", "boolean", C("id"), L(300, "bigint")), C("s"),
              L("other", V)),
    "case_on_raw": F("case", "raw_varchar(12)", F("like", "boolean", C("s"), L("a%", V)),
                     C("t"), F("eq", "boolean", C("t"), L("", V)), L("empty", V), C("t")),
    "greatest": F("greatest", "raw_varchar(24)", C("s"), L("charlie", V)),
    "least": F("least", "raw_varchar(24)", C("s"), L("charlie", V)),
    "length_of_upper": F("length", "bigint", F("upper", "raw_varchar(5)", C("w"))),
    "hll_bucket": F("hll_bucket", "bigint", C("s")),
    "hll_rho": F("hll_rho", "bigint", C("t")),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_raw_expressions_equal_the_reference(name):
    ref_page, port_page = raw_pages(7)
    e_ref = build(EXPRS[name], ref_ir, ref_type, COLUMNS)
    e_port = build(EXPRS[name], port_ir, port_type, COLUMNS)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(e_ref)(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(e_port)(port_page)
    rd, rv = np.asarray(rd), np.asarray(rv)
    np.testing.assert_array_equal(pv.numpy(), rv)
    if rd.ndim == 2:
        assert pd.shape[1] >= rd.shape[1]  # a select may pad its bytes
        assert rs.decode_strings(pd.numpy()[rv]) == ref_rs.decode_strings(rd[rv])
    else:
        np.testing.assert_array_equal(pd.numpy()[rv], rd[rv])
    if e_port.type.name == "boolean":  # the filter form
        keep = port_compile.compile_filter(e_port, port_page)(port_page)
        np.testing.assert_array_equal(keep.numpy(), rd & rv & np.asarray(ref_page.row_mask))


@pytest.mark.parametrize("spec,err", [
    (F("eq", "boolean", C("s"), C("d")), "raw-vs-dictionary"),
    (F("concat", "raw_varchar(24)", C("s"), C("d")), "mixes raw and dictionary"),
    (F("cast_bigint", "bigint", C("s")), "unsupported over raw varchar"),
    (F("json_size", "bigint", C("s"), L("$.a", V)), "unsupported over raw varchar"),
], ids=["cmp_dictionary", "concat_dictionary", "cast_bigint", "json_size"])
def test_the_reference_refusals_stay(spec, err):
    """A raw string against a dictionary string, a concat mixing them and
    the functions the reference does not run over raw values raise
    ValueError in both packages."""
    from presto_tpu.page import Dictionary as RefDictionary
    from presto_tpu_torch.page import Block, Dictionary, Page

    cols = COLUMNS + [("d", "varchar")]
    ref_page, port_page = raw_pages(8, 64)
    codes = np.zeros(64, dtype=np.int32)
    ref_d = RefBlock(jnp.asarray(codes), jnp.ones(64, jnp.bool_), ref_type("varchar"),
                     RefDictionary(["a"]))
    port_d = Block(torch.from_numpy(codes), torch.ones(64, dtype=torch.bool),
                   port_type("varchar"), Dictionary(["a"]))
    ref_page = RefPage(ref_page.blocks + (ref_d,), ref_page.row_mask)
    port_page = Page(port_page.blocks + (port_d,), port_page.row_mask)
    with pytest.raises(ValueError, match=err):
        ref_compile.ExprCompiler.for_page(ref_page).compile(
            build(spec, ref_ir, ref_type, cols))(ref_page)
    with pytest.raises(ValueError, match=err):
        port_compile.ExprCompiler.for_page(port_page).compile(
            build(spec, port_ir, port_type, cols))(port_page)


# -- K2 / K6: the raw extremes -------------------------------------------------------

def _aggs(ir, parse_type, agg_module, names):
    out = []
    for fn, col in names:
        idx = [c for c, _ in COLUMNS].index(col)
        arg = ir.ColumnRef(type=parse_type(COLUMNS[idx][1]), index=idx)
        out.append(ir.AggCall(fn=fn, arg=arg, type=agg_module.output_type(
            ir.AggCall(fn=fn, arg=arg, type=None))))
    return out


AGGS = [("min", "s"), ("max", "s"), ("count", "s"), ("min", "w"), ("max", "t"),
        ("checksum", "s")]


def _key(ir, parse_type, name):
    idx = [c for c, _ in COLUMNS].index(name)
    return ir.ColumnRef(type=parse_type(COLUMNS[idx][1]), index=idx)


def _rows_equal(got, ref):
    from oracle import assert_rows_match

    assert_rows_match(got.to_pylist(), ref.to_pylist(), ordered=False)


@pytest.mark.parametrize("path", ["global", "packed", "sorted", "raw_key"])
@pytest.mark.parametrize("mode", ["partial", "single"])
def test_grouped_raw_states_equal_the_reference(path, mode):
    """K2 (global, packed-direct: the phased lanes) and K6 (the sort path,
    and a raw group key through its hash lane) raw min/max, count and
    checksum states and finalizes."""
    ref_page, port_page = raw_pages(9)
    keys = {"global": [], "packed": ["g"], "sorted": ["g"], "raw_key": ["t", "g"]}[path]
    doms = {"global": None, "packed": [(0, 5)], "sorted": [None],
            "raw_key": [None, (0, 5)]}[path]
    ref = ref_agg.grouped_aggregate(ref_page, [_key(ref_ir, ref_type, k) for k in keys],
                                    _aggs(ref_ir, ref_type, ref_agg, AGGS), 1024,
                                    key_domains=doms, mode=mode)
    got = port_agg.grouped_aggregate(port_page, [_key(port_ir, port_type, k) for k in keys],
                                     _aggs(port_ir, port_type, port_agg, AGGS), 1024,
                                     key_domains=doms, mode=mode)
    _rows_equal(got, ref)
    if mode == "partial":  # the partial states' bytes, the empty groups' identities too
        live = np.asarray(ref.row_mask)
        for rb, pb in zip(ref.blocks, got.blocks):
            if rb.type.is_raw_string and path in ("global", "packed"):
                np.testing.assert_array_equal(pb.data.numpy()[live], np.asarray(rb.data)[live])


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_merge_of_raw_states_equals_the_reference(mode):
    """K6's merge of two splits' raw extremes (their lanes), by a raw key."""
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu_torch.page import concat_pages_device as port_concat

    ref_parts, port_parts = [], []
    for seed in (10, 11):
        ref_page, port_page = raw_pages(seed)
        ref_parts.append(ref_agg.grouped_aggregate(
            ref_page, [_key(ref_ir, ref_type, "w")], _aggs(ref_ir, ref_type, ref_agg, AGGS),
            1024, key_domains=[None], mode="partial"))
        port_parts.append(port_agg.grouped_aggregate(
            port_page, [_key(port_ir, port_type, "w")],
            _aggs(port_ir, port_type, port_agg, AGGS), 1024, key_domains=[None],
            mode="partial"))
    ref = ref_agg.merge_aggregate(ref_concat(ref_parts), 1,
                                  _aggs(ref_ir, ref_type, ref_agg, AGGS), 1024,
                                  key_domains=[None], mode=mode)
    got = port_agg.merge_aggregate(port_concat(port_parts), 1,
                                   _aggs(port_ir, port_type, port_agg, AGGS), 1024,
                                   key_domains=[None], mode=mode)
    _rows_equal(got, ref)


def test_lane_extremes_equal_the_reference_phased_walk():
    """The K2 and K6 twins' lane extremes against ``_minmax_lanes`` over
    ``pack_lanes``, lanes tied on their first words included."""
    a = matrix(12, 500, 25)
    rng = np.random.default_rng(12)
    gid = rng.integers(0, 7, 500)
    nonnull = rng.random(500) >= 0.2
    lanes = ref_rs.pack_lanes(a)
    for fn in ("min", "max"):
        want = ref_agg._minmax_lanes(fn, lanes, jnp.asarray(nonnull),
                                     jnp.asarray(np.where(nonnull, gid, 7)), 7)
        got = k2.packed_group_agg_plain(
            500, torch.ones(500, dtype=torch.bool),
            [(torch.from_numpy(gid), torch.ones(500, dtype=torch.bool), 0, 7)],
            [(k2.MIN_LANES if fn == "min" else k2.MAX_LANES, rs.pack_lanes(torch.from_numpy(a)),
              torch.from_numpy(nonnull))], 7)[0][0][0]
        # the packed gid is the key code + 1 (0: NULL)
        np.testing.assert_array_equal(got.numpy()[1:7], np.asarray(want)[:6])
        order = torch.sort(torch.from_numpy(gid), stable=True).indices
        counts = torch.bincount(torch.from_numpy(gid), minlength=7)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
        got6 = k6.lane_extremes(order, starts, rs.pack_lanes(torch.from_numpy(a)),
                                torch.from_numpy(nonnull), fn == "min")
        np.testing.assert_array_equal(got6.numpy(), np.asarray(want))


# -- K7, the sort and the hash lane -------------------------------------------------

@pytest.mark.parametrize("n", [10, 100, 300])
@pytest.mark.parametrize("asc", [True, False])
def test_topn_with_a_raw_key_equals_the_reference(n, asc):
    """K7 over a raw key's lanes (and a bigint tie-break) up to its
    MAX_N; past it the page's sort in k lane passes."""
    ref_page, port_page = raw_pages(13)
    ref_keys = [_key(ref_ir, ref_type, "s"), _key(ref_ir, ref_type, "id")]
    port_keys = [_key(port_ir, port_type, "s"), _key(port_ir, port_type, "id")]
    ref = ref_sort.topn_page(ref_page, ref_keys, [asc, True], n, [not asc, False])
    got = port_sort.topn_page(port_page, port_keys, [asc, True], n, [not asc, False])
    assert got.to_pylist() == ref.to_pylist()
    if n <= k7.MAX_N:
        keys = port_sort.topn_keys(port_page, port_keys, [asc, True])
        assert keys[0][0].shape == (port_page.capacity, 3)  # ceil(24 / 8) lanes


def test_sort_page_with_raw_keys_equals_the_reference():
    ref_page, port_page = raw_pages(14)
    ref_keys = [_key(ref_ir, ref_type, "w"), _key(ref_ir, ref_type, "t")]
    port_keys = [_key(port_ir, port_type, "w"), _key(port_ir, port_type, "t")]
    ref = ref_sort.sort_page(ref_page, ref_keys, [False, True])
    got = port_sort.sort_page(port_page, port_keys, [False, True])
    assert got.to_pylist() == ref.to_pylist()


def test_hash_lane_equals_pack_or_hash_keys():
    """A raw key folds through hash_bytes into one int64 lane, then mixes
    as any hashed lane (the reference's pack_or_hash_keys, exact=False),
    domains or not."""
    ref_page, port_page = raw_pages(15)
    b, pb = ref_page.blocks, port_page.blocks
    for cols, doms in (([2], [None]), ([3, 1], [None, (0, 5)]), ([1, 4, 2], [(0, 5)] * 3)):
        want, exact = ref_agg.pack_or_hash_keys([b[i].data for i in cols],
                                                [b[i].valid for i in cols], doms)
        assert not exact
        keys = port_join.key_tuples([(pb[i].data, pb[i].valid) for i in cols],
                                    [pb[i].type for i in cols], doms)
        assert kk.hashed(keys)
        got, _ = kk.pack_plain(keys, port_page.capacity, port_page.device)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_raw_refusals_by_name():
    """Raw strings inside containers and two-argument extremes over raw
    values stay out, as in the reference (max_by over raw: ValueError)."""
    raw = port_type("raw_varchar(8)")
    agg = port_ir.AggCall(fn="max_by", arg=port_ir.ColumnRef(type=raw, index=0),
                          arg2=port_ir.ColumnRef(type=port_type("bigint"), index=1),
                          type=raw)
    with pytest.raises(ValueError, match="raw varchar"):
        port_agg._state_kind(agg)
    e = port_ir.Call(type=port_type("array(bigint, 4)"), fn="split",
                     args=(port_ir.ColumnRef(type=raw, index=0),
                           port_ir.Literal(type=port_type("varchar"), value=" ")))
    with pytest.raises(NotPorted):
        port_compile.ExprCompiler([raw], [None]).compile(e)
