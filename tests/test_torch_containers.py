"""ARRAY, MAP and ROW kernels of the port against the reference.

K12 ``container_eval`` (every opcode), K13 ``unnest_expand`` and K14
``group_collect`` (through the port's ``grouped_aggregate`` and
``merge_aggregate``) over seeded slot matrices, against the reference's
functions in ``presto_tpu/ops/container.py`` and
``presto_tpu/ops/aggregate.py`` on the same numpy state: NULL elements,
empty and NULL containers, NaN and +-inf, INT64 extremes, duplicate map
keys and a group past the 64-slot cap.  The lambda opcodes (assemble,
compact, compact_pairs, transform_keys, match) and the whole flattening
run through SQL over a seeded table built in both packages.

Tolerances: every slot is exact (doubles by value, NaN as NULL); an
array_average within a relative 1e-12 (its sum's order: the reference's
jnp.sum, the port's slot order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import container as ref_ct
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.kernels import container_eval as k12
from presto_tpu_torch.kernels import group_collect as k14
from presto_tpu_torch.ops import container as port_ct
from presto_tpu_torch.types import parse_type as port_type

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max
N, M = 512, 8


def _matrix(rng, n, m, storage, halves=1, lengths=None):
    """A seeded ``(n, 1 + halves * m)`` slot matrix: lengths 0..m, small
    values (so equal elements and duplicate keys occur), extremes and
    NULL elements, pads as the sentinel."""
    lens = rng.integers(0, m + 1, n) if lengths is None else lengths
    if storage == np.float64:
        vals = rng.integers(-4, 5, (n, halves * m)).astype(np.float64)
        pick = rng.random(vals.shape) < 0.1
        vals[pick] = rng.choice([np.inf, -np.inf, 0.5, -2.25], pick.sum())
        sent = np.nan
    else:
        vals = rng.integers(-4, 5, (n, halves * m)).astype(np.int64)
        pick = rng.random(vals.shape) < 0.08
        vals[pick] = rng.choice([I64_MAX, I64_MIN + 1, I64_MAX - 1], pick.sum())
        sent = I64_MIN
    vals[rng.random(vals.shape) < 0.1] = sent
    out = np.full((n, 1 + halves * m), sent, dtype=storage)
    out[:, 0] = lens
    j = np.arange(m)[None, :]
    for h in range(halves):
        half = vals[:, h * m:(h + 1) * m]
        out[:, 1 + h * m:1 + (h + 1) * m] = np.where(j < lens[:, None], half, sent)
    if halves == 2:  # map keys are never NULL
        keys = out[:, 1:1 + m]
        keys[(j < lens[:, None]) & np.isnan(keys.astype(np.float64))
             if storage == np.float64 else (j < lens[:, None]) & (keys == I64_MIN)] = 3
    return out


def _valid(rng, n):
    return rng.random(n) >= 0.1


def _decode(d, t, valid):
    """Host rows of a matrix, None for NULL rows (a NaN map key, which
    no dict lookup finds, as the string 'NaN')."""
    d = np.asarray(d)
    rows = (port_ct.decode_maps if t.is_map else port_ct.decode_arrays)(d, t)
    if t.is_map:
        rows = [[("NaN" if isinstance(k, float) and k != k else k, v) for k, v in r.items()]
                for r in rows]
    return [r if ok else None for r, ok in zip(rows, np.asarray(valid))]


def _same_lane(port, ref, what, rel=0.0):
    pd, pv = port[0].numpy(), port[1].numpy()
    rd, rv = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_array_equal(pv, rv, err_msg=f"{what} valid")
    if rel:
        np.testing.assert_allclose(pd[rv], rd[rv], rtol=rel, err_msg=f"{what} data")
    else:
        np.testing.assert_array_equal(pd[rv].astype(rd.dtype), rd[rv], err_msg=f"{what} data")


def _same_matrix(port, ref, t, valid, what):
    assert _decode(port, t, valid) == _decode(ref, t, valid), what


STORAGES = {"bigint": np.int64, "double": np.float64}


@pytest.fixture(params=sorted(STORAGES))
def elem(request):
    return request.param


def _types(elem):
    return (ref_type(f"array({elem}, {M})"), port_type(f"array({elem}, {M})"),
            ref_type(f"map({elem}, {elem}, {M})"), port_type(f"map({elem}, {elem}, {M})"))


# -- the scalar opcodes ---------------------------------------------------------

def test_scalar_opcodes_equal_reference(elem):
    rng = np.random.default_rng(11)
    st = STORAGES[elem]
    rt, pt, rmt, pmt = _types(elem)
    a = _matrix(rng, N, M, st)
    mp = _matrix(rng, N, M, st, halves=2)
    av = _valid(rng, N)
    x = rng.integers(-1, M + 2, N)
    xv = _valid(rng, N)
    key = rng.integers(-4, 5, N).astype(st)
    A, AV, X, XV, K = (torch.from_numpy(t) for t in (a, av, x, xv, key))
    ja, jav, jx, jxv, jk = (jnp.asarray(t) for t in (a, av, x, xv, key))

    got = k12.container_eval(k12.CARD, A, AV)
    _same_lane(got, (ref_ct.cardinality(ja), jav), "cardinality")
    got = k12.container_eval(k12.SUBSCRIPT, A, AV, x=X, xv=XV)
    d, v = ref_ct.subscript(ja, rt, jx, jxv)
    _same_lane(got, (d, v & jav), "subscript")
    got = k12.container_eval(k12.MAP_GET, torch.from_numpy(mp), AV, x=K, xv=XV,
                             p=[0, 0, 0, 0, 0, M])
    d, v = ref_ct.map_get(jnp.asarray(mp), rmt, jk, jxv)
    _same_lane(got, (d, v & jav), "map_get")
    for op, fn in ((k12.CONTAINS, ref_ct.contains), (k12.POSITION, ref_ct.array_position)):
        got = k12.container_eval(op, A, AV, x=K, xv=XV)
        d, v = fn(ja, rt, jk, jxv)
        _same_lane(got, (d, v & jav), k12.OP_NAMES[op])
    for mode, fn in enumerate(("array_min", "array_max", "array_sum", "array_average")):
        got = k12.container_eval(k12.REDUCE, A, AV, p=[mode])
        d, v = ref_ct.array_reduce(ja, rt, fn)
        _same_lane(got, (d, v & jav), fn, rel=1e-12 if fn == "array_average" else 0.0)
    rows = _matrix(rng, N, 3, st, lengths=np.full(N, 3))[:, 1:].copy()
    rowt = ref_type(f"row({elem}, {elem}, {elem})")
    for i in (1, 2, 3):
        got = k12.container_eval(k12.ROW_FIELD, torch.from_numpy(rows), AV, p=[i - 1])
        d, nn = ref_ct.row_field(jnp.asarray(rows), rowt, i)
        _same_lane(got, (d, nn & jav), f"row_field {i}")


# -- the matrix opcodes ---------------------------------------------------------

def test_sort_distinct_slice_equal_reference(elem):
    rng = np.random.default_rng(12)
    st = STORAGES[elem]
    rt, pt, _, _ = _types(elem)
    a = _matrix(rng, N, M, st)
    ones = np.ones(N, bool)
    A, ja = torch.from_numpy(a), jnp.asarray(a)
    _same_matrix(k12.container_eval(k12.SORT, A), ref_ct.array_sort(ja, rt), pt, ones, "sort")
    _same_matrix(k12.container_eval(k12.DISTINCT, A), ref_ct.array_distinct(ja, rt), pt, ones,
                 "distinct")
    for start, length in ((1, 3), (2, 9), (-2, 2), (-9, 4), (5, 0)):
        _same_matrix(k12.container_eval(k12.SLICE, A, p=[start, length]),
                     ref_ct.slice_array(ja, rt, start, length), pt, ones, f"slice {start}")


def test_concat_keys_values_construct_equal_reference(elem):
    rng = np.random.default_rng(13)
    st = STORAGES[elem]
    rt, pt, rmt, pmt = _types(elem)
    a, b = _matrix(rng, N, M, st), _matrix(rng, N, M, st)
    mp = _matrix(rng, N, M, st, halves=2)
    ones = np.ones(N, bool)
    ot, opt = ref_type(f"array({elem}, {2 * M})"), port_type(f"array({elem}, {2 * M})")
    got = k12.container_eval(k12.CONCAT, torch.from_numpy(a), b=torch.from_numpy(b), out_m=2 * M)
    _same_matrix(got, ref_ct.concat_arrays(jnp.asarray(a), rt, jnp.asarray(b), rt, ot), opt,
                 ones, "concat")
    for half, fn in ((0, ref_ct.map_keys_array), (1, ref_ct.map_values_array)):
        got = k12.container_eval(k12.MAP_HALF, torch.from_numpy(mp), out_dtype=torch.float64,
                                 p=[half, 0, 0, 0, 0, M])
        want = fn(jnp.asarray(mp), rmt, ref_type(f"array(double, {M})"))
        _same_matrix(got, want, port_type(f"array(double, {M})"), ones, f"map half {half}")
    got = k12.container_eval(k12.CONSTRUCT_MAP, torch.from_numpy(a), b=torch.from_numpy(b),
                             out_m=M)
    _same_matrix(got, ref_ct.construct_map(jnp.asarray(a), rt, jnp.asarray(b), rt, rmt), pmt,
                 ones, "construct_map")
    # ARRAY[...] and ROW(...) from lanes with NULLs
    k = 5
    lanes = [rng.integers(-9, 9, N).astype(st) for _ in range(k)]
    valids = [_valid(rng, N) for _ in range(k)]
    y = torch.from_numpy(np.stack(lanes, 1))
    yv = torch.from_numpy(np.stack(valids, 1))
    got = k12.container_eval(k12.CONSTRUCT, y=y, yv=yv, out_m=M, p=[1])
    want = ref_ct.construct_array([jnp.asarray(x) for x in lanes],
                                  [jnp.asarray(x) for x in valids], rt)
    _same_matrix(got, want, pt, ones, "construct_array")
    rowt = ref_type(", ".join([f"row({elem}"] + [elem] * (k - 1)) + ")")
    got = k12.container_eval(k12.CONSTRUCT, y=y, yv=yv, out_m=k, p=[0])
    want = ref_ct.construct_row([jnp.asarray(x) for x in lanes],
                                [jnp.asarray(x) for x in valids], rowt)
    assert port_ct.decode_rows(got.numpy(), port_type(str(rowt))) == \
        ref_ct.decode_rows(np.asarray(want), rowt)


@pytest.mark.parametrize("pair", ["bigint-bigint", "bigint-double", "decimal(10,2)-double",
                                  "decimal(10,2)-decimal(12,4)", "decimal(12,4)-decimal(10,1)",
                                  "double-decimal(10,2)"])
def test_coerce_equals_reference(pair):
    rng = np.random.default_rng(14)
    src, dst = pair.split("-")
    st = np.float64 if src == "double" else np.int64
    a = _matrix(rng, N, M, st)
    if st == np.float64:  # finite values only for a decimal target
        a[:, 1:] = np.where(np.isinf(a[:, 1:]), 1.75, a[:, 1:])
    rt, dt = ref_type(f"array({src}, {M})"), ref_type(f"array({dst}, {M})")
    from presto_tpu_torch.expr.containers import ContainerCompiler

    got = ContainerCompiler._coerce(torch.from_numpy(a), port_type(str(rt)), port_type(str(dt)))
    want = ref_ct.coerce_slots(ref_ct.elem_slots(jnp.asarray(a), rt), rt.element, dt.element,
                               dt.np_dtype)
    np.testing.assert_array_equal(got[:, 1:].numpy(), np.asarray(want))


def test_set_functions_equal_reference(elem):
    rng = np.random.default_rng(15)
    st = STORAGES[elem]
    rt, pt, rmt, pmt = _types(elem)
    a, b = _matrix(rng, N, M, st), _matrix(rng, N, M, st)
    av, bv = _valid(rng, N), _valid(rng, N)
    ones = np.ones(N, bool)
    A, B, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    for mode, fn in ((k12.S_INTERSECT, ref_ct.array_intersect),
                     (k12.S_EXCEPT, ref_ct.array_except)):
        got = k12.container_eval(k12.DISTINCT, k12.container_eval(k12.SETOP, A, b=B, c=A,
                                                                  out_m=M, p=[mode]))
        _same_matrix(got, fn(ja, rt, jb, rt, rt), pt, ones, fn.__name__)
    got = k12.container_eval(k12.DISTINCT, k12.container_eval(k12.CONCAT, A, b=B, out_m=2 * M))
    ut = ref_type(f"array({elem}, {2 * M})")
    _same_matrix(got, ref_ct.array_union(ja, rt, jb, rt, ut), port_type(str(ut)), ones, "union")
    got = k12.container_eval(k12.OVERLAP, A, torch.from_numpy(av), b=B, bv=torch.from_numpy(bv),
                             c=A)
    d, v = ref_ct.arrays_overlap(ja, rt, jb, rt)
    _same_lane(got, (d, v & jnp.asarray(av) & jnp.asarray(bv)), "overlap")
    x = rng.integers(-4, 5, N).astype(st)
    got, _ = k12.container_eval(k12.REMOVE, A, torch.from_numpy(av), x=torch.from_numpy(x),
                                xv=torch.from_numpy(ones))
    _same_matrix(got, ref_ct.array_remove(ja, rt, jnp.asarray(x)), pt, ones, "remove")
    m1, m2 = _matrix(rng, N, M, st, halves=2), _matrix(rng, N, M, st, halves=2)
    got = k12.container_eval(k12.MAP_CONCAT, torch.from_numpy(m1), b=torch.from_numpy(m2),
                             out_m=M, p=[0, 0, 0, 0, M, M])
    _same_matrix(got, ref_ct.map_concat(jnp.asarray(m1), rmt, jnp.asarray(m2), rmt, rmt), pmt,
                 ones, "map_concat")


def test_array_sort_follows_the_reference_beside_a_null():
    """The reference's integer array_sort keys a NULL element as max - 1,
    so a real INT64_MAX beside a NULL comes out as max - 1; the port
    follows (ROADMAP queue C)."""
    t = ref_type("array(bigint, 4)")
    a = np.array([[3, I64_MAX, I64_MIN, 1, I64_MIN]], dtype=np.int64)
    want = ref_ct.decode_arrays(np.asarray(ref_ct.array_sort(jnp.asarray(a), t)), t)
    got = port_ct.decode_arrays(k12.container_eval(k12.SORT, torch.from_numpy(a)).numpy(),
                                port_type("array(bigint, 4)"))
    assert got == want == [[1, I64_MAX - 1, None]]


def test_duplicate_map_keys_stay_separate_entries():
    """A map keeps repeated keys as entries of their own (PARITY.md's
    deviation, the reference's); element_at takes the first."""
    t = port_type("map(bigint, bigint, 4)")
    d = port_ct.encode_maps([{1: 10}], t, 1)
    d[0, :3] = [2, 1, 1]
    d[0, 5:7] = [10, 20]
    got = k12.container_eval(k12.MAP_GET, torch.from_numpy(d), torch.ones(1, dtype=torch.bool),
                             x=torch.tensor([1]), xv=torch.ones(1, dtype=torch.bool),
                             p=[0, 0, 0, 0, 0, 4])
    assert (int(got[0][0]), bool(got[1][0])) == (10, True)
    assert int(k12.container_eval(k12.CARD, torch.from_numpy(d), None)[0][0]) == 2


# -- K13 -------------------------------------------------------------------------

@pytest.mark.parametrize("ordinality", [False, True])
def test_unnest_expand_equals_reference(elem, ordinality):
    from presto_tpu.expr.ir import ColumnRef as RefCol
    from presto_tpu.page import Block as RefBlock, Page as RefPage
    from presto_tpu.types import BIGINT
    from presto_tpu_torch.expr.ir import ColumnRef as PortCol
    from presto_tpu_torch.page import page_from_numpy
    from torch_parity import numpy_state

    rng = np.random.default_rng(16)
    st = STORAGES[elem]
    rt, pt, rmt, pmt = _types(elem)
    n = 300
    ids = np.arange(n, dtype=np.int64)
    a = _matrix(rng, n, M, st)
    mp = _matrix(rng, n, 4, st, halves=2)
    rmt4 = ref_type(f"map({elem}, {elem}, 4)")
    blocks = (RefBlock(jnp.asarray(ids), jnp.ones(n, bool), BIGINT),
              RefBlock(jnp.asarray(a), jnp.asarray(_valid(rng, n)), rt),
              RefBlock(jnp.asarray(mp), jnp.asarray(_valid(rng, n)), rmt4))
    ref_page = RefPage(blocks, jnp.asarray(rng.random(n) >= 0.1))
    exprs = [RefCol(type=rt, index=1), RefCol(type=rmt4, index=2)]
    elem_t = ref_type(elem)
    out_types = [b.type for b in blocks] + [elem_t, elem_t, elem_t] + ([BIGINT] * ordinality)
    want = ref_ct.unnest_expand(ref_page, exprs, ordinality, out_types)
    cols, valids, mask, _, _ = numpy_state(ref_page)
    port = page_from_numpy(cols, valids, mask, ["bigint", f"array({elem}, {M})",
                                                 f"map({elem}, {elem}, 4)"], [None] * 3)
    pexprs = [PortCol(type=port.blocks[e.index].type, index=e.index) for e in exprs]

    class Ch:
        def __init__(self, t):
            self.type, self.dictionary = port_type(str(t)), None

    got = port_ct.unnest_page(port, pexprs, ordinality, [Ch(t) for t in out_types])
    assert got.to_pylist() == want.to_pylist()


# -- K14 through the aggregation paths ------------------------------------------

def _agg_page(rng, n, groups, key_null=0.05):
    return {"g": rng.integers(0, groups, n), "x": rng.integers(-50, 50, n),
            "k": rng.integers(0, 20, n), "xv": rng.random(n) >= 0.1,
            "kv": rng.random(n) >= key_null, "live": rng.random(n) >= 0.1}


def _both_pages(cols, elem, n):
    from presto_tpu.page import Block as RefBlock, Page as RefPage
    from torch_parity import to_port

    x = cols["x"].astype(np.float64) / 4 if elem == "double" else cols["x"]
    blocks = (RefBlock(jnp.asarray(cols["g"]), jnp.ones(n, bool), ref_type("bigint")),
              RefBlock(jnp.asarray(x), jnp.asarray(cols["xv"]), ref_type(elem)),
              RefBlock(jnp.asarray(cols["k"]), jnp.asarray(cols["kv"]), ref_type("bigint")))
    ref = RefPage(blocks, jnp.asarray(cols["live"]))
    return ref, to_port(ref)


def _aggs(ir_mod, type_of, elem):
    g = ir_mod.ColumnRef(type=type_of("bigint"), index=0)
    x = ir_mod.ColumnRef(type=type_of(elem), index=1)
    k = ir_mod.ColumnRef(type=type_of("bigint"), index=2)
    return [g], [ir_mod.AggCall(fn="array_agg", arg=x,
                                type=type_of(f"array({elem}, 64)")),
                 ir_mod.AggCall(fn="map_agg", arg=k, arg2=x,
                                type=type_of(f"map(bigint, {elem}, 64)")),
                 ir_mod.AggCall(fn="count_star", arg=None, type=type_of("bigint"))]


def _rows_by_key(page):
    return sorted(page.to_pylist(), key=lambda r: (r[0] is None, r[0]))


@pytest.mark.parametrize("groups", [3, 200])
def test_array_agg_map_agg_states_equal_reference(elem, groups):
    """Partial states per split (K14's collect over K6's runs), their
    merge across splits (K14's merge) and the finalize: the elements of
    each group in input order, NULL values kept (array_agg), NULL keys
    dropped (map_agg), 64 slots at most (a group of 3 holds ~150 rows:
    the cap truncates, as the reference's)."""
    from presto_tpu.expr import ir as ref_ir
    from presto_tpu.ops import aggregate as ref_agg
    from presto_tpu.page import Block as RefBlock, Page as RefPage
    from presto_tpu_torch.expr import ir as port_ir
    from presto_tpu_torch.ops import aggregate as port_agg
    from presto_tpu_torch.page import concat_pages_device

    rng = np.random.default_rng(17 + groups)
    n = 500
    rgroup, raggs = _aggs(ref_ir, ref_type, elem)
    pgroup, paggs = _aggs(port_ir, port_type, elem)
    ref_parts, port_parts = [], []
    for _ in range(2):
        ref, port = _both_pages(_agg_page(rng, n, groups), elem, n)
        ref_parts.append(ref_agg.grouped_aggregate(ref, rgroup, raggs, 256, mode="partial"))
        port_parts.append(port_agg.grouped_aggregate(port, pgroup, paggs, 256, mode="partial"))
    for rp, pp in zip(ref_parts, port_parts):
        assert _rows_by_key(pp) == _rows_by_key(rp)
    live = [np.asarray(p.row_mask) for p in ref_parts]
    ref_cat = RefPage(tuple(
        RefBlock(jnp.concatenate([jnp.asarray(np.asarray(p.blocks[i].data)[m])
                                  for p, m in zip(ref_parts, live)]),
                 jnp.concatenate([jnp.asarray(np.asarray(p.blocks[i].valid)[m])
                                  for p, m in zip(ref_parts, live)]),
                 ref_parts[0].blocks[i].type, ref_parts[0].blocks[i].dictionary)
        for i in range(len(ref_parts[0].blocks))), jnp.ones(sum(m.sum() for m in live), bool))
    want = ref_agg.merge_aggregate(ref_cat, 1, raggs, 256, mode="single")
    got = port_agg.merge_aggregate(concat_pages_device(port_parts), 1, paggs, 256,
                                   mode="single")
    rows = _rows_by_key(got)
    assert rows == _rows_by_key(want)
    if groups == 3:
        assert max(len(r[1]) for r in rows) == 64  # the cap truncates


def test_global_array_agg_folds_splits_in_order(elem):
    """The global aggregate's partials (K2's counts, K14's one run in
    page order) folded split by split (K3 and K14's merge), as the
    executor folds them, against the reference's fold."""
    from presto_tpu.expr import ir as ref_ir
    from presto_tpu.ops import aggregate as ref_agg
    from presto_tpu_torch.expr import ir as port_ir
    from presto_tpu_torch.ops import aggregate as port_agg

    rng = np.random.default_rng(18)
    n = 40
    _, raggs = _aggs(ref_ir, ref_type, elem)
    _, paggs = _aggs(port_ir, port_type, elem)
    from presto_tpu.exec.local import concat_pages_device as ref_concat

    acc_r = acc_p = None
    for _ in range(3):
        ref, port = _both_pages(_agg_page(rng, n, 4), elem, n)
        pr = ref_agg.grouped_aggregate(ref, [], raggs, 1, mode="partial")
        pp = port_agg.grouped_aggregate(port, [], paggs, 1, mode="partial")
        # the reference's global fold: a merge of the running partial
        # with the split's
        acc_r = pr if acc_r is None else ref_agg.merge_aggregate(
            ref_concat([acc_r, pr]), 0, raggs, 1, mode="partial")
        acc_p = pp if acc_p is None else port_agg.combine_packed_states(acc_p, pp, 0, paggs)
    assert port_agg.finalize_packed(acc_p, 0, paggs).to_pylist() == \
        ref_agg.merge_aggregate(acc_r, 0, raggs, 1, mode="single").to_pylist()


def test_group_collect_plain_writes_runs_in_order():
    """K14's twin over explicit runs: each group's selected rows in run
    order, the cap, NULLs as the sentinel, the merge at running offsets."""
    order = torch.tensor([3, 0, 4, 1, 2, 5])
    starts = torch.tensor([0, 3, 6])
    sel = torch.tensor([True, True, False, True, True, True])
    x = torch.tensor([10, 11, 12, 13, 14, 15])
    xv = torch.tensor([True, False, True, True, True, True])
    got = k14.group_collect(order, starts, sel, [(x, xv)], 2, torch.int64)
    assert got.tolist() == [[2, 13, 10], [2, I64_MIN, 15]]
    merged = k14.group_collect_merge(None, torch.tensor([0, 2]), torch.tensor([True, True]),
                                     got, 2)
    assert merged.tolist() == [[2, 13, 10]]


# -- the lambda opcodes through SQL ---------------------------------------------

LAMBDA_SQL = [
    "select id, transform(a, x -> x * 2), filter(a, x -> x > 0) from r order by id",
    "select id, any_match(a, x -> x > 2), all_match(a, x -> x > -3), "
    "none_match(a, x -> x = 0) from r order by id",
    "select id, transform(a, x -> x + id), filter(a, x -> x % 2 = id % 2) from r order by id",
    "select id, zip_with(a, b, (x, y) -> coalesce(x, 0) - coalesce(y, 0)) from r order by id",
    "select id, map_filter(m, (k, v) -> v > k), transform_values(m, (k, v) -> v * 10 + k) "
    "from r order by id",
    "select id, transform_keys(m, (k, v) -> k % 3) from r order by id",
    "select id, reduce(a, 0, (s, x) -> s + coalesce(x, 100), s -> s * 2) from r order by id",
    "select id, cardinality(filter(a, x -> x is null)), array_sort(a), array_distinct(b) "
    "from r order by id",
    "select id, e, o from r cross join unnest(a, b) with ordinality as u(e, f, o) "
    "where o <= 3 order by id, o",
    "select id, k, v from r cross join unnest(m) as u(k, v) order by id, k, v",
    "select g, array_agg(id), map_agg(id, g) from r group by g order by g",
    "select array_agg(e) from (select e from r cross join unnest(a) as u(e) where id < 8)",
]


@pytest.fixture(scope="module")
def lambda_runners():
    from presto_tpu.catalog import Catalog
    from presto_tpu.connectors.memory import MemoryConnector
    from presto_tpu.page import Page
    from presto_tpu.runner import QueryRunner
    from presto_tpu.types import BIGINT, ArrayType, MapType
    from presto_tpu_torch import types as pt
    from presto_tpu_torch.catalog import Catalog as PortCatalog
    from presto_tpu_torch.connectors.memory import MemoryConnector as PortMemory
    from presto_tpu_torch.page import Page as PortPage
    from presto_tpu_torch.runner import QueryRunner as PortRunner

    rng = np.random.default_rng(19)
    n = 60

    def arr():
        if rng.random() < 0.1:
            return None
        return [None if rng.random() < 0.15 else int(v)
                for v in rng.integers(-3, 6, rng.integers(0, 7))]

    def mp():
        if rng.random() < 0.1:
            return None
        keys = rng.choice(10, rng.integers(0, 5), replace=False)
        return {int(k): (None if rng.random() < 0.15 else int(rng.integers(-5, 9)))
                for k in keys}

    vals = [np.arange(n), [arr() for _ in range(n)], [arr() for _ in range(n)],
            [mp() for _ in range(n)], rng.integers(0, 4, n)]
    valids = [None, np.array([v is not None for v in vals[1]]),
              np.array([v is not None for v in vals[2]]),
              np.array([v is not None for v in vals[3]]), None]
    names = ["id", "a", "b", "m", "g"]
    mem = MemoryConnector()
    rtypes = [BIGINT, ArrayType(BIGINT, 8), ArrayType(BIGINT, 8), MapType(BIGINT, BIGINT, 6),
              BIGINT]
    mem.create_table("r", list(zip(names, rtypes)),
                     [Page.from_arrays(vals, rtypes, valids=valids)])
    cat = Catalog()
    cat.register("mem", mem)
    pmem = PortMemory(device="cpu")
    ptypes = [pt.BIGINT, pt.ArrayType(pt.BIGINT, 8), pt.ArrayType(pt.BIGINT, 8),
              pt.MapType(pt.BIGINT, pt.BIGINT, 6), pt.BIGINT]
    pmem.create_table("r", list(zip(names, ptypes)),
                      [PortPage.from_arrays(vals, ptypes, valids=valids, device="cpu")])
    pcat = PortCatalog()
    pcat.register("mem", pmem)
    return QueryRunner(cat), PortRunner(pcat, device="cpu")


@pytest.mark.parametrize("i", range(len(LAMBDA_SQL)))
def test_lambda_and_unnest_sql_equal_reference(lambda_runners, i):
    ref, port = lambda_runners
    sql = LAMBDA_SQL[i]
    want, got = ref.execute(sql), port.execute(sql)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.rows == want.rows
