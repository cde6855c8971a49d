"""K19 ``ml_state``, K20 ``ml_finalize`` and K12's REGRESS and CLASSIFY
against the reference's ``presto_tpu/ops/aggregate.py`` and
``_compile_ml`` (``presto_tpu/expr/compile.py``).

The ML aggregates' partial states (learn_regressor and learn_classifier
:600, evaluate_classifier_predictions :574) through the port's
``grouped_aggregate`` on the global, packed-direct and sort paths, their
merge (:1176) through ``merge_aggregate`` over the reference's own
partial pages, the fold of two packed tables, and the finalizes (:1506,
:1517, :1541) over seeded pages with NULLs, NULL feature elements and
dead rows: double features, a decimal label over a decimal features
array (its unscaled values, as the reference's ``astype``), class ids
outside ``[0, 8)`` and a varchar label (its dictionary codes).

The reference's functions run under ``jax.jit``, as its runner runs
them.  Tolerances: counts and evaluate's tp / fp / fn are exact.  A state's
double lanes add in the port's fixed order and the reference's segment
sums in XLA's, so each agrees within a relative 1e-9 of the lane's
largest magnitude over the groups (a lane of one-hot products sums
values of both signs).  The regressor's weights solve the normal
equations of those sums: the reference's LAPACK solve and the port's
own elimination agree to the conditioning of ``X'X + 1e-8 I``, so the
weights are held to ``1e3 * cond * eps`` of their norm, with ``cond``
from a float64 numpy solve of the same sums; the classifier's prior,
means and variances within a relative 1e-9 (a variance also within
1e-9 of its group's ``sumx2 / count``, from which it cancels).
REGRESS is within a relative 1e-9; CLASSIFY's class is exact except
where the two best log-likelihoods lie within a relative 1e-12 of each
other (the logs are XLA's and torch's)."""

import jax
import numpy as np
import pytest
import torch

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import container_eval as k12
from presto_tpu_torch.kernels import ml_finalize as k20
from presto_tpu_torch.kernels import ml_state as k19
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.types import parse_type as port_type

WORDS = ["a", "b", "c", "d", "e", "f", "g", "h", "i", "j"]
COLUMNS = [("g", "bigint"), ("x1", "double"), ("x2", "double"), ("x3", "double"),
           ("q", "decimal(12,2)"), ("y", "double"), ("lab", "bigint"), ("pred", "bigint"),
           ("s", "varchar"), ("f", "integer"), ("fe", "array(double, 3)"),
           ("qa", "array(decimal(12,2), 2)")]


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 3)) * np.array([1.0, 30.0, 0.05])
    d = {"g": rng.integers(0, 10, n), "x1": x[:, 0], "x2": x[:, 1], "x3": x[:, 2],
         "q": rng.integers(100, 5000, n), "lab": rng.integers(-1, 10, n),
         "pred": rng.integers(-1, 10, n), "s": rng.integers(0, len(WORDS), n).astype(np.int32),
         "f": rng.integers(-20, 20, n).astype(np.int32)}
    d["y"] = 2.0 * x[:, 0] - 0.5 * x[:, 1] + 3.0 * x[:, 2] + 1.25 + rng.normal(0, 0.1, n)
    fe = np.concatenate([np.full((n, 1), 3.0), x], 1)
    fe[:, 1:][rng.random((n, 3)) < 0.05] = np.nan  # NULL elements
    d["fe"] = fe
    qa = np.stack([np.full(n, 2), rng.integers(100, 5000, n), rng.integers(1, 90, n)], 1)
    qa[:, 2][rng.random(n) < 0.05] = -(1 << 63)
    d["qa"] = qa
    valids = {c: rng.random(n) >= 0.05 for c, _ in COLUMNS}
    return d, valids, rng.random(n) >= 0.1


def _pages(seed, n=1536):
    import jax.numpy as jnp

    from presto_tpu.page import Block as RB, Dictionary as RD, Page as RP
    from presto_tpu_torch.page import Block as PB, Dictionary as PD, Page as PP

    d, valids, mask = _data(seed, n)
    rd, pd = RD(WORDS), PD(WORDS)
    ref = RP(tuple(RB(jnp.asarray(d[c]), jnp.asarray(valids[c]), ref_type(t),
                      rd if t == "varchar" else None) for c, t in COLUMNS), jnp.asarray(mask))
    port = PP(tuple(PB(torch.from_numpy(np.ascontiguousarray(d[c])),
                       torch.from_numpy(valids[c]), port_type(t),
                       pd if t == "varchar" else None) for c, t in COLUMNS),
              torch.from_numpy(mask))
    return ref, port


def C(name):
    return ("col", name)


def F(fn, t, *args):
    return ("call", fn, t) + args


def _build(spec, ir, parse_type):
    if spec[0] == "col":
        i = [c for c, _ in COLUMNS].index(spec[1])
        return ir.ColumnRef(type=parse_type(COLUMNS[i][1]), index=i)
    _, fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn, args=tuple(_build(a, ir, parse_type)
                                                         for a in args))


FEATS3 = F("array_construct", "array(double, 3)", C("x1"), C("x2"), C("x3"))
FEATS2 = F("array_construct", "array(double, 2)", F("cast_double", "double", C("f")), C("x1"))
SPECS = [
    ("learn_regressor", C("y"), FEATS3), ("learn_regressor", C("q"), C("qa")),
    ("learn_classifier", C("lab"), C("fe")), ("learn_classifier", C("s"), FEATS2),
    ("evaluate_classifier_predictions", C("lab"), C("pred")),
]


def _aggs(ir, parse_type, agg_module, specs=SPECS):
    out = []
    for fn, arg, arg2 in specs:
        a, a2 = _build(arg, ir, parse_type), _build(arg2, ir, parse_type)
        call = ir.AggCall(fn=fn, arg=a, type=parse_type("bigint"), arg2=a2)
        out.append(ir.AggCall(fn=fn, arg=a, type=agg_module.output_type(call), arg2=a2))
    return out


def _keys(path):
    if path == "global":
        return [], [], None, 1
    ref_k = [_build(C("g"), ref_ir, ref_type)]
    port_k = [_build(C("g"), port_ir, port_type)]
    # eleven groups either way (ten keys and NULL): the reference's eager
    # ops then share their compiled shapes across the paths
    return ref_k, port_k, ([(0, 9)] if path == "packed" else None), 11


def _lane_close(p, r, what):
    """Within a relative 1e-9 of each lane's largest magnitude."""
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    scale = np.abs(r).max(axis=0, initial=0.0)
    bad = np.abs(p - r) > 1e-9 * scale[None, :]
    assert not bad.any(), (what, np.argwhere(bad)[:5], p[bad][:5], r[bad][:5])


def _states_equal(port, ref, num_keys, aggs):
    mask = np.asarray(ref.row_mask)
    np.testing.assert_array_equal(port.row_mask.numpy(), mask)
    for pb, rb in zip(port.blocks[:num_keys], ref.blocks[:num_keys]):
        np.testing.assert_array_equal(pb.data.numpy()[mask], np.asarray(rb.data)[mask])
    pos = num_keys
    for agg in aggs:
        (ps, rs), (pc, rc) = [(port.blocks[pos + j].data.numpy(),
                               np.asarray(ref.blocks[pos + j].data)) for j in range(2)]
        pos += 2
        np.testing.assert_array_equal(pc[mask], rc[mask], agg.fn)
        live = mask & (rc > 0)
        if agg.fn == "evaluate_classifier_predictions":
            np.testing.assert_array_equal(ps[live], rs[live], agg.fn)
        else:
            _lane_close(ps[live], rs[live], agg.fn)


_PARTIALS = {}


def _partials(path):
    """(reference partial page, port partial page) of ``_pages(1)`` on
    ``path``, each computed once (the reference's sort path pads to
    max_groups: its live rows)."""
    if path not in _PARTIALS:
        ref_page, port_page = _pages(1)
        ref_k, port_k, domains, mg = _keys(path)
        ra, pa = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
        ref = jax.jit(lambda p: ref_agg.grouped_aggregate(p, ref_k, ra, mg, key_domains=domains,
                                                          mode="partial"))(ref_page)
        port = port_agg.grouped_aggregate(port_page, port_k, pa, mg, key_domains=domains,
                                          mode="partial")
        _PARTIALS[path] = (_compact(ref) if path == "sort" else ref, port)
    return _PARTIALS[path]


@pytest.mark.parametrize("path", ["global", "packed", "sort"])
def test_partial_states_equal_reference(path):
    ref_k, port_k, domains, mg = _keys(path)
    pa = _aggs(port_ir, port_type, port_agg)
    assert port_agg.takes_sort_path(port_k, domains, mg, pa) == (path == "sort")
    ref, port = _partials(path)
    _states_equal(port, ref, len(ref_k), pa)


def _compact(page):
    import jax.numpy as jnp

    from presto_tpu.page import Block, Page

    live = np.nonzero(np.asarray(page.row_mask))[0]
    return Page(tuple(Block(jnp.asarray(np.asarray(b.data)[live]),
                            jnp.asarray(np.asarray(b.valid)[live]), b.type, b.dictionary)
                      for b in page.blocks), jnp.ones(live.shape[0], jnp.bool_))


def _port_copy(ref_page, types):
    """The port page holding ``ref_page``'s state (the container types
    given: ``str`` drops their slot counts)."""
    from presto_tpu_torch.page import Block, Page

    return Page(tuple(Block(torch.from_numpy(np.array(b.data)), torch.from_numpy(
        np.array(b.valid)), t, None) for b, t in zip(ref_page.blocks, types)),
        torch.from_numpy(np.array(ref_page.row_mask)))


def test_merge_of_reference_partials_equals_reference():
    """K19's merge over the reference's own partial states by key (its
    sort-path partials twice over: each group meets two partial rows),
    against the reference's ``merge_aggregate`` (mode partial)."""
    import jax.numpy as jnp

    from presto_tpu.page import Page as RP

    ref_k, port_k, domains, mg = _keys("sort")
    ra, pa = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    part = _partials("sort")[0]
    both = RP(tuple(type(b)(jnp.concatenate([b.data, b.data]), jnp.concatenate([b.valid,
                                                                                 b.valid]),
                            b.type, b.dictionary) for b in part.blocks),
              jnp.concatenate([part.row_mask, part.row_mask]))
    types = [port_type("bigint")] * len(ref_k) + [t for a in pa for t in
                                                   port_agg.state_types(a)]
    ref = jax.jit(lambda p: ref_agg.merge_aggregate(p, len(ref_k), ra, mg, key_domains=domains,
                                                    mode="partial"))(both)
    port = port_agg.merge_aggregate(_port_copy(both, types), len(ref_k), pa, mg,
                                    key_domains=domains, mode="partial")
    _states_equal(port, _compact(ref), len(ref_k), pa)


def test_packed_fold_equals_merge():
    """Two packed tables folded slot by slot (K19's merge, a's row then
    b's) give the sort path's merge of the same partials."""
    ref_k, port_k, domains, mg = _keys("packed")
    pa = _aggs(port_ir, port_type, port_agg)
    parts = [port_agg.grouped_aggregate(_pages(s)[1], port_k, pa, mg, key_domains=domains,
                                        mode="partial") for s in (4, 5)]
    folded = port_agg.combine_packed_states(parts[0], parts[1], 1, pa)
    from presto_tpu_torch.page import concat_pages_device

    merged = port_agg.merge_aggregate(concat_pages_device(parts), 1, pa, mg,
                                      key_domains=domains, mode="partial")
    live = folded.row_mask
    keys = folded.blocks[0].data[live]
    order = torch.argsort(merged.blocks[0].data)
    assert torch.equal(merged.blocks[0].data[order], keys)
    for j in range(1, len(folded.blocks)):
        assert torch.equal(folded.blocks[j].data[live], merged.blocks[j].data[order]), j


def test_direct_table_counts_the_launched_slots():
    """K19's packed-direct table holds the ``max_groups`` slots it is
    launched with, however few the key domains pack into: past
    ``k19.DIRECT_LANES`` lanes the grouping takes the sort path, whose
    states equal the reference's."""
    ref_k, port_k, domains, mg = _keys("packed")
    pa = _aggs(port_ir, port_type, port_agg)
    wide = k19.DIRECT_LANES  # every state has at least two lanes
    assert not port_agg.takes_sort_path(port_k, domains, mg, pa)
    assert port_agg.takes_sort_path(port_k, domains, wide, pa)
    port = port_agg.grouped_aggregate(_pages(1)[1], port_k, pa, wide, key_domains=domains,
                                      mode="partial")
    _states_equal(_by_key(port, torch.from_numpy), _by_key(_partials("packed")[0]),
                  len(ref_k), pa)


def _by_key(page, wrap=np.asarray):
    """A one-key partial page's live rows in key order (NULL first, its
    key 0), each column wrapped by ``wrap``."""
    from types import SimpleNamespace

    live = np.nonzero(np.asarray(page.row_mask))[0]
    valid = np.asarray(page.blocks[0].valid)[live]
    key = np.where(valid, np.asarray(page.blocks[0].data)[live], 0)
    order = np.lexsort((key, valid))
    cols = [key[order]] + [np.array(b.data)[live[order]] for b in page.blocks[1:]]
    return SimpleNamespace(row_mask=wrap(np.ones(order.shape[0], bool)),
                           blocks=[SimpleNamespace(data=wrap(c)) for c in cols])


def _cond_bound(state, k):
    dim = k + 1
    a = state[:, 1:1 + dim * dim].reshape(-1, dim, dim) + 1e-8 * np.eye(dim)
    return 1e3 * np.linalg.cond(a) * np.finfo(np.float64).eps


@pytest.mark.parametrize("path", ["packed", "sort"])
def test_finalized_models_equal_reference(path):
    """Each package's finalize (the port's K20 and pass-through, the
    reference's ``_finalize``) of its own partial states."""
    ref_k, port_k, domains, mg = _keys(path)
    ra, pa = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref_states, states = _partials(path)
    nk = len(ref_k)
    cols, _ = ref_agg._slice_state_cols(ref_states, nk, ra)
    ref = jax.jit(lambda c: ref_agg._finalize(c, ra))(cols)
    port = port_agg._finalize([[b.data for b in c] for c in port_agg._slice_state_cols(
        states, nk, pa)], pa, [None] * len(pa), states.row_mask)
    mask = np.asarray(ref_states.row_mask)
    for i, agg in enumerate(pa):
        pb, rb = port[i], ref[i]
        valid = np.asarray(rb.valid) & mask
        np.testing.assert_array_equal(pb.valid.numpy() & mask, valid, agg.fn)
        p, r = pb.data.numpy()[valid], np.asarray(rb.data)[valid]
        if agg.fn == "evaluate_classifier_predictions":
            np.testing.assert_array_equal(p, r)  # the count matrix, before the host finalize
            continue
        if agg.fn == "learn_regressor":
            k = agg.arg2.type.max_elems
            bound = _cond_bound(states.blocks[nk + 2 * i].data.numpy()[valid], k)
            err = np.abs(p[:, 1:] - r[:, 1:]).max(1) / np.abs(r[:, 1:]).max(1)
            assert (err <= bound).all(), (err, bound)
            np.testing.assert_array_equal(p[:, 0], r[:, 0])
            continue
        k = agg.arg2.type.max_elems
        s = states.blocks[nk + 2 * i].data.numpy()[valid]
        scale = np.abs(s[:, 1 + 8 + 8 * k:]).max(1, initial=0.0) / np.maximum(s[:, 1:9].max(1),
                                                                             1.0)
        np.testing.assert_allclose(p[:, :2 + 8 + 8 * k], r[:, :2 + 8 + 8 * k], rtol=1e-9)
        assert (np.abs(p[:, 2 + 8 + 8 * k:] - r[:, 2 + 8 + 8 * k:])
                <= 1e-9 * np.maximum(np.abs(r[:, 2 + 8 + 8 * k:]), scale[:, None])).all()


def test_ml_finalize_twin_solves_the_normal_equations():
    """The twin's elimination against numpy's solve of the same system."""
    rng = np.random.default_rng(8)
    k, n = 3, 500
    feats = torch.from_numpy(np.concatenate([np.full((n, 1), 3.0), rng.normal(0, 5, (n, 3))],
                                            1))
    y = torch.from_numpy(rng.normal(0, 1, n))
    st, _ = k19.ml_state(k19.REGRESSOR, 1, torch.ones(n, dtype=torch.bool), k=k,
                         feats=feats, y=y)
    w = k20.ml_finalize(k20.REGRESSOR, st, k)[0, 1:].numpy()
    dim = k + 1
    s = st[0, 1:].numpy()
    want = np.linalg.solve(s[:dim * dim].reshape(dim, dim) + 1e-8 * np.eye(dim),
                           s[dim * dim:])
    np.testing.assert_allclose(w, want, rtol=float(_cond_bound(st.numpy(), k)[0]) * 10)


def _model_pages(seed, n=1024, k=3):
    """Model and features columns in both packages: each row a model
    trained on a seeded group (K19 and K20's twins), features with NULL
    elements."""
    import jax.numpy as jnp

    from presto_tpu.page import Block as RB, Page as RP
    from presto_tpu_torch.page import Block as PB, Page as PP

    rng = np.random.default_rng(seed)
    x = np.concatenate([np.full((4000, 1), float(k)), rng.normal(0, 2, (4000, k))], 1)
    lab = torch.from_numpy(rng.integers(0, 8, 4000))
    g = torch.from_numpy(rng.integers(0, 16, 4000))
    order = torch.argsort(g, stable=True)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.cumsum(torch.bincount(g, minlength=16), 0)])
    sel = torch.ones(4000, dtype=torch.bool)
    xt = torch.from_numpy(x)
    y = xt[:, 1:] @ torch.arange(1.0, k + 1, dtype=torch.float64) + 0.5
    reg = k20.ml_finalize(k20.REGRESSOR, k19.ml_state(k19.REGRESSOR, 16, sel, k=k, feats=xt,
                                                      y=y, order=order, starts=starts)[0], k)
    nb = k20.ml_finalize(k20.CLASSIFIER, k19.ml_state(k19.CLASSIFIER, 16, sel, k=k, feats=xt,
                                                      label=lab, order=order, starts=starts)[0], k)
    pick = rng.integers(0, 16, n)
    feats = np.concatenate([np.full((n, 1), float(k)), rng.normal(0, 2, (n, k))], 1)
    feats[:, 1:][rng.random((n, k)) < 0.05] = np.nan
    cols = [(reg.numpy()[pick], f"array(double, {k + 1})"),
            (nb.numpy()[pick], f"array(double, {nb.shape[1] - 1})"),
            (feats, f"array(double, {k})")]
    valid = [rng.random(n) >= 0.05 for _ in cols]
    ref = RP(tuple(RB(jnp.asarray(d), jnp.asarray(v), ref_type(t)) for (d, t), v in
                   zip(cols, valid)), jnp.ones(n, jnp.bool_))
    port = PP(tuple(PB(torch.from_numpy(np.ascontiguousarray(d)), torch.from_numpy(v),
                       port_type(t)) for (d, t), v in zip(cols, valid)),
              torch.ones(n, dtype=torch.bool))
    return ref, port, [t for _, t in cols]


@pytest.mark.parametrize("fn", ["regress", "classify"])
def test_regress_and_classify_equal_reference(fn):
    from presto_tpu.expr.compile import ExprCompiler as RefCompiler
    from presto_tpu_torch.expr.compile import ExprCompiler

    ref_page, port_page, types = _model_pages(9)

    def expr(ir, parse_type):
        m = ir.ColumnRef(type=parse_type(types[0 if fn == "regress" else 1]),
                         index=0 if fn == "regress" else 1)
        f = ir.ColumnRef(type=parse_type(types[2]), index=2)
        return ir.Call(type=parse_type("double" if fn == "regress" else "bigint"), fn=fn,
                       args=(m, f))

    rc = RefCompiler([b.type for b in ref_page.blocks], [None] * 3)
    rd, rv = (np.asarray(a) for a in rc.compile(expr(ref_ir, ref_type))(ref_page))
    pd, pv = ExprCompiler.for_page(port_page).compile(expr(port_ir, port_type))(port_page)
    np.testing.assert_array_equal(pv.numpy(), rv)
    if fn == "regress":
        np.testing.assert_allclose(pd.numpy()[rv], rd[rv], rtol=1e-9)
        return
    ll = k12.classify_ll_plain(port_page.blocks[1].data, port_page.blocks[2].data, 3, 8)
    top2 = torch.topk(ll, 2, 1).values.numpy()
    clear = np.abs(top2[:, 0] - top2[:, 1]) > 1e-12 * np.abs(top2[:, 0])
    np.testing.assert_array_equal(pd.numpy()[rv & clear], rd[rv & clear])
    assert (rv & clear).sum() > 900
