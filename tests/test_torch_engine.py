"""repro_torch's packed estimate, estimators and streaming engine against
repro's, on one LpSketch made by repro and carried across.

Every test sketches numpy rows with ``repro`` and hands the same sketch
(U, moments) to the port through ``repro_torch.convert``, so both sides
estimate from identical inputs.

Tolerances: an estimate is na + nb + sum_K A B in float32, summed in
another order by each framework, so values agree to an atol of 1e-5 of
na + nb + sum_K |A||B| (the float32 error bound of that sum, with room).
The margin-MLE's Newton steps divide by f'(a), which can grow that error,
so its atol is 1e-4 of the same scale.  Top-k indices must be equal
wherever the reference value is isolated: more than the atol from its
neighbours in the sorted row.  Threshold hits must be equal except for
pairs whose reference estimate lies within the atol of the threshold.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import estimators as jest
from repro.core import pairwise as jpw
from repro.engine import reduce as jreduce
from repro_torch import convert
from repro_torch import engine as tengine
from repro.core import registry as jreg
from repro_torch.core import estimators as test_
from repro_torch.core import registry as treg
from repro_torch.core import pairwise as tpw
from repro_torch.engine import reduce as treduce
from repro_torch.kernels.pairwise_lp import pairwise_lp

jsketch = importlib.import_module("repro.core.sketch")
tsketch = importlib.import_module("repro_torch.core.sketch")

STRIPS = [(None, None), (7, 13), (64, 5)]  # (row_block, col_block)


def _cfgs(strategy="basic", p=4, k=32):
    return (jsketch.SketchConfig(p=p, k=k, strategy=strategy, block_d=64),
            tsketch.SketchConfig(p=p, k=k, strategy=strategy, block_d=64))


def _sketches(strategy="basic", n=37, m=90, D=128, seed=0, p=4, k=32):
    """Clustered non-negative rows (so neighbours mean something), sketched
    by repro and carried into the port."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 1, (6, D)).astype(np.float32)

    def rows(r):
        return (centres[rng.integers(0, 6, r)]
                + 0.05 * rng.standard_normal((r, D))).astype(np.float32)

    jcfg, tcfg = _cfgs(strategy, p, k)
    key = jax.random.key(seed)
    ja = jsketch.sketch(jnp.asarray(rows(n)), key, jcfg)
    jb = jsketch.sketch(jnp.asarray(rows(m)), key, jcfg)
    ta = convert.sketch_from_reference(np.asarray(ja.U), np.asarray(ja.moments),
                                       device="cpu")
    tb = convert.sketch_from_reference(np.asarray(jb.U), np.asarray(jb.moments),
                                       device="cpu")
    return jcfg, tcfg, ja, jb, ta, tb


def _scale(ja, jb, jcfg) -> float:
    A, _, na = (np.asarray(t, np.float64) for t in jpw.pack_sketch(ja, jcfg))
    _, B, nb = (np.asarray(t, np.float64) for t in jpw.pack_sketch(jb, jcfg))
    return float(na.max() + nb.max() + (np.abs(A) @ np.abs(B).T).max())


def _engines(rb, cb):
    return (jengine.EngineConfig(row_block=rb, col_block=cb),
            tengine.EngineConfig(row_block=rb, col_block=cb))


def _assert_topk_agrees(got, want, dense_ref, atol):
    """Values close; indices equal wherever the reference value is isolated."""
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(t) for t in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    srt = np.sort(np.asarray(dense_ref), axis=1)
    k = wv.shape[1]
    prev_gap = np.diff(srt, axis=1, prepend=-np.inf)[:, :k]
    next_gap = np.diff(srt, axis=1, append=np.inf)[:, :k]
    isolated = (prev_gap > atol) & (next_gap > atol)
    assert isolated.mean() > 0.1  # the check has teeth
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
def test_pack_sketch(strategy):
    jcfg, tcfg, ja, _, ta, _ = _sketches(strategy)
    for got, want in zip(tpw.pack_sketch(ta, tcfg), jpw.pack_sketch(ja, jcfg)):
        # one float32 multiply by the same float32-rounded coefficient
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
@pytest.mark.parametrize("clip", [True, False])
def test_pairwise_distances(strategy, clip):
    jcfg, tcfg, ja, jb, ta, tb = _sketches(strategy, seed=1)
    want = jpw.pairwise_distances(ja, jb, jcfg, clip=clip)
    got = tpw.pairwise_distances(ta, tb, tcfg, clip=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * _scale(ja, jb, jcfg))
    if clip:
        assert float(got.min()) >= 0.0


def test_pairwise_distances_self_pairs_zero_diag():
    jcfg, tcfg, ja, _, ta, _ = _sketches(seed=2)
    want = jpw.pairwise_distances(ja, None, jcfg, zero_diag=True)
    got = tpw.pairwise_distances(ta, None, tcfg, zero_diag=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * _scale(ja, ja, jcfg))
    assert float(got.diagonal().abs().max()) == 0.0


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
@pytest.mark.parametrize("p", [4, 6])
def test_pairwise_margin_mle(strategy, p):
    jcfg, tcfg, ja, jb, ta, tb = _sketches(strategy, p=p, seed=3)
    want = jpw.pairwise_margin_mle(ja, jb, jcfg)
    got = tpw.pairwise_margin_mle(ta, tb, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * _scale(ja, jb, jcfg))


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
def test_rowwise_estimators(strategy):
    jcfg, tcfg, ja, jb, ta, tb = _sketches(strategy, n=40, m=40, seed=4)
    atol = 1e-5 * _scale(ja, jb, jcfg)
    np.testing.assert_allclose(test_.estimate(ta, tb, tcfg, clip=False).numpy(),
                               np.asarray(jest.estimate(ja, jb, jcfg, clip=False)),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(test_.interaction_dots(ta, tb, tcfg).numpy(),
                               np.asarray(jest.interaction_dots(ja, jb, jcfg)),
                               rtol=0, atol=atol * tcfg.k)
    np.testing.assert_allclose(
        test_.estimate_margin_mle(ta, tb, tcfg, clip=True).numpy(),
        np.asarray(jest.estimate_margin_mle(ja, jb, jcfg, clip=True)),
        rtol=0, atol=10 * atol)


def test_margin_mle_root_keeps_the_cauchy_schwarz_clamp():
    """Raw Newton inputs, including t far outside the |a| <= sqrt(Mx My)
    ball and a zero slope, agree with the reference and stay clamped."""
    rng = np.random.default_rng(5)
    t = rng.normal(0, 50, 200).astype(np.float32)
    nu = rng.uniform(1, 40, 200).astype(np.float32)
    nv = rng.uniform(1, 40, 200).astype(np.float32)
    Mx = rng.uniform(0.01, 2, 200).astype(np.float32)
    My = rng.uniform(0.01, 2, 200).astype(np.float32)
    Mx[:5] = 0.0  # degenerate margins: the ball is {0}
    for steps in (0, 1, 2, 4):
        want = np.asarray(jest.margin_mle_root(*(jnp.asarray(a) for a in (t, nu, nv, Mx, My)),
                                               16, steps))
        got = test_.margin_mle_root(*(torch.from_numpy(a) for a in (t, nu, nv, Mx, My)),
                                    16, steps).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert np.all(np.abs(got) <= np.sqrt(Mx * My) * (1 + 1e-6))
        assert np.all(got[:5] == 0.0)


@pytest.mark.parametrize("rb,cb", STRIPS)
def test_engine_full(rb, cb):
    jcfg, tcfg, ja, jb, ta, tb = _sketches(seed=6)
    je, te = _engines(rb, cb)
    want = jengine.pairwise(ja, jb, jcfg, reduce="full", engine=je)
    got = tengine.pairwise(ta, tb, tcfg, reduce="full", engine=te)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * _scale(ja, jb, jcfg))


@pytest.mark.parametrize("rb,cb", STRIPS)
@pytest.mark.parametrize("estimator", ["plain", "mle"])
def test_engine_topk(rb, cb, estimator):
    jcfg, tcfg, ja, jb, ta, tb = _sketches(seed=7)
    je, te = _engines(rb, cb)
    want = jengine.pairwise(ja, jb, jcfg, reduce="topk", top_k=6, estimator=estimator,
                            engine=je)
    got = tengine.pairwise(ta, tb, tcfg, reduce="topk", top_k=6, estimator=estimator,
                           engine=te)
    dense = (jpw.pairwise_distances(ja, jb, jcfg) if estimator == "plain"
             else jpw.pairwise_margin_mle(ja, jb, jcfg))
    factor = 1e-5 if estimator == "plain" else 1e-4
    _assert_topk_agrees(got, want, dense, factor * _scale(ja, jb, jcfg))


def test_engine_topk_through_the_interpreted_pallas_kernel():
    """The reference engine's strips through its Pallas kernel (interpret)."""
    jcfg, tcfg, ja, jb, ta, tb = _sketches(seed=8)
    want = jengine.pairwise(ja, jb, jcfg, reduce="topk", top_k=5,
                            engine=jengine.EngineConfig(backend="interpret",
                                                        row_block=64, col_block=64))
    got = tengine.pairwise(ta, tb, tcfg, reduce="topk", top_k=5,
                           engine=tengine.EngineConfig(backend="kernel",
                                                       row_block=64, col_block=64))
    _assert_topk_agrees(got, want, jpw.pairwise_distances(ja, jb, jcfg),
                        1e-5 * _scale(ja, jb, jcfg))


def test_knn_matches_reference_and_caps_k():
    jcfg, tcfg, ja, jb, ta, tb = _sketches(m=9, seed=9)
    want = jpw.knn(ja, jb, jcfg, top_k=20)
    got = tpw.knn(ta, tb, tcfg, top_k=20)
    assert tuple(got[0].shape) == (37, 9) == tuple(np.asarray(want[0]).shape)
    _assert_topk_agrees(got, want, jpw.pairwise_distances(ja, jb, jcfg),
                        1e-5 * _scale(ja, jb, jcfg))


@pytest.mark.parametrize("rb,cb", STRIPS)
def test_forced_ties_resolve_to_the_lowest_index(rb, cb):
    """Margins far below the interaction terms: about half the estimates
    are clipped to exactly 0, so every top-k is a tie at 0 that only the
    lowest-index rule decides — the port must pick repro's indices exactly."""
    rng = np.random.default_rng(10)
    jcfg, tcfg = _cfgs()
    n, m = 23, 120
    U = {s: rng.standard_normal((r, 3, 32)).astype(np.float32) for s, r in (("a", n), ("b", m))}
    M = {s: np.full((r, 3), 0.5, np.float32) for s, r in (("a", n), ("b", m))}
    ja, jb = (jsketch.LpSketch(jnp.asarray(U[s]), jnp.asarray(M[s])) for s in "ab")
    ta, tb = (convert.sketch_from_reference(U[s], M[s], device="cpu") for s in "ab")
    raw = np.asarray(jpw.pairwise_distances(ja, jb, jcfg, clip=False))
    atol = 1e-5 * _scale(ja, jb, jcfg)
    assert np.abs(raw).min() > atol  # no estimate is ambiguous about its sign
    assert ((raw < 0).sum(axis=1) >= 8).all()  # every row's top-8 is a tie at 0
    je, te = _engines(rb, cb)
    want = jengine.pairwise(ja, jb, jcfg, reduce="topk", top_k=8, engine=je)
    got = tengine.pairwise(ta, tb, tcfg, reduce="topk", top_k=8, engine=te)
    assert float(got[0].abs().max()) == 0.0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    lowest = np.stack([np.flatnonzero(r < 0)[:8] for r in raw])
    np.testing.assert_array_equal(got[1].numpy(), lowest)


@pytest.mark.parametrize("rb,cb", [(None, None), (7, 13)])
@pytest.mark.parametrize("relative", [False, True])
def test_engine_threshold(rb, cb, relative):
    jcfg, tcfg, ja, jb, ta, tb = _sketches(seed=11)
    dense = np.asarray(jpw.pairwise_distances(ja, jb, jcfg))
    na, nb = np.asarray(ja.norm_pp(4)), np.asarray(jb.norm_pp(4))
    scale = na[:, None] + nb[None, :]
    radius = float(np.median(dense / scale)) if relative else float(np.median(dense))
    je, te = _engines(rb, cb)
    wr, wc = jengine.pairwise(ja, jb, jcfg, reduce="threshold", radius=radius,
                              relative=relative, engine=je)
    gr, gc = tengine.pairwise(ta, tb, tcfg, reduce="threshold", radius=radius,
                              relative=relative, engine=te)
    gr, gc = gr.numpy(), gc.numpy()
    # row-major order, as np.nonzero on the dense matrix
    assert np.all(np.diff(gr * 10**6 + gc) > 0)
    thr = np.float32(radius) * (scale if relative else 1.0)
    atol = 1e-5 * _scale(ja, jb, jcfg)
    got_set, want_set = set(zip(gr.tolist(), gc.tolist())), set(zip(wr.tolist(), wc.tolist()))
    assert len(want_set) > 100
    for i, j in got_set ^ want_set:
        assert abs(dense[i, j] - np.broadcast_to(thr, dense.shape)[i, j]) <= atol


@pytest.mark.parametrize("total,block", [(10, 3), (7, 3), (1, 4), (5, 4), (0, 3), (9, 4), (4, 4)])
def test_strip_bounds_never_leave_a_width_one_tail(total, block):
    assert treduce.strip_bounds(total, block) == jreduce.strip_bounds(total, block)
    assert all(c1 - c0 > 1 for c0, c1 in treduce.strip_bounds(total, block)) or total <= 1


def test_engine_topk_on_a_width_one_tail():
    """m = 2*col_block + 1: the single last column joins the second strip."""
    jcfg, tcfg, ja, jb, ta, tb = _sketches(m=21, seed=12)
    je, te = _engines(None, 10)
    want = jengine.pairwise(ja, jb, jcfg, reduce="topk", top_k=4, engine=je)
    got = tengine.pairwise(ta, tb, tcfg, reduce="topk", top_k=4, engine=te)
    _assert_topk_agrees(got, want, jpw.pairwise_distances(ja, jb, jcfg),
                        1e-5 * _scale(ja, jb, jcfg))


def test_merge_and_rerank_break_ties_like_the_reference():
    """Tie-laden candidate lists: merge_topk keeps the reference's order
    when the running list precedes the strip; rerank_topk sorts by (value,
    index) whatever order the candidates arrive in."""
    rng = np.random.default_rng(13)
    vals = rng.integers(0, 4, (6, 5)).astype(np.float32)
    idx = np.stack([rng.permutation(50)[:5] for _ in range(6)]).astype(np.int32)
    order = np.lexsort((idx, vals), axis=-1)
    vals, idx = np.take_along_axis(vals, order, 1), np.take_along_axis(idx, order, 1)
    cv = rng.integers(0, 4, (6, 5)).astype(np.float32)
    ci = (50 + np.arange(5)[None, :].repeat(6, 0)).astype(np.int32)
    cord = np.argsort(cv, axis=1, kind="stable")
    cv, ci = np.take_along_axis(cv, cord, 1), np.take_along_axis(ci, cord, 1)
    want = jreduce.merge_topk(*(jnp.asarray(a) for a in (vals, idx, cv, ci)), 5)
    got = treduce.merge_topk(*(torch.from_numpy(a) for a in (vals, idx, cv, ci)), 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    shuffled = rng.permuted(np.arange(10)[None, :].repeat(6, 0), axis=1)
    av = np.take_along_axis(np.concatenate([vals, cv], 1), shuffled, 1)
    ai = np.take_along_axis(np.concatenate([idx, ci], 1), shuffled, 1)
    want = jreduce.rerank_topk(jnp.asarray(av), jnp.asarray(ai), 4)
    got = treduce.rerank_topk(torch.from_numpy(av), torch.from_numpy(ai), 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_engine_config_resolves_by_device_and_counts_no_launch_on_the_cpu():
    assert tengine.EngineConfig().resolve("cpu") == ("plain", 512, 512)
    assert tengine.EngineConfig().resolve("cuda")[0] == "kernel"
    assert tengine.EngineConfig(backend="plain", col_block=7).resolve("cuda") == (
        "plain", 2048, 7)
    for bad in (dict(backend="xla"), dict(backend="pallas"), dict(row_block=0)):
        with pytest.raises(ValueError):
            tengine.EngineConfig(**bad)
    jcfg, tcfg, ja, jb, ta, tb = _sketches(seed=7)
    before = pairwise_lp.launches
    got = tengine.pairwise(ta, tb, tcfg, reduce="topk", top_k=6,
                           engine=tengine.EngineConfig(backend="kernel"))
    assert pairwise_lp.launches == before
    want = jengine.pairwise(ja, jb, jcfg, reduce="topk", top_k=6)
    _assert_topk_agrees(got, want, jpw.pairwise_distances(ja, jb, jcfg),
                        1e-5 * _scale(ja, jb, jcfg))


def test_engine_rejects_what_the_reference_rejects():
    jcfg, tcfg, ja, jb, ta, tb = _sketches(n=4, m=5, seed=15)
    for kwargs in (dict(reduce="dense"), dict(reduce="threshold"),
                   dict(estimator="gm"), dict(estimator="nope")):
        with pytest.raises(ValueError):
            jengine.pairwise(ja, jb, jcfg, **kwargs)
        with pytest.raises(ValueError):
            tengine.pairwise(ta, tb, tcfg, **kwargs)


@pytest.mark.parametrize("name,p,family", [
    ("plain", 4, "normal"), ("mle", 6, "threepoint"), ("plain", 5, None),
    ("mle", 2, None), ("plain", 4, "stable"), ("mle", 3.5, "uniform"), ("nope", None, None),
])
def test_registry_resolves_like_the_reference(name, p, family):
    """Same spec (name, domain, families, strip kind) or the same error."""
    try:
        want = jreg.resolve(name, p=p, projection=family)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            treg.resolve(name, p=p, projection=family)
        if name != "nope":  # the registered-name list differs by ``gm``
            assert str(got.value) == str(e)
        return
    got = treg.resolve(name, p=p, projection=family)
    assert (got.name, got.p_domain, got.projections, got.uses_packed) == (
        want.name, treg.PDomain(want.p_domain.even_min, want.p_domain.lo,
                                want.p_domain.hi), want.projections, want.uses_packed)


def test_empty_corpus_gives_empty_answers_like_the_reference():
    jcfg, tcfg, ja, jb, ta, tb = _sketches(n=3, m=0, seed=16)
    want = jengine.pairwise(ja, jb, jcfg, reduce="topk", top_k=5)
    got = tengine.pairwise(ta, tb, tcfg, reduce="topk", top_k=5)
    assert tuple(got[0].shape) == tuple(got[1].shape) == np.asarray(want[0]).shape == (3, 0)
    wr, _ = jengine.pairwise(ja, jb, jcfg, reduce="threshold", radius=1.0)
    gr, gc = tengine.pairwise(ta, tb, tcfg, reduce="threshold", radius=1.0)
    assert gr.numel() == gc.numel() == len(wr) == 0
