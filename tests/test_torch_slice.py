"""The whole slice: numpy corpus -> sketch -> knn (and a threshold query),
through repro and through repro_torch, with the reference's R carried
across through ``repro_torch.convert``.

Two non-negative clustered corpora: a loose one (noise 0.25 around the
centres), whose estimates are spread out so that most neighbours are
isolated and their indices can be compared one by one, and the tight one of
examples/knn_search.py (noise 0.02), where the sketch noise dwarfs the
distances inside a cluster and what must hold is the example's own gate:
the margin-MLE's first neighbour lies in the query's cluster.

Tolerances: the two sketches of one row agree to float32 rounding of their
sums (see test_torch_sketch.py), and an estimate amplifies that by the
interaction coefficients, so values agree to an atol of 1e-4 of
na + nb + sum_K |A||B|.  Indices must be equal wherever the reference value
is more than that atol from its neighbours in the sorted row; the cluster
of every first neighbour must be equal outright, and every neighbour either
package picks must have a reference estimate within the atol of the
reference's value at that rank (a valid choice among near-ties).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import pairwise as jpw
from repro.core import projections as jproj
from repro_torch import convert
from repro_torch import engine as tengine
from repro_torch.core import pairwise as tpw
from repro_torch.core import projections as tproj

jsketch = importlib.import_module("repro.core.sketch")
tsketch = importlib.import_module("repro_torch.core.sketch")

N, D, Q, CLUSTERS = 240, 512, 16, 8


def _corpus(seed, noise):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 1, (CLUSTERS, D)).astype(np.float32)
    labels = np.arange(N) % CLUSTERS
    corpus = np.abs(centres[labels] + noise * rng.standard_normal((N, D))).astype(np.float32)
    qlabels = rng.integers(0, CLUSTERS, Q)
    queries = np.abs(centres[qlabels] + noise * rng.standard_normal((Q, D))).astype(np.float32)
    return corpus, queries, labels, qlabels


def _slice(strategy, seed=0, noise=0.25):
    """Both packages' sketches of one corpus and its queries, one R."""
    corpus, queries, labels, qlabels = _corpus(seed, noise)
    jcfg = jsketch.SketchConfig(p=4, k=64, strategy=strategy, block_d=256)
    tcfg = tsketch.SketchConfig(p=4, k=64, strategy=strategy, block_d=256,
                                projection=tproj.ProjectionSpec())
    key = jax.random.key(seed)
    mids = [0] if strategy == "basic" else [1, 2, 3]
    tiles = {(mid, b): np.asarray(jproj.projection_block(
        jax.random.fold_in(key, mid), b, 256, 64, jcfg.projection))
        for mid in mids for b in range(D // 256)}
    tkey = convert.projection_key_from_tiles(tiles, tcfg.projection)
    js = [jsketch.sketch(jnp.asarray(x), key, jcfg) for x in (queries, corpus)]
    ts = [tsketch.sketch(torch.from_numpy(x), tkey, tcfg) for x in (queries, corpus)]
    return jcfg, tcfg, js, ts, labels, qlabels


def _atol(jq, jc, jcfg) -> float:
    A, _, na = (np.asarray(t, np.float64) for t in jpw.pack_sketch(jq, jcfg))
    _, B, nb = (np.asarray(t, np.float64) for t in jpw.pack_sketch(jc, jcfg))
    return 1e-4 * float(na.max() + nb.max() + (np.abs(A) @ np.abs(B).T).max())


def _assert_knn_agrees(got, want, dense, atol):
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    rows = np.arange(gi.shape[0])[:, None]
    np.testing.assert_allclose(dense[rows, gi], wv, rtol=0, atol=2 * atol)
    srt = np.sort(dense, axis=1)
    k = wv.shape[1]
    prev_gap = np.diff(srt, axis=1, prepend=-np.inf)[:, :k]
    next_gap = np.diff(srt, axis=1, append=np.inf)[:, :k]
    isolated = (prev_gap > atol) & (next_gap > atol)
    np.testing.assert_array_equal(gi[isolated], wi[isolated])
    return gi, wi, isolated


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
@pytest.mark.parametrize("mle", [False, True])
def test_sketch_then_knn_matches_reference(strategy, mle):
    jcfg, tcfg, (jq, jc), (tq, tc), labels, qlabels = _slice(strategy)
    estimator = "mle" if mle else "plain"
    dense_fn = jpw.pairwise_margin_mle if mle else jpw.pairwise_distances
    atol = _atol(jq, jc, jcfg)
    want = jpw.knn(jq, jc, jcfg, top_k=5, mle=mle)
    got = tpw.knn(tq, tc, tcfg, top_k=5, mle=mle)
    _assert_knn_agrees(got, want, np.asarray(dense_fn(jq, jc, jcfg)), atol)
    # the nearest estimates are mostly clipped to 0 here, a tie that only the
    # lowest-index rule decides (test_torch_engine.py forces that case); the
    # unclipped estimates spread out, so most ranks are isolated
    want = jengine.pairwise(jq, jc, jcfg, reduce="topk", top_k=5, estimator=estimator,
                            clip=False)
    got = tengine.pairwise(tq, tc, tcfg, reduce="topk", top_k=5, estimator=estimator,
                           clip=False)
    _, _, isolated = _assert_knn_agrees(got, want,
                                        np.asarray(dense_fn(jq, jc, jcfg, clip=False)), atol)
    assert isolated.mean() > 0.5  # the index check has teeth


@pytest.mark.parametrize("seed", [3, 4])
def test_tight_clusters_pass_the_example_gate_in_both(seed):
    """examples/knn_search.py's data kind and strategy: MLE cluster
    recall@1 >= 0.9 in both packages, with the same clusters chosen."""
    jcfg, tcfg, (jq, jc), (tq, tc), labels, qlabels = _slice("basic", seed=seed,
                                                             noise=0.02)
    want = jpw.knn(jq, jc, jcfg, top_k=5, mle=True)
    got = tpw.knn(tq, tc, tcfg, top_k=5, mle=True)
    dense = np.asarray(jpw.pairwise_margin_mle(jq, jc, jcfg))
    gi, wi, _ = _assert_knn_agrees(got, want, dense, _atol(jq, jc, jcfg))
    np.testing.assert_array_equal(labels[gi[:, 0]], labels[wi[:, 0]])
    assert np.mean(labels[gi[:, 0]] == qlabels) >= 0.9
    assert np.mean(labels[wi[:, 0]] == qlabels) >= 0.9


def test_sketch_then_relative_threshold_matches_reference():
    jcfg, tcfg, (jq, jc), (tq, tc), labels, _ = _slice("basic", seed=1)
    dense = np.asarray(jpw.pairwise_distances(jq, jc, jcfg))
    scale = np.asarray(jq.norm_pp(4))[:, None] + np.asarray(jc.norm_pp(4))[None, :]
    radius = float(np.quantile((dense / scale)[dense > 0], 0.2))
    eng = (jengine.EngineConfig(row_block=5, col_block=64),
           tengine.EngineConfig(row_block=5, col_block=64))
    wr, wc = jengine.pairwise(jq, jc, jcfg, reduce="threshold", radius=radius,
                              relative=True, engine=eng[0])
    gr, gc = tengine.pairwise(tq, tc, tcfg, reduce="threshold", radius=radius,
                              relative=True, engine=eng[1])
    atol = _atol(jq, jc, jcfg)
    thr = np.float32(radius) * scale
    got, want = set(zip(gr.tolist(), gc.tolist())), set(zip(wr.tolist(), wc.tolist()))
    assert len(want) > 50
    assert all(abs(dense[i, j] - thr[i, j]) <= atol for i, j in got ^ want)


def test_engine_full_matches_dense_reference():
    jcfg, tcfg, (jq, jc), (tq, tc), _, _ = _slice("basic", seed=2)
    want = np.asarray(jpw.pairwise_distances(jq, jc, jcfg))
    got = tengine.pairwise(tq, tc, tcfg, reduce="full",
                           engine=tengine.EngineConfig(row_block=6, col_block=50))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_atol(jq, jc, jcfg))
