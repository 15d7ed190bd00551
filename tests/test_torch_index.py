"""repro_torch.index and SketchKnnService against repro.index, on the CPU.

Most tests hand both packages the same sketches: ``repro`` sketches seeded
numpy rows, and the port receives the same (U, moments) through
``repro_torch.convert``.  Each index ingests them through ``ingest_sketch``
in the same batches, so both hold the same rows under the same ids, and
both answer from the same bits.  The raw-row tests carry the reference's R
tiles across instead (``convert.projection_key_from_tiles``).

Tolerances (the engine tests' rules, ``tests/test_torch_engine.py``): an
estimate is na + nb + sum_K A B in float32, summed in another order by each
framework, so plain values agree to 1e-5 of the largest na + nb +
sum_K |A||B|, margin-MLE values to 1e-4 of it (the Newton steps can grow
the error).  Ids must be equal wherever the reference value at that rank is
more than that tolerance from its neighbours in the dense row; threshold
hits must be equal except for pairs within the tolerance of the threshold.
Raw-row sketches differ by float32 rounding of their sums, amplified by the
interaction coefficients, so raw-row queries get 1e-4 of the scale for
both estimators (``tests/test_torch_slice.py``).  Within the port, compaction
and the micro-batcher's single-caller flush move or reuse bits and are held
equal bit for bit.
"""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import index as jindex
from repro.core import pairwise as jpw
from repro.core import projections as jproj
from repro.core import registry as jreg
from repro.index import planner as jplanner
from repro.runtime import serve as jserve
from repro_torch import convert
from repro_torch import index as tindex
from repro_torch.core import pairwise as tpw
from repro_torch.core import registry as treg
from repro_torch.index import planner as tplanner
from repro_torch.runtime import SketchKnnService

jsketch = importlib.import_module("repro.core.sketch")
tsketch = importlib.import_module("repro_torch.core.sketch")

D, P, K = 256, 4, 32
XLA = jengine.EngineConfig(backend="xla")


def _cfgs(strategy="basic", k=K):
    return (jsketch.SketchConfig(p=P, k=k, strategy=strategy, block_d=128),
            tsketch.SketchConfig(p=P, k=k, strategy=strategy, block_d=128))


def _rows(rng, n):
    """Sparse non-negative rows (a fifth of the entries nonzero): rows far
    apart, so that few estimates are clipped to 0 and most ranks are apart
    from their neighbours by more than the tolerance."""
    X = rng.uniform(0, 1, (n, D)) * (rng.uniform(0, 1, (n, D)) < 0.2)
    return X.astype(np.float32)


def _to_port(jsk):
    return convert.sketch_from_reference(np.asarray(jsk.U), np.asarray(jsk.moments),
                                         device="cpu")


class Pair:
    """One reference index and one port index holding the same sketches."""

    def __init__(self, strategy="basic", capacity=32, seed=0, engine=XLA, k=K):
        self.jcfg, self.tcfg = _cfgs(strategy, k)
        self.rng = np.random.default_rng(seed)
        self.key = jax.random.key(seed)
        self.j = jindex.SketchIndex(self.jcfg, seed=seed, engine=engine,
                                    index_cfg=jindex.IndexConfig(segment_capacity=capacity))
        self.t = tindex.SketchIndex(self.tcfg, seed=seed, device="cpu",
                                    index_cfg=tindex.IndexConfig(segment_capacity=capacity))
        self.all_j = []  # every ingested sketch, in id order

    def sketch(self, n):
        jsk = jsketch.sketch(jnp.asarray(_rows(self.rng, n)), self.key, self.jcfg)
        return jsk, _to_port(jsk)

    def ingest(self, n):
        jsk, tsk = self.sketch(n)
        ids_j = self.j.ingest_sketch(jsk)
        ids_t = self.t.ingest_sketch(tsk)
        np.testing.assert_array_equal(ids_t, ids_j)
        self.all_j.append(jsk)
        return ids_j

    def corpus(self):
        return jsketch.LpSketch(U=jnp.concatenate([s.U for s in self.all_j]),
                                moments=jnp.concatenate([s.moments for s in self.all_j]))

    def dense(self, jq, estimator="plain"):
        """(q, ids) reference estimates against every ingested row."""
        spec = jreg.get(estimator)
        return np.asarray(spec.pairwise(jq, self.corpus(), self.jcfg, clip=True))

    def scale(self, jq):
        A, _, na = (np.asarray(t, np.float64) for t in jpw.pack_sketch(jq, self.jcfg))
        _, B, nb = (np.asarray(t, np.float64) for t in jpw.pack_sketch(self.corpus(), self.jcfg))
        return float(na.max() + nb.max() + (np.abs(A) @ np.abs(B).T).max())


def _assert_topk_agrees(got, want, dense, live_ids, atol, teeth=True):
    """Values close; ids equal wherever the reference value is isolated in
    the dense row over the live ids.  ``teeth``: at least a tenth of the
    ranks must be isolated (a small k over clipped estimates may have none;
    the caller then checks a larger k of the same query too)."""
    gv, gi = got[0].numpy(), got[1]
    wv, wi = np.asarray(want[0]), np.asarray(want[1])
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    k = wv.shape[1]
    if k == 0:
        return
    srt = np.sort(dense[:, live_ids], axis=1)
    prev_gap = np.diff(srt, axis=1, prepend=-np.inf)[:, :k]
    next_gap = np.diff(srt, axis=1, append=np.inf)[:, :k]
    isolated = (prev_gap > atol) & (next_gap > atol)
    assert isolated.mean() > 0.1 or not teeth
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


def _live_ids(index):
    return np.sort(np.concatenate(
        [s.row_ids[s.live] for s in index.sealed]
        + [index.active.row_ids[:index.active.size][index.active.live[:index.active.size]]]))


def _check_topk(pair, jq, tq, top_k=5, estimator="plain", teeth=True):
    atol = (1e-5 if estimator == "plain" else 1e-4) * pair.scale(jq)
    want = pair.j.query_sketch(jq, top_k=top_k, estimator=estimator)
    got = pair.t.query_sketch(tq, top_k=top_k, estimator=estimator)
    _assert_topk_agrees(got, want, pair.dense(jq, estimator), _live_ids(pair.j), atol,
                        teeth)
    return got


def _check_threshold(pair, jq, tq, radius, relative, estimator="plain"):
    atol = (1e-5 if estimator == "plain" else 1e-4) * pair.scale(jq)
    wr, wi = pair.j.query_threshold_sketch(jq, radius=radius, relative=relative,
                                           estimator=estimator)
    gr, gi = pair.t.query_threshold_sketch(tq, radius=radius, relative=relative,
                                           estimator=estimator)
    n = pair.j.next_row_id
    got, want = gr * n + gi, np.asarray(wr) * n + wi
    assert np.all(np.diff(got) > 0)  # (query, id) order, no repeats
    diff = np.setxor1d(got, want)
    if diff.size:
        dense = pair.dense(jq, estimator)
        r, c = diff // n, diff % n
        if relative:
            na = np.asarray(jq.norm_pp(P))
            nb = np.asarray(pair.corpus().norm_pp(P))
            thr = radius * (na[r] + nb[c])
        else:
            thr = radius
        assert np.all(np.abs(dense[r, c] - thr) <= atol)
    assert diff.size <= max(2, want.size // 50)
    return gr, gi


# ---------------------------------------------------------------- planner


def _plans(mod, reg, registry):
    p = mod.QueryPlanner()
    approx = mod.ApproxContract(rtol=1e-3, atol=1e-4)
    out = []
    cases = [
        dict(reduce="topk", estimator=registry.PLAIN, sharded=False),
        dict(reduce="threshold", estimator=registry.MARGIN_MLE, sharded=False),
        dict(reduce="topk", estimator=registry.PLAIN, sharded=True),
        dict(reduce="topk", estimator=registry.PLAIN, sharded=True, mesh_available=True),
        dict(reduce="topk", estimator=registry.MARGIN_MLE, sharded=True, mesh_available=True),
        dict(reduce="topk", estimator=registry.MARGIN_MLE, sharded=True, mesh_available=True,
             approx_ok=approx),
        dict(reduce="threshold", estimator=registry.MARGIN_MLE, sharded=True,
             mesh_available=True, approx_ok=approx),
        dict(reduce="threshold", estimator=registry.PLAIN, sharded=True, mesh_available=True,
             sealed_segments=0, deadline_ms=5.0, replica=2),
    ]
    for case in cases:
        plan = p.plan(**case)
        out.append(plan)
        p.observe(plan, plan.route, 3.0)
    # measured costs that flip plain top-k to dispatch, then a deadline flip
    for ms_stacked, ms_dispatch in ((9.0, 1.0), (9.0, 1.0), (9.0, 1.0)):
        p.observe(p.plan(reduce="topk", estimator=registry.PLAIN, sharded=True,
                         mesh_available=True), "stacked", ms_stacked)
        p.observe(p.plan(reduce="topk", estimator=registry.PLAIN, sharded=True,
                         mesh_available=True), "dispatch", ms_dispatch)
    out.append(p.plan(reduce="topk", estimator=registry.PLAIN, sharded=True,
                      mesh_available=True))
    out.append(p.plan(reduce="threshold", estimator=registry.PLAIN, sharded=True,
                      mesh_available=True, record=False))
    p.record_gate(("snap", 1), False, 0.5)
    return out, p.stats()


def _plan_fields(plan):
    approx = None if plan.approx is None else (plan.approx.rtol, plan.approx.atol)
    return (plan.reduce, plan.estimator, plan.route, plan.fallbacks, plan.chain,
            plan.expected_cost_ms, plan.reason, approx, plan.deadline_ms,
            plan.replica, plan.describe())


def test_planner_makes_the_same_plans_and_counts():
    jplans, jstats = _plans(jplanner, jreg, jreg)
    tplans, tstats = _plans(tplanner, treg, treg)
    assert [_plan_fields(p) for p in tplans] == [_plan_fields(p) for p in jplans]
    assert tstats == jstats
    assert tplans[-2].route == "dispatch"  # the cost flip happened


def test_planner_rejects_what_the_reference_rejects():
    for mod in (jplanner, tplanner):
        with pytest.raises(ValueError):
            mod.QueryPlanner().plan(reduce="full", estimator="plain", sharded=False)
        with pytest.raises(TypeError):
            mod.QueryPlanner().plan(reduce="topk", estimator="plain", sharded=False,
                                    approx_ok=0.1)
        with pytest.raises(ValueError):
            mod.QueryPlanner().plan(reduce="topk", estimator="plain", sharded=False,
                                    deadline_ms=-1.0)
        with pytest.raises(ValueError):
            mod.ApproxContract(rtol=float("nan"))


def test_route_capabilities_match_the_reference():
    for name in (treg.PLAIN, treg.MARGIN_MLE):
        tc, jc = treg.get(name).capabilities, jreg.get(name).capabilities
        assert (tc.stacked_topk, tc.stacked_threshold, tc.fused_bitwise_stable) == (
            jc.stacked_topk, jc.stacked_threshold, jc.fused_bitwise_stable)
    assert (treg.STACKED_PACKED, treg.STACKED_SKETCH) == (jreg.STACKED_PACKED,
                                                          jreg.STACKED_SKETCH)


# ------------------------------------------------------ index, shared sketches


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
@pytest.mark.parametrize("estimator", ["plain", "mle"])
def test_query_sketch_matches_the_reference(strategy, estimator):
    pair = Pair(strategy, capacity=32, seed=1)
    for n in (20, 30, 17):  # seals mid-batch twice; the active segment is ragged
        pair.ingest(n)
    jq, tq = pair.sketch(9)
    for top_k in (1, 5, 80):  # 80 > live rows: every rank, held to the teeth check
        _check_topk(pair, jq, tq, top_k=top_k, estimator=estimator, teeth=top_k == 80)


def test_query_through_the_interpreted_pallas_kernel():
    pair = Pair(capacity=24, seed=2, engine=jengine.EngineConfig(backend="interpret"))
    pair.ingest(50)
    jq, tq = pair.sketch(6)
    _check_topk(pair, jq, tq, top_k=7)


@pytest.mark.parametrize("relative,radius", [(False, 15.0), (True, 0.7)])
@pytest.mark.parametrize("estimator", ["plain", "mle"])
def test_threshold_matches_the_reference(relative, radius, estimator):
    pair = Pair(capacity=16, seed=3)
    pair.ingest(40)
    pair.j.delete(np.arange(3, 40, 5))
    pair.t.delete(np.arange(3, 40, 5))
    jq, tq = pair.sketch(8)
    gr, gi = _check_threshold(pair, jq, tq, radius, relative, estimator)
    assert gr.size > 0 and not np.isin(gi, np.arange(3, 40, 5)).any()


def test_deletes_tombstones_and_seal_boundaries_match():
    pair = Pair(capacity=16, seed=4)
    for n in (7, 13, 20, 1):
        pair.ingest(n)
    assert [s.n for s in pair.t.sealed] == [s.n for s in pair.j.sealed] == [16, 16]
    assert pair.t.active.size == pair.j.active.size == 9
    gone = np.array([0, 5, 16, 17, 40, 40, 999])  # a repeat and an unknown id
    assert pair.t.delete(gone) == pair.j.delete(gone) == 5
    assert pair.t.delete(gone) == pair.j.delete(gone) == 0
    for key in ("live", "rows", "sealed_segments", "active_fill", "next_row_id",
                "generation"):
        assert pair.t.stats()[key] == pair.j.stats()[key]
    assert set(pair.t.stats()) == set(pair.j.stats())
    jq, tq = pair.sketch(5)
    _, ids = _check_topk(pair, jq, tq, top_k=41)
    assert ids.shape == (5, 36) and not np.isin(ids, gone).any()  # 41 rows, 5 deleted


@pytest.mark.parametrize("background", [False, True])
def test_compaction_matches_the_reference_and_keeps_answers(background):
    pair = Pair(capacity=16, seed=5)
    pair.ingest(64)
    gone = np.arange(0, 64, 3)
    pair.j.delete(gone)
    pair.t.delete(gone)
    jq, tq = pair.sketch(6)
    before = pair.t.query_sketch(tq, top_k=8)
    before_thr = pair.t.query_threshold_sketch(tq, radius=0.2, relative=True)
    if background:
        handle = pair.t.compact_async(0.7)
        mid = pair.t.delete([1, 2])  # lands while the pass may be running
        assert handle.join(timeout=60) == 4 and handle.done
        pair.j.delete([1, 2])
        assert pair.j.compact_async(0.7).join(timeout=60) == 4
        assert mid == 2
    else:
        assert pair.t.compact(0.7) == pair.j.compact(0.7) == 4
    assert pair.t.n_live == pair.j.n_live
    if not background:
        # the port's mid-pass delete was replayed onto the replacements,
        # the reference's landed before its pass: compare layouts only here
        assert [s.n for s in pair.t.sealed] == [s.n for s in pair.j.sealed]
        for ts, js in zip(pair.t.sealed, pair.j.sealed):
            np.testing.assert_array_equal(ts.row_ids, js.row_ids)
            np.testing.assert_array_equal(ts.live, js.live)
    after = pair.t.query_sketch(tq, top_k=8)
    if not background:  # the same live rows: bit for bit
        assert torch.equal(after[0], before[0])
        np.testing.assert_array_equal(after[1], before[1])
        thr = pair.t.query_threshold_sketch(tq, radius=0.2, relative=True)
        for a, b in zip(thr, before_thr):
            np.testing.assert_array_equal(a, b)
    _check_topk(pair, jq, tq, top_k=8)
    assert pair.t.generation == pair.j.generation == 1


def test_live_sketch_matches_the_reference_bit_for_bit():
    pair = Pair(capacity=16, seed=6)
    pair.ingest(40)
    pair.j.delete([0, 17, 39])
    pair.t.delete([0, 17, 39])
    jl, tl = pair.j.live_sketch(), pair.t.live_sketch()
    np.testing.assert_array_equal(tl.U.numpy(), np.asarray(jl.U))
    np.testing.assert_array_equal(tl.moments.numpy(), np.asarray(jl.moments))


def test_empty_index_and_top_k_edges_match():
    pair = Pair(capacity=8, seed=7)
    jq, tq = pair.sketch(3)
    for jd, td in ((pair.j.query_sketch(jq, top_k=4), pair.t.query_sketch(tq, top_k=4)),):
        assert tuple(td[0].shape) == np.asarray(jd[0]).shape == (3, 0)
        assert td[1].shape == jd[1].shape == (3, 0)
    r, i = pair.t.query_threshold_sketch(tq, radius=1.0)
    assert r.size == i.size == 0
    ids = pair.ingest(1)
    _, got = pair.t.query_sketch(tq, top_k=5)
    assert got.shape == (3, 1) and (got == ids[0]).all()
    pair.t.delete(ids)
    assert pair.t.query_sketch(tq, top_k=5)[1].shape == (3, 0)
    for bad in (-1, 2.5, True):
        with pytest.raises(ValueError):
            pair.t.query_sketch(tq, top_k=bad)


# ------------------------------------------------------------ index, raw rows


def _carried_key(jcfg, tcfg, seed):
    key = jax.random.key(seed)
    mids = [0] if jcfg.strategy == "basic" else [1, 2, 3]
    bd = jcfg.block_d
    tiles = {(mid, b): np.asarray(jproj.projection_block(
        jax.random.fold_in(key, mid), b, bd, jcfg.k, jcfg.projection))
        for mid in mids for b in range(D // bd)}
    return convert.projection_key_from_tiles(tiles, tcfg.projection)


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
def test_raw_row_ingest_and_query_with_the_carried_key(strategy):
    jcfg, tcfg = _cfgs(strategy)
    rng = np.random.default_rng(8)
    X, Q = _rows(rng, 70), _rows(rng, 6)
    j = jindex.SketchIndex(jcfg, seed=8, engine=XLA,
                           index_cfg=jindex.IndexConfig(segment_capacity=32))
    t = tindex.SketchIndex(tcfg, key=_carried_key(jcfg, tcfg, 8), device="cpu",
                           index_cfg=tindex.IndexConfig(segment_capacity=32))
    np.testing.assert_array_equal(t.ingest(X), j.ingest(jnp.asarray(X)))
    jc = jsketch.sketch(jnp.asarray(X), j.key, jcfg)
    jq = jsketch.sketch(jnp.asarray(Q), j.key, jcfg)
    A, _, na = (np.asarray(v, np.float64) for v in jpw.pack_sketch(jq, jcfg))
    _, B, nb = (np.asarray(v, np.float64) for v in jpw.pack_sketch(jc, jcfg))
    atol = 1e-4 * float(na.max() + nb.max() + (np.abs(A) @ np.abs(B).T).max())
    for estimator in ("plain", "mle"):
        dense = np.asarray(jreg.get(estimator).pairwise(jq, jc, jcfg, clip=True))
        _assert_topk_agrees(t.query(Q, top_k=6, estimator=estimator),
                            j.query(jnp.asarray(Q), top_k=6, estimator=estimator),
                            dense, np.arange(70), atol)


def test_knn_service_matches_the_reference_service():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(9)
    X, Q = _rows(rng, 50), _rows(rng, 4)
    js = jserve.SketchKnnService(jcfg, seed=9, segment_capacity=16)
    ts = SketchKnnService(tcfg, seed=9, segment_capacity=16, device="cpu",
                          key=_carried_key(jcfg, tcfg, 9))
    with pytest.raises(RuntimeError, match="empty"):
        ts.query(Q)
    assert ts.corpus is None
    np.testing.assert_array_equal(ts.ingest(X), js.ingest(jnp.asarray(X)))
    assert ts.n_ingested == js.n_ingested == 50
    assert ts.delete([3, 4]) == js.delete([3, 4]) == 2
    assert ts.corpus.n == js.corpus.n == 48
    jc = jsketch.sketch(jnp.asarray(X), js.key, jcfg)
    jq = jsketch.sketch(jnp.asarray(Q), js.key, jcfg)
    A, _, na = (np.asarray(v, np.float64) for v in jpw.pack_sketch(jq, jcfg))
    _, B, nb = (np.asarray(v, np.float64) for v in jpw.pack_sketch(jc, jcfg))
    atol = 1e-4 * float(na.max() + nb.max() + (np.abs(A) @ np.abs(B).T).max())
    live = np.setdiff1d(np.arange(50), [3, 4])
    for mle in (False, True):
        spec = jreg.get(jreg.MARGIN_MLE if mle else jreg.PLAIN)
        dense = np.asarray(spec.pairwise(jq, jc, jcfg, clip=True))
        _assert_topk_agrees(ts.query(Q, top_k=5, mle=mle),
                            js.query(jnp.asarray(Q), top_k=5, mle=mle), dense, live, atol)


# ------------------------------------------------------------- MicroBatcher


def _batcher_index():
    tcfg = _cfgs()[1]
    t = tindex.SketchIndex(tcfg, seed=10, device="cpu",
                           index_cfg=tindex.IndexConfig(segment_capacity=32))
    t.ingest(_rows(np.random.default_rng(10), 60))
    return t


def _assert_direct_answer(t, q, answer, top_k):
    """A caller's slice of a batch against a direct query of its rows: the
    CPU's plain sketch blocks its product by the row count, so the query
    sketches differ by float32 rounding, and values agree to the raw-row
    tolerance, 1e-4 of the largest na + nb + sum_K |A||B|; ids agree where
    the rank is apart from its neighbours by more than that."""
    v, ids = answer
    dv, di = t.query(q, top_k=top_k)
    A, _, na = tpw.pack_sketch(tsketch.sketch(torch.from_numpy(q), t.key, t.cfg), t.cfg)
    _, B, nb = tpw.pack_sketch(t.live_sketch(), t.cfg)
    atol = 1e-4 * float(na.max() + nb.max() + (A.abs() @ B.abs().T).max())
    torch.testing.assert_close(v, dv, rtol=0, atol=atol)
    apart = (dv[:, 1:] - dv[:, :-1]).abs() > atol
    iso = torch.ones_like(dv, dtype=torch.bool)
    iso[:, 1:] &= apart
    iso[:, :-1] &= apart
    np.testing.assert_array_equal(ids[iso.numpy()], di[iso.numpy()])


def test_micro_batcher_coalesces_concurrent_callers():
    t = _batcher_index()
    Q = _rows(np.random.default_rng(11), 24)
    mb = tindex.MicroBatcher(t, max_batch=24, max_wait_ms=30_000.0)
    out, errors = [None] * 6, []

    def call(i):
        try:
            out[i] = mb.query(Q[4 * i:4 * i + 4], top_k=5)
        except BaseException as e:  # surfaced in the main thread
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errors
    assert mb.batches_run == 1 and mb.rows_served == 24
    assert mb.stats()["queue_depth"] == 0
    for i, answer in enumerate(out):
        _assert_direct_answer(t, Q[4 * i:4 * i + 4], answer, 5)


def test_micro_batcher_flushes_on_timeout_and_on_deadline():
    t = _batcher_index()
    Q = _rows(np.random.default_rng(12), 3)
    mb = tindex.MicroBatcher(t, max_batch=64, max_wait_ms=5.0)
    v, ids = mb.query(Q, top_k=4)
    dv, di = t.query(Q, top_k=4)
    assert torch.equal(v, dv) and np.array_equal(ids, di)  # the same rows: bit for bit
    assert mb.batches_run == 1 and mb.deadline_flushes == 0
    v1, _ = mb.query(Q[0], top_k=4, deadline_ms=0.5)  # a 1-D row, budget at risk
    assert v1.shape == (1, 4) and mb.deadline_flushes == 1
    v0, i0 = mb.query(np.zeros((0, D), np.float32), top_k=4)
    assert tuple(v0.shape) == i0.shape == (0, 4)
    with pytest.raises(ValueError):
        mb.query(Q, top_k=-1)
    assert mb._wait_budget(None) == mb.max_wait
    assert mb._wait_budget(10.0, now=9.0) == mb.max_wait
    assert mb._wait_budget(1.0005, now=1.0) < 0


# ------------------------------------------------------------- segments


def test_active_segment_writes_in_place_and_seals_a_view():
    pair = Pair(capacity=16, seed=13)
    seg = pair.t.active
    ptr = seg.U.data_ptr()
    pair.ingest(5)
    pair.ingest(6)
    assert seg.U.data_ptr() == ptr and seg.size == 11  # no reallocation per batch
    pair.ingest(5)  # fills it: sealed, a fresh active segment opens
    sealed = pair.t.sealed[0]
    assert sealed.sketch.U.data_ptr() == ptr and pair.t.active is not seg
    np.testing.assert_array_equal(sealed.sketch.U.numpy(), np.asarray(pair.j.sealed[0].sketch.U))


@pytest.mark.parametrize("batches", [(3, 4, 2), (9,), (2, 11, 1)])
def test_reservoir_ring_matches_the_reference(batches):
    jcfg, tcfg = _cfgs()
    jr = jindex.SketchReservoir(jcfg, 8)
    tr = tindex.SketchReservoir(tcfg, 8, device="cpu")
    key, rng = jax.random.key(14), np.random.default_rng(14)
    for b in batches:
        jsk = jsketch.sketch(jnp.asarray(_rows(rng, b)), key, jcfg)
        jr.admit(jsk)
        tr.admit(_to_port(jsk))
    (jv, jlive), (tv, tlive) = jr.view(), tr.view()
    assert tr.count == jr.count and tr.size == jr.size
    np.testing.assert_array_equal(tlive, jlive)
    np.testing.assert_array_equal(tv.U.numpy(), np.asarray(jv.U))
    np.testing.assert_array_equal(tv.moments.numpy(), np.asarray(jv.moments))


def test_micro_batcher_stress_loses_no_rows():
    """More callers than cores, two batch groups, a short switch interval:
    every caller gets its own rows' answer and the counters add up."""
    import os
    import sys

    t = _batcher_index()
    mb = tindex.MicroBatcher(t, max_batch=16, max_wait_ms=2.0)
    rng = np.random.default_rng(15)
    jobs = [(_rows(rng, int(rng.integers(1, 5))), int(rng.choice([3, 5])))
            for _ in range(3 * max(8, 2 * (os.cpu_count() or 1)))]
    out, errors = [None] * len(jobs), []

    def call(i):
        try:
            out[i] = mb.query(jobs[i][0], top_k=jobs[i][1])
        except BaseException as e:  # surfaced in the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(jobs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    assert mb.rows_served == sum(len(q) for q, _ in jobs)
    assert mb.stats()["queue_depth"] == 0 and mb.batches_run >= 2
    for (q, k), answer in zip(jobs, out):
        assert tuple(answer[0].shape) == answer[1].shape == (len(q), k)
        _assert_direct_answer(t, q, answer, k)
