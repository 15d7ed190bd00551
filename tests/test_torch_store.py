"""Index persistence across the two packages: an index saved by either
loads in the other, in the same on-disk format.

The indexes hold the same sketches (made by ``repro`` and carried across
with ``repro_torch.convert``), so a round trip must give back the same
bits: sketches, moments, tombstones and ids compare exactly.  Queries on a
loaded index are held to the reference's answers with the tolerances of
``tests/test_torch_index.py`` (plain values to 1e-5 of the largest
na + nb + sum_K |A||B|, ids equal where the rank is isolated), and within
the port a save/load or a compaction leaves answers equal bit for bit.
"""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as jindex
from repro.core import projections as jproj
from repro_torch import index as tindex
from repro_torch.core import projections as tproj

T = importlib.import_module("test_torch_index")
jsketch = importlib.import_module("repro.core.sketch")
tsketch = importlib.import_module("repro_torch.core.sketch")


def _pair(seed, capacity=16, rows=(20, 19)):
    pair = T.Pair(capacity=capacity, seed=seed)
    for n in rows:
        pair.ingest(n)
    pair.j.delete([1, 18, 30])
    pair.t.delete([1, 18, 30])
    return pair


def _saved_rows(index):
    """(U, moments, live, row_ids) per segment as a save writes them: the
    sealed segments, then the active one trimmed to its rows."""
    segs = [(s.sketch.U, s.sketch.moments, s.live, s.row_ids) for s in index.sealed]
    act = index.active
    if act.size:
        n = act.size
        segs.append((act.U[:n], act.moments[:n], act.live[:n], act.row_ids[:n]))
    return segs


def _assert_same_segments(loaded, saved):
    """A loaded index (either package) holds the saved one's rows, bit for
    bit, every segment sealed."""
    assert loaded.active.size == 0
    assert loaded.next_row_id == saved.next_row_id and loaded.n_live == saved.n_live
    got, want = _saved_rows(loaded), _saved_rows(saved)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_reference_saved_index_loads_in_the_port(tmp_path):
    pair = _pair(20)
    pair.j.save(str(tmp_path / "j"))
    loaded = tindex.load_index(str(tmp_path / "j"), device="cpu")
    assert loaded.cfg == pair.tcfg
    assert loaded.index_cfg == tindex.IndexConfig(segment_capacity=16)
    _assert_same_segments(loaded, pair.j)
    jq, tq = pair.sketch(5)
    pair.t = loaded
    T._check_topk(pair, jq, tq, top_k=6)
    T._check_threshold(pair, jq, tq, 0.7, True)
    # the restored index keeps serving: new rows get the next ids
    _, tsk = pair.sketch(3)
    np.testing.assert_array_equal(loaded.ingest_sketch(tsk), [39, 40, 41])


def test_port_saved_index_loads_in_the_reference(tmp_path):
    pair = _pair(21)
    pair.t.save(str(tmp_path / "t"))
    pair.j.save(str(tmp_path / "j"))
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    loaded = jindex.load_index(str(tmp_path / "t"), engine=T.XLA)
    _assert_same_segments(loaded, pair.t)
    jq, tq = pair.sketch(5)
    want = loaded.query_sketch(jq, top_k=6)
    got = pair.t.query_sketch(tq, top_k=6)
    T._assert_topk_agrees(got, want, pair.dense(jq), T._live_ids(loaded),
                          1e-5 * pair.scale(jq))


def test_cross_package_load_serves_raw_rows_with_the_carried_key(tmp_path):
    jcfg, tcfg = T._cfgs()
    rng = np.random.default_rng(22)
    X, Q = T._rows(rng, 40), T._rows(rng, 5)
    j = jindex.SketchIndex(jcfg, seed=22, engine=T.XLA,
                           index_cfg=jindex.IndexConfig(segment_capacity=16))
    j.ingest(jnp.asarray(X))
    j.save(str(tmp_path / "j"))
    loaded = tindex.SketchIndex.load(str(tmp_path / "j"), device="cpu",
                                     key=T._carried_key(jcfg, tcfg, 22))
    jc = jsketch.sketch(jnp.asarray(X), j.key, jcfg)
    jq = jsketch.sketch(jnp.asarray(Q), j.key, jcfg)
    pair = T.Pair(seed=22)
    pair.all_j = [jc]
    # raw-row query sketches differ by float32 rounding: 1e-4 of the scale
    T._assert_topk_agrees(loaded.query(Q, top_k=5), j.query(jnp.asarray(Q), top_k=5),
                          pair.dense(jq), np.arange(40), 1e-4 * pair.scale(jq))


def test_bfloat16_round_trip_in_the_port(tmp_path):
    spec = tproj.ProjectionSpec(dtype=torch.bfloat16)
    cfg = tsketch.SketchConfig(p=4, k=32, block_d=128, projection=spec)
    idx = tindex.SketchIndex(cfg, seed=23, device="cpu",
                             index_cfg=tindex.IndexConfig(segment_capacity=16))
    rng = np.random.default_rng(23)
    idx.ingest(T._rows(rng, 37))
    idx.delete([2, 33])
    Q = T._rows(rng, 4)
    before = idx.query(Q, top_k=5)
    idx.save(str(tmp_path / "bf16"))
    assert _manifest(tmp_path / "bf16")["sketch_config"]["projection"]["dtype"] == "bfloat16"
    raw = np.load(tmp_path / "bf16" / "seg_00000.U.npy")
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    loaded = tindex.load_index(str(tmp_path / "bf16"), device="cpu")
    assert loaded.sealed[0].sketch.U.dtype == torch.bfloat16
    saved = [s.sketch.U for s in idx.sealed] + [idx.active.U[:idx.active.size]]
    assert [s.n for s in loaded.sealed] == [16, 16, 5]
    for seg, U in zip(loaded.sealed, saved):
        assert torch.equal(seg.sketch.U, U)
    after = loaded.query(Q, top_k=5)
    assert torch.equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])


def test_reference_bfloat16_save_loads_in_the_port(tmp_path):
    jcfg = jsketch.SketchConfig(p=4, k=32, block_d=128,
                                projection=jproj.ProjectionSpec(dtype=jnp.bfloat16))
    j = jindex.SketchIndex(jcfg, seed=24, index_cfg=jindex.IndexConfig(segment_capacity=16))
    j.ingest(jnp.asarray(T._rows(np.random.default_rng(24), 20)))
    j.save(str(tmp_path / "jbf16"))
    loaded = tindex.load_index(str(tmp_path / "jbf16"), device="cpu")
    assert loaded.cfg.projection.dtype == torch.bfloat16
    for a, b in zip(loaded.sealed, j.sealed):
        np.testing.assert_array_equal(a.sketch.U.float().numpy(),
                                      np.asarray(b.sketch.U.astype(jnp.float32)))


def test_one_row_index_round_trips_bit_for_bit(tmp_path):
    """A one-row save reloads onto a padded (two-row) segment in both
    packages, and answers as before."""
    pair = T.Pair(capacity=10, seed=25)
    pair.ingest(1)
    jq, tq = pair.sketch(3)
    before = pair.t.query_sketch(tq, top_k=1)
    pair.t.save(str(tmp_path / "one"))
    for loaded in (tindex.SketchIndex.load(str(tmp_path / "one"), device="cpu"),):
        assert loaded.sealed[0].n == 2 and loaded.n_live == 1
        after = loaded.query_sketch(tq, top_k=1)
        assert torch.equal(after[0], before[0])
        np.testing.assert_array_equal(after[1], before[1])
    jl = jindex.SketchIndex.load(str(tmp_path / "one"))
    assert jl.sealed[0].n == 2 and jl.n_live == 1
    np.testing.assert_array_equal(jl.query_sketch(jq, top_k=1)[1], before[1])


@pytest.mark.parametrize("drained", [False, True])
def test_empty_index_round_trips(tmp_path, drained):
    """Nothing written, or everything deleted: save, load and query give
    empty answers, and the restored index keeps ingesting."""
    pair = T.Pair(capacity=10, seed=26)
    if drained:
        pair.t.delete(pair.ingest(3))
    pair.t.save(str(tmp_path / "e"))
    loaded = tindex.load_index(str(tmp_path / "e"), device="cpu")
    jl = jindex.load_index(str(tmp_path / "e"))
    _, tq = pair.sketch(3)
    d, ids = loaded.query_sketch(tq, top_k=5)
    assert tuple(d.shape) == ids.shape == (3, 0)
    r, i = loaded.query_threshold_sketch(tq, radius=0.5)
    assert r.size == i.size == 0
    assert jl.n_live == loaded.n_live == 0 and jl.next_row_id == loaded.next_row_id
    _, more = pair.sketch(2)
    rid = loaded.ingest_sketch(more)
    assert set(loaded.query_sketch(tq, top_k=5)[1].ravel()) == set(rid)


def test_compaction_and_save_load_leave_answers_bit_equal(tmp_path):
    pair = _pair(27, capacity=16, rows=(40, 9))
    _, tq = pair.sketch(6)
    idx = pair.t
    want = idx.query_sketch(tq, top_k=7)
    want_mle = idx.query_sketch(tq, top_k=7, estimator="mle")
    want_thr = idx.query_threshold_sketch(tq, radius=0.7, relative=True)
    assert idx.compact(1.0) == 3
    idx.save(str(tmp_path / "c"))
    loaded = tindex.load_index(str(tmp_path / "c"), device="cpu")
    for index in (idx, loaded):
        got = index.query_sketch(tq, top_k=7)
        assert torch.equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        got = index.query_sketch(tq, top_k=7, estimator="mle")
        assert torch.equal(got[0], want_mle[0])
        np.testing.assert_array_equal(got[1], want_mle[1])
        for a, b in zip(index.query_threshold_sketch(tq, radius=0.7, relative=True), want_thr):
            np.testing.assert_array_equal(a, b)


def test_save_replaces_an_earlier_save_atomically(tmp_path):
    pair = _pair(28)
    path = str(tmp_path / "s")
    pair.t.save(path)
    first = _manifest(path)["next_row_id"]
    _, tsk = pair.sketch(4)
    pair.t.ingest_sketch(tsk)
    pair.t.save(path)
    assert _manifest(path)["next_row_id"] == first + 4
    assert sorted(os.listdir(tmp_path)) == ["s"]  # no temp or backup dirs left
    with open(os.path.join(path, "manifest.json")) as f:
        bad = json.load(f)
    bad["format_version"] = 2
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="format"):
        tindex.load_index(path, device="cpu")
