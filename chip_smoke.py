#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) through its main paths on one
CUDA card and checks it: the engine path (phase 4) and the index and its
service (phase 6).

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

  1. build: both CUDA kernels (``src/repro_torch/csrc/*.cu``) are compiled
     with nvcc for sm_90a, in parallel; ``cuobjdump -sass`` of each library
     must show tensor-core instructions (HMMA on TF32, or HGMMA).
  2. kernel against plain version: each kernel is held against its plain
     PyTorch version on the same inputs, at the shapes phases 4 and 6 give
     it (the engine's 2,048-row strips, the index fan's 4,096-, 128-, 64-
     and 16-row strips, the index's query batches) and at ragged ones
     (rows not 16-byte aligned, one past a tile, depth below one MMA
     step), with float32 and bfloat16 inputs; a second launch on
     the same inputs must repeat the first bit for bit.
  3. example gate: examples/knn_search.py's data and sizes (N=2048,
     D=16384, Q=16, p=4, k=256, block_d=4096) through the port; the
     margin-MLE cluster recall@1 must be >= 0.9, as the example asserts.
  4. main path: 1,048,576 rows x 16,384 of a clustered non-negative corpus,
     made on the card in batches of 4,096 from a seeded generator, are
     sketched (p=4, basic, normal R, k=256); then 4,096 plain top-10
     queries, 256 margin-MLE top-10 queries and one relative threshold
     query of 256 queries x 65,536 rows.  The kernels' launch counters are
     set to 0 just before and read just after; each must be above 0.
  5. kernel route against plain route on a 65,536-row slice of the corpus.
  6. index: phase 4's rows (same generator and key, batches of 4,096) are
     ingested through ``repro_torch.runtime.SketchKnnService`` into 256
     sealed segments of ``repro_torch.index``; the first and last batch's
     sketches must equal phase 4's bit for bit.  Then 4,096 plain top-10
     queries (ids equal to phase 4's engine answer away from near-ties),
     256 margin-MLE top-10 queries (cluster recall@1 >= 0.9), a relative
     threshold of 64 queries over the whole index (hits equal to the
     engine's, away from the radius), a delete of 4 of the 32 clusters (no
     deleted id surfaces), a compaction (plain top-10 equal bit for bit),
     a save and reload under build/ (equal bit for bit), and 8 threads x 16
     rows through the ``MicroBatcher`` (one batch, each answer equal to a
     direct query).  Both launch counters are set to 0 at the phase's
     start; each must be above 0 at its end.
  7. timings of each kernel, its plain version and the nearest PyTorch
     library call at the main path's shapes, beside the least time the card
     could take for the kernel's route (bound: three TF32 tensor-core
     products per product, or the bytes) and the fp32 CUDA-core bound, and
     a profile of the ingest and query windows.

The line before the last is the card's name and power limit from
nvidia-smi; the last line is the JSON result.  Needs one CUDA card; exits
non-zero at once without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12  # CUDA cores
PEAK_TF32_FLOPS = 495e12  # tensor cores
PEAK_BYTES = 3.35e12
# both kernels take each float32 product as three TF32 products
# (src/repro_torch/csrc/tf32x3.cuh)
SCHEME = "tf32x3_mma_sync"
TF32_PRODUCTS = 3

SEED = 0
D = 16_384
K = 256
P = 4
BLOCK_D = 4096
CORPUS_ROWS = 1_048_576
BATCH = 4096
CLUSTERS = 32
NOISE = 0.02
PLAIN_QUERIES = 4096
MLE_QUERIES = 256
THRESHOLD_ROWS = 65_536
TOP_K = 10
RELATIVE_RADIUS = 0.1
INDEX_THRESHOLD_QUERIES = 64
DELETED_CLUSTERS = 4
BATCHER_THREADS = 8
BATCHER_ROWS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_TF32_FLOPS,
             products: int = TF32_PRODUCTS):
    """(ms, "operations" | "bytes"): the least time for ``flops`` of float32
    work done as ``products`` products each at ``peak_flops``, or for
    ``nbytes`` at the memory rate, whichever is larger."""
    ops = products * flops / peak_flops * 1e3
    mem = nbytes / PEAK_BYTES * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def fp32_bound_ms(flops: float, nbytes: float) -> float:
    """The same bound for IEEE fp32 on the CUDA cores."""
    return bound_ms(flops, nbytes, PEAK_FP32_FLOPS, 1)[0]


# the main path's kernel shapes, as timed here and by tools/torch_kernel_ab.py
STRIP = 2048  # rows of queries and of corpus in one pairwise_lp strip
POWER_PROJECT_ITERS = 20
PAIRWISE_LP_ITERS = 100


def power_project_inputs(torch, dev, gen):
    """X (BATCH, D) in [0, 1), R (D, K) normal and the powers 1..P-1: one
    sketch call of the main path."""
    X = torch.rand((BATCH, D), generator=gen, device=dev)
    R = torch.randn((D, K), generator=gen, device=dev)
    return X, R, tuple(range(1, P))


def pairwise_lp_inputs(torch, dev, gen):
    """A, B (STRIP, (P-1) K) normal and margins na, nb in [0, (P-1) K): one
    query strip of the main path."""
    depth = (P - 1) * K
    A = torch.randn((STRIP, depth), generator=gen, device=dev)
    B = torch.randn((STRIP, depth), generator=gen, device=dev)
    na = torch.rand(STRIP, generator=gen, device=dev) * depth
    nb = torch.rand(STRIP, generator=gen, device=dev) * depth
    return A, B, na, nb


class Smoke:
    def __init__(self):
        import torch

        from repro_torch.kernels.pairwise_lp import pairwise_lp
        from repro_torch.kernels.power_project import power_project

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.card = card_line()
        self.err = {"power_project": 0.0, "pairwise_lp": 0.0}
        self.launches = {}
        self.kernels = {"power_project": power_project, "pairwise_lp": pairwise_lp}

    def tag(self) -> str:
        return f"[{self.card}]"

    # 1 ------------------------------------------------------------------
    def build(self):
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        seconds = build.build()
        log(f"build: {', '.join(f'{n} {s:.1f} s' for n, s in seconds.items())} "
            f"(in parallel, {time.perf_counter() - t0:.1f} s wall) {self.tag()}")
        for name in build.KERNELS:
            for line in build.ptxas_report(name).splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log(f"  ptxas {name}: {line.strip()}")
            build.load(name)
            sass = build.sass(name)
            if sass is None:
                log(f"sass {name}: the toolkit has no cuobjdump; tensor-core "
                    f"instructions not checked")
                continue
            ops = re.findall(r"\bHG?MMA\.[A-Za-z0-9.]+", sass)
            ops = [op for op in ops if op.startswith("HGMMA") or "TF32" in op]
            log(f"sass {name}: {len(ops)} tensor-core instructions "
                f"({', '.join(sorted(set(ops)))})")
            if not ops:
                raise AssertionError(f"{name}: cuobjdump -sass shows no HMMA.TF32 "
                                     f"or HGMMA instruction")

    # 2 ------------------------------------------------------------------
    def _record(self, name: str, what: str, got, again, want, scale: float,
                tol_rel: float):
        torch = self.torch
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)} or non-finite output")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {what}: a second launch on the same inputs "
                                 f"differs from the first")
        err = float((got - want).abs().max())
        tol = tol_rel * scale
        self.err[name] = max(self.err[name], err)
        log(f"compare {name} {what}: max|kernel - plain| = {err:.6g} "
            f"(tol {tol:.6g} = {tol_rel:g} x max sum|terms| {scale:.6g})")
        if not err <= tol:
            raise AssertionError(f"{name} {what} disagrees with its plain version")

    def compare_power_project(self):
        torch = self.torch
        from repro_torch.kernels.power_project import power_project, power_project_ref

        gen = torch.Generator(device=self.dev).manual_seed(SEED + 1)
        cases = [
            (BATCH, D, K, (1, 2, 3), torch.float32),   # the main path (basic, p=4)
            (BATCH, D, K, (1, 2, 3), torch.bfloat16),
            (BATCH, D, K, (3, 1), torch.float32),      # alternative strategy pairs
            (BATCH, D, K, (2, 2), torch.float32),
            (1000, 5000, 200, (1, 2, 3), torch.float32),  # ragged n, D, k
            (1000, 5000, 200, (1, 2, 3), torch.bfloat16),
            (37, 129, 17, (1, 2, 3, 4, 5, 6, 7), torch.float32),  # p = 8
            # rows of X not 16-byte aligned (D % 4, D % 8), n and k one past a
            # tile (64 x 128), depth below one MMA step (8)
            (65, 5001, 129, (1, 2, 3), torch.float32),
            (65, 5001, 129, (1, 2, 3), torch.bfloat16),
            (65, 5004, 132, (3, 1), torch.bfloat16),
            (1, 3, 5, (1, 2, 3), torch.float32),
            (1, 3, 5, (1, 2, 3), torch.bfloat16),
            # the index phase's query batches: MLE, micro-batch, threshold,
            # one micro-batch caller
            (MLE_QUERIES, D, K, (1, 2, 3), torch.float32),
            (BATCHER_THREADS * BATCHER_ROWS, D, K, (1, 2, 3), torch.float32),
            (INDEX_THRESHOLD_QUERIES, D, K, (1, 2, 3), torch.float32),
            (BATCHER_ROWS, D, K, (1, 2, 3), torch.float32),
        ]
        for n, d, k, powers, dtype in cases:
            X = torch.rand((n, d), generator=gen, device=self.dev).to(dtype)
            R = torch.randn((d, k), generator=gen, device=self.dev)
            got = power_project(X, R, powers)
            again = power_project(X, R, powers)
            want = power_project_ref(X, R, powers)
            # float32 rounding and the kernel's three TF32 products per
            # product are far below 1e-5 of the sum of |terms| of a length-d
            # sum; one TF32 product, or a dropped or doubled D-step, is not
            scale = float(power_project_ref(X.float().abs(), R.abs(), powers).max())
            self._record("power_project", f"X ({n}, {d}) {str(dtype)[6:]}, k={k}, "
                         f"powers {powers}", got, again, want, scale, 1e-5)

    def compare_pairwise_lp(self):
        torch = self.torch
        from repro_torch.kernels.pairwise_lp import pairwise_lp, pairwise_lp_ref

        gen = torch.Generator(device=self.dev).manual_seed(SEED + 2)
        cases = [
            (2048, 2048, 768, True, torch.float32),   # a main-path strip
            (2048, 2048, 768, False, torch.float32),
            (2048, 2048, 768, True, torch.bfloat16),
            (1000, 1537, 700, True, torch.float32),   # ragged n, m, K
            (1000, 1537, 700, False, torch.bfloat16),
            (1, 3, 5, True, torch.float32),
            # rows not 16-byte aligned (K % 4, K % 8), n and m one past a
            # tile (128), depth below one MMA step (8)
            (129, 129, 701, True, torch.float32),
            (129, 129, 701, False, torch.bfloat16),
            (2049, 2049, 768, True, torch.float32),
            (2049, 129, 772, False, torch.bfloat16),
            (1, 3, 5, False, torch.bfloat16),
            # the index fan's strips: every query of a call against one
            # segment's 2,048 columns, the tails of compacted segments, the
            # threshold's, the micro-batch's and one caller's queries
            (PLAIN_QUERIES, 2048, 768, True, torch.float32),
            (PLAIN_QUERIES, 2048, 768, False, torch.float32),
            (PLAIN_QUERIES, 1536, 768, True, torch.float32),
            (PLAIN_QUERIES, 1531, 768, True, torch.float32),
            (INDEX_THRESHOLD_QUERIES, 2048, 768, True, torch.float32),
            (BATCHER_THREADS * BATCHER_ROWS, 2048, 768, True, torch.float32),
            (BATCHER_ROWS, 2048, 768, True, torch.float32),
        ]
        for n, m, k, clip, dtype in cases:
            A = torch.randn((n, k), generator=gen, device=self.dev).to(dtype)
            B = torch.randn((m, k), generator=gen, device=self.dev).to(dtype)
            na = torch.rand(n, generator=gen, device=self.dev) * k
            nb = torch.rand(m, generator=gen, device=self.dev) * k
            got = pairwise_lp(A, B, na, nb, clip=clip)
            again = pairwise_lp(A, B, na, nb, clip=clip)
            want = pairwise_lp_ref(A, B, na, nb, clip=clip)
            scale = float(pairwise_lp_ref(A.float().abs(), B.float().abs(), na, nb).max())
            self._record("pairwise_lp", f"({n}, {m}, K={k}) {str(dtype)[6:]}, clip={clip}",
                         got, again, want, scale, 1e-5)

    # 3 ------------------------------------------------------------------
    def example_gate(self):
        """examples/knn_search.py's data and check, through the port."""
        torch = self.torch
        from repro_torch import engine
        from repro_torch.core import (ProjectionKey, SketchConfig, exact_pairwise_lp,
                                      knn, sketch)

        rng = np.random.default_rng(0)
        N, Q = 2048, 16
        centers = rng.uniform(0, 1, (32, D)).astype(np.float32)
        corpus = (np.repeat(centers, N // 32, axis=0)
                  + 0.02 * rng.standard_normal((N, D)).astype(np.float32))
        queries = (corpus[::N // Q]
                   + 0.01 * rng.standard_normal((Q, D)).astype(np.float32))
        cfg = SketchConfig(p=4, k=256, block_d=4096)
        key = ProjectionKey(SEED)
        Xc = torch.from_numpy(corpus).to(self.dev)
        Xq = torch.from_numpy(queries).to(self.dev)
        csk, qsk = sketch(Xc, key, cfg), sketch(Xq, key, cfg)
        dists, idx = knn(qsk, csk, cfg, top_k=5, mle=True)
        d2, i2 = engine.pairwise(qsk, csk, cfg, reduce="topk", top_k=5, estimator="mle",
                                 engine=engine.EngineConfig(row_block=4, col_block=256))
        overlap = np.mean([len(set(i2[q].tolist()) & set(idx[q].tolist())) / 5
                           for q in range(Q)])
        torch.testing.assert_close(d2, dists, rtol=1e-3, atol=1e-4)
        if overlap < 0.9:
            raise AssertionError(f"engine strips (4, 256) top-k overlap {overlap}")
        true_nn = exact_pairwise_lp(Xq, Xc, 4).argmin(dim=1).cpu().numpy()
        cluster = lambda j: j // (N // 32)  # noqa: E731
        recall = {}
        for name, ids in (("mle", idx), ("plain", knn(qsk, csk, cfg, top_k=5)[1])):
            ids = ids.cpu().numpy()
            recall[name] = float(np.mean([cluster(ids[i][0]) == cluster(true_nn[i])
                                          for i in range(Q)]))
        log(f"example gate ({N} x {D}, Q={Q}, p=4, k=256): MLE cluster recall@1 "
            f"{recall['mle']:.4f} (gate >= 0.9), plain {recall['plain']:.4f} (printed); "
            f"engine strips (4, 256) top-5 overlap {overlap:.4f}")
        if recall["mle"] < 0.9:
            raise AssertionError(f"MLE cluster recall@1 {recall['mle']} < 0.9")

    # 4 ------------------------------------------------------------------
    def _rows(self, gen, centres, labels):
        torch = self.torch
        X = torch.randn((labels.numel(), D), generator=gen, device=self.dev)
        return X.mul_(NOISE).add_(centres[labels])

    def _corpus_source(self):
        """The seeded corpus of phase 4: (generator, centres, labels); the
        first 8 rows drawn from the generator are the R-draw call's."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        centres = torch.rand((CLUSTERS, D), generator=gen, device=self.dev)
        labels = torch.arange(CORPUS_ROWS, device=self.dev) % CLUSTERS
        return gen, centres, labels

    def _query_source(self):
        """The seeded queries of phase 4: (generator, labels); the rows are
        drawn next from the generator."""
        torch = self.torch
        qgen = torch.Generator(device=self.dev).manual_seed(SEED + 3)
        qlabels = torch.randint(0, CLUSTERS, (PLAIN_QUERIES,), generator=qgen,
                                device=self.dev)
        return qgen, qlabels

    def main_path(self):
        torch = self.torch
        from repro_torch import engine
        from repro_torch.core import LpSketch, ProjectionKey, SketchConfig, knn, sketch

        cfg = SketchConfig(p=P, k=K, block_d=BLOCK_D)
        key = ProjectionKey(SEED)
        gen, centres, labels = self._corpus_source()
        U = torch.empty((CORPUS_ROWS, P - 1, K), device=self.dev)
        M = torch.empty((CORPUS_ROWS, P - 1), device=self.dev)
        qgen, qlabels = self._query_source()
        # first use draws the R tiles (copied to the card, then cached)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key_r = sketch(self._rows(gen, centres, labels[:8]), key, cfg)
        torch.cuda.synchronize()
        log(f"R draw and first sketch call: {(time.perf_counter() - t0) * 1e3:.3f} ms "
            f"{self.tag()}")
        del key_r

        for kern in self.kernels.values():
            kern.launches = 0
        sketch_ms = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r0 in range(0, CORPUS_ROWS, BATCH):
            X = self._rows(gen, centres, labels[r0:r0 + BATCH])
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            sk = sketch(X, key, cfg)
            e1.record()
            U[r0:r0 + BATCH] = sk.U
            M[r0:r0 + BATCH] = sk.moments
            e1.synchronize()
            sketch_ms += e0.elapsed_time(e1)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        corpus = LpSketch(U=U, moments=M)
        log(f"time ingest: {CORPUS_ROWS} rows x {D} in {ingest_s:.3f} s wall with the "
            f"corpus made on the card = {CORPUS_ROWS / ingest_s:.1f} rows/s; sketch calls "
            f"alone {sketch_ms:.1f} ms device = {CORPUS_ROWS / sketch_ms * 1e3:.1f} rows/s "
            f"({CORPUS_ROWS // BATCH} calls of {BATCH} rows) {self.tag()}")
        log(f"corpus on the card: sketch {(U.numel() + M.numel()) * 4 / 1e9:.2f} GB")

        t0 = time.perf_counter()
        Xq = self._rows(qgen, centres, qlabels)
        qsk = sketch(Xq, key, cfg)
        torch.cuda.synchronize()
        log(f"time query sketch: {PLAIN_QUERIES} rows in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms (rows made on the card) {self.tag()}")
        del Xq

        t0 = time.perf_counter()
        pv, pi = knn(qsk, corpus, cfg, top_k=TOP_K)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        mq = LpSketch(U=qsk.U[:MLE_QUERIES], moments=qsk.moments[:MLE_QUERIES])
        t0 = time.perf_counter()
        mv, mi = knn(mq, corpus, cfg, top_k=TOP_K, mle=True)
        torch.cuda.synchronize()
        mle_s = time.perf_counter() - t0
        sl = LpSketch(U=U[:THRESHOLD_ROWS], moments=M[:THRESHOLD_ROWS])
        t0 = time.perf_counter()
        hr, hc = engine.pairwise(mq, sl, cfg, reduce="threshold", radius=RELATIVE_RADIUS,
                                 relative=True)
        torch.cuda.synchronize()
        thr_s = time.perf_counter() - t0
        self.launches = {name: kern.launches for name, kern in self.kernels.items()}
        log(f"main path launches: {self.launches}")
        for name, n in self.launches.items():
            if n <= 0:
                raise AssertionError(f"{name} was never launched on the main path")

        log(f"time knn plain top-{TOP_K}: {PLAIN_QUERIES} queries x {CORPUS_ROWS} rows in "
            f"{plain_s * 1e3:.1f} ms = {plain_s * 1e3 / PLAIN_QUERIES:.4f} ms/query "
            f"{self.tag()}")
        log(f"time knn mle top-{TOP_K}: {MLE_QUERIES} queries x {CORPUS_ROWS} rows in "
            f"{mle_s * 1e3:.1f} ms = {mle_s * 1e3 / MLE_QUERIES:.4f} ms/query {self.tag()}")
        log(f"time threshold (relative {RELATIVE_RADIUS}): {MLE_QUERIES} x {THRESHOLD_ROWS} "
            f"in {thr_s * 1e3:.1f} ms, {hr.numel()} pairs {self.tag()}")

        for name, v, i in (("plain", pv, pi), ("mle", mv, mi)):
            if tuple(v.shape) != (i.shape[0], TOP_K) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{name} top-k: shape {tuple(v.shape)} or non-finite")
            if not bool((v[:, 1:] >= v[:, :-1]).all()) or int(i.min()) < 0 or \
                    int(i.max()) >= CORPUS_ROWS:
                raise AssertionError(f"{name} top-k is unsorted or out of range")
        lab = labels.cpu().numpy()
        ql = qlabels.cpu().numpy()
        pr = float(np.mean(lab[pi[:, 0].cpu().numpy()] == ql))
        mr = float(np.mean(lab[mi[:, 0].cpu().numpy()] == ql[:MLE_QUERIES]))
        clipped = float((pv == 0).float().mean())
        same = float(np.mean(lab[hc.cpu().numpy()] == ql[hr.cpu().numpy()])) if hr.numel() else 0.0
        log(f"cluster recall@1 (printed, not gated): plain {pr:.4f} over {PLAIN_QUERIES} "
            f"queries, mle {mr:.4f} over {MLE_QUERIES}; share of plain top-{TOP_K} values "
            f"clipped to 0: {clipped:.4f}; threshold hits inside the query's cluster: "
            f"{same:.4f}")
        self.corpus, self.qsk, self.mq, self.cfg, self.key = corpus, qsk, mq, cfg, key
        self.engine_answers = {"plain": (pv, pi), "mle": (mv, mi)}
        self.engine_s = {"plain": plain_s, "mle": mle_s}
        self.ingest_rows_s = CORPUS_ROWS / ingest_s

    # 5 ------------------------------------------------------------------
    def agreement(self):
        torch = self.torch
        from repro_torch import engine
        from repro_torch.core import LpSketch, pack_sketch

        cfg = self.cfg
        sl = LpSketch(U=self.corpus.U[:THRESHOLD_ROWS],
                      moments=self.corpus.moments[:THRESHOLD_ROWS])
        plain = engine.EngineConfig(backend="plain")
        A, _, na = pack_sketch(self.qsk, cfg)
        _, B, nb = pack_sketch(sl, cfg)
        # 1e-5 of the largest sum of |terms| bounds float32 rounding
        scale = float((A.abs() @ B.abs().T).max() + na.max() + nb.max())
        tol = 1e-5 * scale
        self.agree_tol = tol
        # one candidate more than is compared, so the last rank's gap is known
        kv, ki = engine.pairwise(self.qsk, sl, cfg, reduce="topk", top_k=TOP_K + 1,
                                 clip=False)
        wv, wi = engine.pairwise(self.qsk, sl, cfg, reduce="topk", top_k=TOP_K + 1,
                                 clip=False, engine=plain)
        dv = float((kv - wv).abs().max())
        # indices must match wherever the plain value is isolated by > tol
        gaps = torch.diff(wv, dim=1)
        isolated = torch.ones_like(wv, dtype=torch.bool)
        isolated[:, 1:] &= gaps > tol
        isolated[:, :-1] &= gaps > tol
        kv, ki, wv, wi, isolated = (t[:, :TOP_K] for t in (kv, ki, wv, wi, isolated))
        mism = int(((ki != wi) & isolated).sum())
        log(f"agree top-{TOP_K} (unclipped) on {self.qsk.n} queries x {THRESHOLD_ROWS} "
            f"rows, kernel vs plain route: max|dv| {dv:.6g} (tol {tol:.6g}), indices "
            f"equal {float((ki == wi).float().mean()):.4f}, isolated-rank mismatches {mism}")
        if dv > tol or mism:
            raise AssertionError("kernel and plain routes disagree on top-k")
        kr, kc = engine.pairwise(self.mq, sl, cfg, reduce="threshold",
                                 radius=RELATIVE_RADIUS, relative=True)
        wr, wc = engine.pairwise(self.mq, sl, cfg, reduce="threshold",
                                 radius=RELATIVE_RADIUS, relative=True, engine=plain)
        key_k, key_w = kr * THRESHOLD_ROWS + kc, wr * THRESHOLD_ROWS + wc
        diff = torch.cat([key_k[~torch.isin(key_k, key_w)], key_w[~torch.isin(key_w, key_k)]])
        worst = 0.0
        if diff.numel():
            r, c = diff // THRESHOLD_ROWS, diff % THRESHOLD_ROWS
            Ad, _, nad = pack_sketch(LpSketch(self.mq.U[r], self.mq.moments[r]), cfg)
            _, Bd, nbd = pack_sketch(LpSketch(sl.U[c], sl.moments[c]), cfg)
            d = nad + nbd + (Ad * Bd).sum(dim=1)
            worst = float((d - torch.tensor(RELATIVE_RADIUS, dtype=torch.float32,
                                            device=self.dev) * (nad + nbd)).abs().max())
        log(f"agree threshold: kernel {kr.numel()} pairs, plain {wr.numel()}, differing "
            f"{diff.numel()}, max |d - r*scale| over them {worst:.6g} (tol {tol:.6g})")
        if worst > tol:
            raise AssertionError("kernel and plain routes disagree on threshold hits")

    # 6 ------------------------------------------------------------------
    def index_phase(self):
        """The single-host index and its service at the main path's size:
        ingest, plain/MLE/threshold queries, delete, compact, save/load and
        the micro-batcher, each held against the engine path of phase 4."""
        torch = self.torch
        from repro_torch.core import LpSketch
        from repro_torch.index import MicroBatcher
        from repro_torch.runtime import SketchKnnService

        cfg, tag = self.cfg, self.tag()
        for kern in self.kernels.values():
            kern.launches = 0
        # the key of phase 4: one R, so its sketches and the index's must agree
        svc = SketchKnnService(cfg, seed=SEED, segment_capacity=BATCH, key=self.key)
        index = svc.index
        gen, centres, labels = self._corpus_source()
        self._rows(gen, centres, labels[:8])  # phase 4's R-draw rows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r0 in range(0, CORPUS_ROWS, BATCH):
            svc.ingest(self._rows(gen, centres, labels[r0:r0 + BATCH]))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        log(f"time index ingest: {CORPUS_ROWS} rows x {D} in {ingest_s:.3f} s wall with the "
            f"rows made on the card = {CORPUS_ROWS / ingest_s:.1f} rows/s (engine path, phase "
            f"4: {self.ingest_rows_s:.1f} rows/s); {len(index.sealed)} sealed segments {tag}")
        if len(index.sealed) != CORPUS_ROWS // BATCH or index.n_live != CORPUS_ROWS:
            raise AssertionError(f"index holds {len(index.sealed)} sealed segments and "
                                 f"{index.n_live} live rows")
        for seg, r0 in ((index.sealed[0], 0), (index.sealed[-1], CORPUS_ROWS - BATCH)):
            if not (torch.equal(seg.sketch.U, self.corpus.U[r0:r0 + BATCH])
                    and torch.equal(seg.sketch.moments, self.corpus.moments[r0:r0 + BATCH])):
                raise AssertionError(f"the index's sketch of rows {r0}.. differs from phase 4's")
        log("index sketches of the first and last batch equal phase 4's bit for bit")

        qgen, qlabels = self._query_source()
        Xq = self._rows(qgen, centres, qlabels)  # phase 4's query rows
        lab, ql = labels.cpu().numpy(), qlabels.cpu().numpy()

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # the first call also packs every sealed segment's right factor once
        (iv, ii), first_s = timed(lambda: svc.query(Xq, top_k=TOP_K))
        (iv2, ii2), plain_s = timed(lambda: svc.query(Xq, top_k=TOP_K))
        if not (torch.equal(iv, iv2) and np.array_equal(ii, ii2)):
            raise AssertionError("two plain index queries on the same rows differ")
        ev, ei = self.engine_answers["plain"]
        self._check_index_topk("plain", iv, ii, ev, ei, self.qsk)
        eng_ms = self.engine_s["plain"] * 1e3 / PLAIN_QUERIES
        log(f"time index plain top-{TOP_K}: {PLAIN_QUERIES} queries x {CORPUS_ROWS} rows "
            f"through service.query (query sketch included) {plain_s * 1e3:.1f} ms = "
            f"{plain_s * 1e3 / PLAIN_QUERIES:.4f} ms/query; first call, packing every "
            f"segment, {first_s * 1e3:.1f} ms; engine path (knn, phase 4, query sketch "
            f"excluded) {eng_ms:.4f} ms/query {tag}")

        (mv, mi), mle_s = timed(lambda: svc.query(Xq[:MLE_QUERIES], top_k=TOP_K, mle=True))
        recall = float(np.mean(lab[mi[:, 0]] == ql[:MLE_QUERIES]))
        emv, emi = self.engine_answers["mle"]
        log(f"time index mle top-{TOP_K}: {MLE_QUERIES} queries in {mle_s * 1e3:.1f} ms = "
            f"{mle_s * 1e3 / MLE_QUERIES:.4f} ms/query (engine path {self.engine_s['mle'] * 1e3:.1f}"
            f" ms); cluster recall@1 {recall:.4f} (gate >= 0.9); ids equal to the engine's "
            f"{float(np.mean(mi == emi.cpu().numpy())):.4f}, values bit-equal "
            f"{torch.equal(mv, emv)} {tag}")
        if recall < 0.9:
            raise AssertionError(f"index MLE cluster recall@1 {recall} < 0.9")

        self._check_index_threshold(index, Xq[:INDEX_THRESHOLD_QUERIES], timed)

        gone = np.flatnonzero(lab < DELETED_CLUSTERS)  # ids are ingest positions
        removed, del_s = timed(lambda: svc.delete(gone))
        if removed != len(gone):
            raise AssertionError(f"delete removed {removed} of {len(gone)} rows")
        dv, di = svc.query(Xq, top_k=TOP_K)
        _, dmi = svc.query(Xq[:MLE_QUERIES], top_k=TOP_K, mle=True)
        if np.isin(di, gone).any() or np.isin(dmi, gone).any():
            raise AssertionError("a deleted id surfaced in a top-10")
        rewritten, compact_s = timed(lambda: index.compact(min_live_frac=0.95))
        cv, ci = svc.query(Xq, top_k=TOP_K)
        if not (torch.equal(cv, dv) and np.array_equal(ci, di)):
            raise AssertionError("compaction changed the plain top-10")
        log(f"time index delete of {DELETED_CLUSTERS} of {CLUSTERS} clusters ({removed} rows): "
            f"{del_s:.3f} s; compaction of {rewritten} segments (live fraction <= 0.95): "
            f"{compact_s:.3f} s; no deleted id in a plain or mle top-{TOP_K}; plain top-{TOP_K} "
            f"equal bit for bit before and after compaction {tag}")

        path = ROOT / "build" / "smoke_index"
        shutil.rmtree(path, ignore_errors=True)
        _, save_s = timed(lambda: svc.save(str(path)))
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        loaded, load_s = timed(lambda: SketchKnnService.load(str(path), key=self.key))
        lv, li = loaded.query(Xq, top_k=TOP_K)
        shutil.rmtree(path)
        if not (torch.equal(lv, cv) and np.array_equal(li, ci)):
            raise AssertionError("the reloaded index answers another plain top-10")
        del loaded
        log(f"time index save {save_s:.3f} s, load {load_s:.3f} s, {nbytes} bytes on disk "
            f"({len(index.sealed)} segments); reloaded plain top-{TOP_K} equal bit for bit {tag}")

        self._check_batcher(svc, MicroBatcher, Xq)

        self.index_launches = {name: kern.launches for name, kern in self.kernels.items()}
        log(f"index phase launches (comparisons with the engine and direct queries "
            f"excluded): {self.index_launches}")
        for name, n in self.index_launches.items():
            if n <= 0:
                raise AssertionError(f"{name} was never launched in the index phase")
        self._profile_window(f"index plain, {PLAIN_QUERIES} queries x {index.n_live} live rows "
                             f"in {len(index.sealed)} segments (query sketch given)",
                             lambda: index.query_sketch(self.qsk, top_k=TOP_K))
        qt = LpSketch(U=self.qsk.U[:INDEX_THRESHOLD_QUERIES],
                      moments=self.qsk.moments[:INDEX_THRESHOLD_QUERIES])
        self._profile_window(f"index threshold (relative {RELATIVE_RADIUS}), "
                             f"{INDEX_THRESHOLD_QUERIES} queries x {index.n_live} live rows "
                             f"(query sketch given)",
                             lambda: index.query_threshold_sketch(
                                 qt, radius=RELATIVE_RADIUS, relative=True))

    @contextlib.contextmanager
    def _uncounted(self):
        """Launches made inside only to compare with another route do not
        count towards the path's launches."""
        saved = {name: kern.launches for name, kern in self.kernels.items()}
        try:
            yield
        finally:
            for name, kern in self.kernels.items():
                kern.launches = saved[name]

    def _check_index_topk(self, name, iv, ii, ev, ei, qsk):
        """Index top-k against the engine's: ids equal wherever the engine's
        value at that rank is more than the route-agreement tolerance from
        its neighbours, the 11th included."""
        torch = self.torch
        from repro_torch import engine
        from repro_torch.core import LpSketch

        ei_h = ei.cpu().numpy()
        bad_rows = np.flatnonzero((ii != ei_h).any(axis=1))
        bits = torch.equal(iv, ev)
        log(f"index {name} top-{TOP_K} against the engine path: values bit-equal {bits}, "
            f"max |dv| {float((iv - ev).abs().max()):.6g}, rows with other ids "
            f"{len(bad_rows)} of {ii.shape[0]}")
        if not len(bad_rows):
            return
        rows = torch.from_numpy(bad_rows).to(self.dev)
        sub = LpSketch(U=qsk.U[rows], moments=qsk.moments[rows])
        with self._uncounted():
            wv, _ = engine.pairwise(sub, self.corpus, self.cfg, reduce="topk",
                                    top_k=TOP_K + 1)
        gaps = torch.diff(wv, dim=1)
        near = torch.zeros_like(wv, dtype=torch.bool)
        near[:, 1:] |= gaps <= self.agree_tol
        near[:, :-1] |= gaps <= self.agree_tol
        differ = torch.from_numpy(ii[bad_rows] != ei_h[bad_rows]).to(self.dev)
        if bool((differ & ~near[:, :TOP_K]).any()):
            raise AssertionError(f"index {name} top-{TOP_K} ids differ from the engine's "
                                 f"away from near-ties")

    def _check_index_threshold(self, index, Xt, timed):
        """A relative threshold over the whole index against the engine's
        threshold over phase 4's corpus sketch."""
        torch = self.torch
        from repro_torch import engine
        from repro_torch.core import LpSketch, pack_sketch, sketch

        (hr, hid), thr_s = timed(lambda: index.query_threshold(
            Xt, radius=RELATIVE_RADIUS, relative=True))
        with self._uncounted():
            qt = sketch(Xt, self.key, self.cfg)
            (er, ec), eng_s = timed(lambda: engine.pairwise(
                qt, self.corpus, self.cfg, reduce="threshold", radius=RELATIVE_RADIUS,
                relative=True))
        got = hr * CORPUS_ROWS + hid
        want = (er * CORPUS_ROWS + ec).cpu().numpy()
        diff = np.setxor1d(got, want)
        worst = 0.0
        if diff.size:
            r = torch.from_numpy(diff // CORPUS_ROWS).to(self.dev)
            c = torch.from_numpy(diff % CORPUS_ROWS).to(self.dev)
            A, _, na = pack_sketch(LpSketch(qt.U[r], qt.moments[r]), self.cfg)
            _, B, nb = pack_sketch(LpSketch(self.corpus.U[c], self.corpus.moments[c]), self.cfg)
            rel = (na + nb + (A * B).sum(dim=1)) / (na + nb)
            worst = float((rel - RELATIVE_RADIUS).abs().max()) / RELATIVE_RADIUS
        log(f"time index threshold (relative {RELATIVE_RADIUS}): {Xt.shape[0]} queries x "
            f"{CORPUS_ROWS} rows in {thr_s * 1e3:.1f} ms, {got.size} pairs (engine path "
            f"{eng_s * 1e3:.1f} ms, {want.size} pairs); differing {diff.size}, their largest "
            f"distance from the radius {worst:.3g} of it (tol 1e-3); sorted by (query, id) "
            f"{bool(np.all(np.diff(got) > 0))} {self.tag()}")
        if worst > 1e-3 or not np.all(np.diff(got) > 0):
            raise AssertionError("index threshold hits disagree with the engine's")

    def _check_batcher(self, svc, MicroBatcher, Xq):
        """Concurrent callers coalesced into one pass; each answer equals a
        direct query of the caller's rows."""
        torch = self.torch
        mb = MicroBatcher(svc.index, max_batch=BATCHER_THREADS * BATCHER_ROWS,
                          max_wait_ms=10_000.0)
        parts = [Xq[i * BATCHER_ROWS:(i + 1) * BATCHER_ROWS] for i in range(BATCHER_THREADS)]
        results, errors = [None] * BATCHER_THREADS, []

        def call(i):
            try:
                results[i] = mb.query(parts[i], top_k=TOP_K)
            except BaseException as e:  # surfaced below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(BATCHER_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"micro-batcher callers failed or hung: {errors}")
        for i, (v, ids) in enumerate(results):
            with self._uncounted():
                dv, di = svc.query(parts[i], top_k=TOP_K)
            if not (torch.equal(v, dv) and np.array_equal(ids, di)):
                raise AssertionError(f"micro-batcher caller {i} differs from a direct query")
        log(f"micro-batcher: {BATCHER_THREADS} threads x {BATCHER_ROWS} rows in "
            f"{mb.batches_run} batch(es), {wall * 1e3:.1f} ms wall; each answer equals a "
            f"direct query {self.tag()}")
        if mb.batches_run != 1:
            raise AssertionError(f"{mb.batches_run} batches, not one coalesced batch")

    # 7 ------------------------------------------------------------------
    def time_kernels(self):
        torch = self.torch
        from repro_torch.kernels.pairwise_lp import pairwise_lp, pairwise_lp_ref
        from repro_torch.kernels.power_project import power_project, power_project_ref

        gen = torch.Generator(device=self.dev).manual_seed(SEED + 4)
        X, R, powers = power_project_inputs(torch, self.dev, gen)
        Xp = torch.stack([X ** e for e in powers])  # (P-1, n, D) for the library call
        flops = 2.0 * BATCH * D * K * len(powers)
        nbytes = 4.0 * (BATCH * D + D * K + BATCH * len(powers) * K)
        it = POWER_PROJECT_ITERS
        pp = dict(ms=cuda_ms(lambda: power_project(X, R, powers), it),
                  plain_ms=cuda_ms(lambda: power_project_ref(X, R, powers), it),
                  library_ms=cuda_ms(lambda: torch.matmul(Xp, R), it))
        self._bounds(pp, flops, nbytes)
        log(f"time power_project X ({BATCH}, {D}) f32, R ({D}, {K}), powers {powers}: "
            f"kernel {pp['ms']:.4f} ms, plain {pp['plain_ms']:.4f} ms, library "
            f"{pp['library_ms']:.4f} ms (torch.matmul of the stacked powers, made "
            f"beforehand, with R), {self._bound_text(pp, flops)} {self.tag()}")
        del X, Xp

        A, B, na, nb = pairwise_lp_inputs(torch, self.dev, gen)
        (n, kk), m = A.shape, B.shape[0]
        margins = na[:, None] + nb[None, :]
        flops = 2.0 * n * m * kk
        nbytes = 4.0 * ((n + m) * kk + n + m + n * m)
        it = PAIRWISE_LP_ITERS
        pl = dict(ms=cuda_ms(lambda: pairwise_lp(A, B, na, nb), it),
                  plain_ms=cuda_ms(lambda: pairwise_lp_ref(A, B, na, nb), it),
                  library_ms=cuda_ms(lambda: torch.addmm(margins, A, B.T), it))
        self._bounds(pl, flops, nbytes)
        log(f"time pairwise_lp A ({n}, {kk}) f32, B ({m}, {kk}), clip: kernel "
            f"{pl['ms']:.4f} ms, plain {pl['plain_ms']:.4f} ms, library "
            f"{pl['library_ms']:.4f} ms (torch.addmm of the margin matrix and A @ B.T, "
            f"no clip), {self._bound_text(pl, flops)} {self.tag()}")
        self.kernel_times = {"power_project": pp, "pairwise_lp": pl}

    @staticmethod
    def _bounds(t: dict, flops: float, nbytes: float):
        """The kernel's bound by its route, and the fp32 CUDA-core bound;
        a time under the route's bound means the bound is wrong."""
        t["bound_ms"], t["bound_by"] = bound_ms(flops, nbytes)
        t["fp32_bound_ms"] = fp32_bound_ms(flops, nbytes)
        if t["ms"] < t["bound_ms"]:
            raise AssertionError(f"kernel time {t['ms']} ms is under its bound "
                                 f"{t['bound_ms']} ms")

    @staticmethod
    def _bound_text(t: dict, flops: float) -> str:
        return (f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({flops / 1e9:.2f} "
                f"GFLOP as {TF32_PRODUCTS} TF32 products each at "
                f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s; {t['bound_ms'] / t['ms']:.3f} of it "
                f"reached), fp32 CUDA-core bound {t['fp32_bound_ms']:.4f} ms")

    def profile(self):
        """Device time by kernel and idle share of two short windows."""
        torch = self.torch
        from repro_torch.core import LpSketch, ProjectionKey, knn, sketch

        key = ProjectionKey(SEED)
        sketch(torch.zeros((8, D), device=self.dev), key, self.cfg)  # tiles cached
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 5)
        centres = torch.rand((CLUSTERS, D), generator=gen, device=self.dev)
        labels = torch.arange(BATCH, device=self.dev) % CLUSTERS
        sl = LpSketch(U=self.corpus.U[:THRESHOLD_ROWS],
                      moments=self.corpus.moments[:THRESHOLD_ROWS])
        windows = (
            (f"ingest, 8 sketch calls of {BATCH} rows (rows made on the card)",
             lambda: [sketch(self._rows(gen, centres, labels), key, self.cfg)
                      for _ in range(8)]),
            (f"knn plain, {PLAIN_QUERIES} queries x {THRESHOLD_ROWS} rows",
             lambda: knn(self.qsk, sl, self.cfg, top_k=TOP_K)),
        )
        for title, fn in windows:
            self._profile_window(title, fn)

    def _profile_window(self, title: str, fn) -> None:
        """Device time by kernel and the idle share of one call of ``fn``,
        after one unprofiled call."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, host = [], []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0))
            if dev_us > 0 and evt.device_type.name == "CUDA":
                rows.append((dev_us / 1e3, evt.count, evt.key))
            elif evt.device_type.name == "CPU" and evt.self_cpu_time_total > 0:
                host.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            log(f"profile {title}: no device time in the trace (not measured)")
            return
        log(f"profile {title}: wall {wall:.2f} ms, kernels {busy:.2f} ms, idle share "
            f"{max(0.0, 1 - busy / wall):.3f} {self.tag()}")
        for ms, count, name in sorted(rows, reverse=True)[:6]:
            log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<5d} {name[:80]} "
                f"{self.tag()}")
        # host time under the profiler: waits on the device land in the op
        # that waits (a copy to the host, a nonzero's count)
        for ms, count, name in sorted(host, reverse=True)[:4]:
            log(f"  host {ms:9.3f} ms x{count:<5d} {name[:60]} {self.tag()}")

    def result_line(self) -> str:
        rows = []
        for name, replaces in (("power_project", "src/repro/kernels/power_project/kernel.py:85"),
                               ("pairwise_lp", "src/repro/kernels/pairwise_lp/kernel.py:78")):
            t = self.kernel_times[name]
            rows.append({"name": name, "route": "cuda", "scheme": SCHEME,
                         "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
                         "launches": self.launches[name],
                         "launches_by_path": {"engine": self.launches[name],
                                              "index": self.index_launches[name]},
                         "max_abs_err": self.err[name],
                         "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        for row in rows:
            for k, v in row.items():
                if isinstance(v, float) and not math.isfinite(v):
                    raise AssertionError(f"{row['name']} {k} is not finite")
        # the card beside every time, as on every other line with a time
        return json.dumps({"kernels": rows, "card": self.card})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets TF32 off; fails where the port is missing)

    t_start = time.perf_counter()
    smoke = Smoke()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smoke.card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    smoke.build()
    smoke.compare_power_project()
    smoke.compare_pairwise_lp()
    smoke.example_gate()
    smoke.main_path()
    smoke.agreement()
    smoke.index_phase()
    smoke.time_kernels()
    smoke.profile()
    log(f"total {time.perf_counter() - t_start:.1f} s {smoke.tag()}")
    print(smoke.result_line())
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
