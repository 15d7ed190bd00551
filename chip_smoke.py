#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) through its main path on one
CUDA card and checks it.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

  1. build: both CUDA kernels (``src/repro_torch/csrc/*.cu``) are compiled
     with nvcc for sm_90a, in parallel; ``cuobjdump -sass`` of each library
     must show tensor-core instructions (HMMA on TF32, or HGMMA).
  2. kernel against plain version: each kernel is held against its plain
     PyTorch version on the same inputs, at the main path's shapes and at
     ragged ones (rows not 16-byte aligned, one past a tile, depth below
     one MMA step), with float32 and bfloat16 inputs; a second launch on
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
  6. timings of each kernel, its plain version and the nearest PyTorch
     library call at the main path's shapes, beside the least time the card
     could take for the kernel's route (bound: three TF32 tensor-core
     products per product, or the bytes) and the fp32 CUDA-core bound, and
     a profile of the ingest and query windows.

The line before the last is the card's name and power limit from
nvidia-smi; the last line is the JSON result.  Needs one CUDA card; exits
non-zero at once without one.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
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

    def main_path(self):
        torch = self.torch
        from repro_torch import engine
        from repro_torch.core import LpSketch, ProjectionKey, SketchConfig, knn, sketch

        cfg = SketchConfig(p=P, k=K, block_d=BLOCK_D)
        key = ProjectionKey(SEED)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        centres = torch.rand((CLUSTERS, D), generator=gen, device=self.dev)
        U = torch.empty((CORPUS_ROWS, P - 1, K), device=self.dev)
        M = torch.empty((CORPUS_ROWS, P - 1), device=self.dev)
        labels = torch.arange(CORPUS_ROWS, device=self.dev) % CLUSTERS
        qgen = torch.Generator(device=self.dev).manual_seed(SEED + 3)
        qlabels = torch.randint(0, CLUSTERS, (PLAIN_QUERIES,), generator=qgen,
                                device=self.dev)
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
        self.corpus, self.qsk, self.mq, self.cfg = corpus, qsk, mq, cfg

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
        from torch.profiler import ProfilerActivity, profile

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
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            rows = []
            for evt in prof.key_averages():
                dev_us = getattr(evt, "self_device_time_total",
                                 getattr(evt, "self_cuda_time_total", 0))
                if dev_us > 0 and evt.device_type.name == "CUDA":
                    rows.append((dev_us / 1e3, evt.count, evt.key))
            busy = sum(r[0] for r in rows)
            if busy <= 0:
                log(f"profile {title}: no device time in the trace (not measured)")
                continue
            log(f"profile {title}: wall {wall:.2f} ms, kernels {busy:.2f} ms, idle share "
                f"{max(0.0, 1 - busy / wall):.3f} {self.tag()}")
            for ms, count, name in sorted(rows, reverse=True)[:6]:
                log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<5d} {name[:80]} "
                    f"{self.tag()}")

    def result_line(self) -> str:
        rows = []
        for name, replaces in (("power_project", "src/repro/kernels/power_project/kernel.py:85"),
                               ("pairwise_lp", "src/repro/kernels/pairwise_lp/kernel.py:78")):
            t = self.kernel_times[name]
            rows.append({"name": name, "route": "cuda", "scheme": SCHEME,
                         "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
                         "launches": self.launches[name], "max_abs_err": self.err[name],
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
