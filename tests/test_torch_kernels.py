"""The port's kernel wrappers on CPU tensors against repro's Pallas kernels.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; here
that version is held against the Pallas kernel run in interpret mode (as
tests/test_kernels.py and tests/test_kernel_padding.py run it) and against
the reference's own plain version, on the same numpy inputs.  The shape,
dtype, clip and padding grid is the reference tests'.  The CUDA kernels
themselves run only on the card (chip_smoke.py compares them with these
plain versions there).

Tolerances: both sides compute in float32 from the same values (bf16 inputs
are rounded to bf16 once, identically in both frameworks, and then taken to
float32), so results differ only by the order of the float32 sums.  The
atol is 1e-5 of the sum of |terms| of the largest output, the error bound
of a float32 dot product of these lengths with room to spare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_lp.kernel import pairwise_lp_call
from repro.kernels.pairwise_lp.ref import pairwise_lp_ref as jax_pairwise_lp_ref
from repro.kernels.power_project.kernel import power_project_call
from repro.kernels.power_project.ref import power_project_ref as jax_power_project_ref
from repro_torch.kernels.pairwise_lp import pairwise_lp, pairwise_lp_ref
from repro_torch.kernels.power_project import power_project, power_project_ref

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """The same values in both frameworks, rounded to ``dtype`` by each."""
    jd, td = _DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _assert_close(got: torch.Tensor, want, scale: float):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def _power_scale(X: np.ndarray, R: np.ndarray, powers) -> float:
    Xa, Ra = np.abs(X.astype(np.float64)), np.abs(R.astype(np.float64))
    return max(float((Xa ** e @ Ra).max()) for e in powers)


def _pairwise_scale(A, B, na, nb) -> float:
    Aa, Ba = np.abs(A.astype(np.float64)), np.abs(B.astype(np.float64))
    return float((Aa @ Ba.T).max() + np.abs(na).max() + np.abs(nb).max())


def _pairwise_inputs(n, m, K, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, K)).astype(np.float32),
            rng.standard_normal((m, K)).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, m).astype(np.float32))


@pytest.mark.parametrize("n,D,k", [(8, 128, 16), (32, 256, 64), (17, 130, 32), (256, 512, 128)])
@pytest.mark.parametrize("powers", [(1, 2, 3), (2,), (1, 2, 3, 4, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_project_matches_pallas(n, D, k, powers, dtype):
    rng = np.random.default_rng(n * 1000 + D + k)
    X = rng.uniform(-1, 1, (n, D)).astype(np.float32)
    R = rng.standard_normal((D, k)).astype(np.float32)
    Xj, Xt = _both(X, dtype)
    Rj, Rt = _both(R, dtype)
    got = power_project(Xt, Rt, powers)
    want = power_project_call(Xj, Rj, powers, bm=16, bd=64, interpret=True)
    scale = _power_scale(Xt.float().numpy(), Rt.float().numpy(), powers)
    _assert_close(got, want, scale)
    _assert_close(power_project_ref(Xt, Rt, powers),
                  jax_power_project_ref(Xj, Rj, powers), scale)


@pytest.mark.parametrize("powers", [(3, 1), (2, 2), (5, 3)])
def test_power_project_alternative_pairs_match_pallas(powers):
    """The (a, c) pairs of the alternative strategy, in either order."""
    rng = np.random.default_rng(sum(powers))
    X = rng.uniform(0, 1, (24, 200)).astype(np.float32)
    R = rng.standard_normal((200, 32)).astype(np.float32)
    got = power_project(torch.from_numpy(X), torch.from_numpy(R), powers)
    want = power_project_call(jnp.asarray(X), jnp.asarray(R), powers,
                              bm=16, bd=64, interpret=True)
    _assert_close(got, want, _power_scale(X, R, powers))


@pytest.mark.parametrize("n,m,K", [(16, 16, 64), (33, 65, 96), (128, 64, 384)])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_lp_matches_pallas(n, m, K, clip, dtype):
    A, B, na, nb = _pairwise_inputs(n, m, K, seed=n + m + K)
    Aj, At = _both(A, dtype)
    Bj, Bt = _both(B, dtype)
    naj, nat = _both(na, "float32")
    nbj, nbt = _both(nb, "float32")
    got = pairwise_lp(At, Bt, nat, nbt, clip=clip)
    want = pairwise_lp_call(Aj, Bj, naj, nbj, bm=16, bn=32, bk=32, clip=clip,
                            interpret=True)
    scale = _pairwise_scale(At.float().numpy(), Bt.float().numpy(), na, nb)
    _assert_close(got, want, scale)
    _assert_close(pairwise_lp_ref(At, Bt, nat, nbt, clip=clip),
                  jax_pairwise_lp_ref(Aj, Bj, naj, nbj, clip=clip), scale)
    if clip:
        assert float(got.min()) >= 0.0


@pytest.mark.parametrize(
    "n,m,K",
    [(130, 70, 192), (130, 64, 128), (64, 70, 128), (64, 64, 192), (1, 70, 192)],
)
def test_pairwise_lp_ragged_shapes_match_padded_pallas(n, m, K):
    """The Pallas call pads n, m and K to its blocks; the port masks them."""
    A, B, na, nb = _pairwise_inputs(n, m, K, seed=7)
    got = pairwise_lp(*(torch.from_numpy(a) for a in (A, B, na, nb)))
    want = pairwise_lp_call(*(jnp.asarray(a) for a in (A, B, na, nb)),
                            bm=64, bn=64, bk=128, interpret=True)
    _assert_close(got, want, _pairwise_scale(A, B, na, nb))


@pytest.mark.parametrize("clip", [True, False])
def test_pairwise_lp_ragged_epilogue_clip_paths(clip):
    A, B, na, nb = _pairwise_inputs(130, 70, 192, seed=10)
    got = pairwise_lp(*(torch.from_numpy(a) for a in (A, B, na, nb)), clip=clip)
    want = pairwise_lp_call(*(jnp.asarray(a) for a in (A, B, na, nb)),
                            bm=64, bn=64, bk=128, clip=clip, interpret=True)
    _assert_close(got, want, _pairwise_scale(A, B, na, nb))
    assert bool((got < 0).any()) == (not clip)


def test_cpu_tensors_never_count_a_launch():
    """The launch counters count kernel launches only: the plain version on
    CPU tensors adds nothing."""
    before = (power_project.launches, pairwise_lp.launches)
    power_project(torch.ones(4, 8), torch.ones(8, 3), (1, 2))
    pairwise_lp(torch.ones(4, 6), torch.ones(5, 6), torch.ones(4), torch.ones(5))
    assert (power_project.launches, pairwise_lp.launches) == before


def test_wrappers_raise_off_the_cpu_instead_of_running_the_plain_version():
    """A tensor that is not on the CPU never reaches the plain version: a
    device other than CUDA raises (a CUDA tensor would launch the kernel)."""
    X = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        power_project(X, torch.empty(8, 3, device="meta"), (1,))
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_lp(torch.empty(4, 6, device="meta"), torch.empty(5, 6, device="meta"),
                    torch.empty(4, device="meta"), torch.empty(5, device="meta"))


@pytest.mark.parametrize("bad", ["shape", "powers"])
def test_power_project_rejects_bad_arguments(bad):
    X, R = torch.ones(4, 8), torch.ones(8, 3)
    with pytest.raises(ValueError):
        if bad == "shape":
            power_project(X, torch.ones(7, 3), (1,))
        else:
            power_project(X, R, (1, 2, 3, 4, 5, 6, 7, 8))


def test_pairwise_lp_rejects_mismatched_margins():
    with pytest.raises(ValueError):
        pairwise_lp(torch.ones(4, 6), torch.ones(5, 6), torch.ones(5), torch.ones(5))
    # the reference rejects the mismatched K of the same inputs
    with pytest.raises(ValueError):
        pairwise_lp_call(jnp.ones((4, 6)), jnp.ones((5, 7)), jnp.ones(4), jnp.ones(5),
                         interpret=True)
    with pytest.raises(ValueError):
        pairwise_lp(torch.ones(4, 6), torch.ones(5, 7), torch.ones(4), torch.ones(5))


def test_build_library_name_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named by the hash of its source, every shared
    header in csrc and the flags: an edited header builds anew instead of
    reusing a stale library from an earlier build."""
    from repro_torch.kernels import build

    assert all('#include "tf32x3.cuh"' in (build._CSRC / f"{name}.cu").read_text()
               for name in build.KERNELS)
    (tmp_path / "power_project.cu").write_text('#include "tf32x3.cuh"\n')
    header = tmp_path / "tf32x3.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    first = build._library("power_project")
    assert build._library("power_project") == first
    header.write_text("// two\n")
    second = build._library("power_project")
    assert second != first
    (tmp_path / "extra.cuh").write_text("")
    assert build._library("power_project") not in (first, second)


# --- 3xTF32, emulated: the precision argument of csrc/tf32x3.cuh ----------

_TF32_MASK = np.uint32(0xFFFFE000)  # TF32 keeps 10 of float32's 23 mantissa bits


def _tf32(a: np.ndarray, rounding: str) -> np.ndarray:
    """float32 values cut to TF32: "nearest" rounds ties away from zero
    (cvt.rna; the bits are sign and magnitude, so adding half an ulp to them
    rounds the magnitude), "truncate" drops the 13 low bits as the MMA does
    with whatever it is given."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    if rounding == "nearest":
        u = u + np.uint32(0x1000)
    return (u & _TF32_MASK).view(np.float32)


def _f32_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 sums rounded to float32 toward zero, as the tensor cores
    round their float32 sums."""
    r = v.astype(np.float32)
    return np.where(np.abs(r.astype(np.float64)) > np.abs(v), np.nextafter(r, np.float32(0)), r)


def _emulate_mma(a: np.ndarray, b: np.ndarray, scheme: str, partial_steps) -> np.ndarray:
    """a (n, K) @ b (K, m) in float32 as the kernels sum it: 8-deep MMA
    steps; within a step the products are exact and summed into the
    accumulator rounded toward zero.  partial_steps: the products of that
    many steps (a 32-deep slice: 4) are summed from zero and then added to
    the running sum in IEEE float32, as both kernels do; None: they go into
    the running sum itself."""
    n, K = a.shape
    steps = -(-K // 8)
    a = np.pad(a, ((0, 0), (0, steps * 8 - K))).astype(np.float32)
    b = np.pad(b, ((0, steps * 8 - K), (0, 0))).astype(np.float32)
    if scheme == "3xtf32":  # small = x - big goes to the MMA as it is
        a_big, b_big = _tf32(a, "nearest"), _tf32(b, "nearest")
        terms = [(a - a_big, b_big), (a_big, b - b_big), (a_big, b_big)]  # small terms first
    elif scheme == "tf32_rounded":
        terms = [(_tf32(a, "nearest"), _tf32(b, "nearest"))]
    else:  # "tf32_truncated": raw float32 operands, cut by the MMA
        terms = [(a, b)]
    prods = [np.einsum("nsk,skm->snm",
                       _tf32(x, "truncate").reshape(n, steps, 8).astype(np.float64),
                       _tf32(y, "truncate").reshape(steps, 8, -1).astype(np.float64))
             for x, y in terms]
    acc = np.zeros((n, b.shape[1]), np.float32)
    if partial_steps is None:
        for s in range(steps):
            for p in prods:
                acc = _f32_toward_zero(acc + p[s])
        return acc
    for s0 in range(0, steps, partial_steps):
        part = np.zeros_like(acc)
        for s in range(s0, min(s0 + partial_steps, steps)):
            for p in prods:
                part = _f32_toward_zero(part + p[s])
        acc = acc + part
    return acc


def _sketch_factors(dtype: str):
    """Packed factors and margins of a small real sketch made by the port
    (p = 4, k = 256, so K = 768), rounded to ``dtype``."""
    from repro_torch.core import ProjectionKey, SketchConfig, pack_sketch, sketch

    rng = np.random.default_rng(13)
    cfg = SketchConfig(p=4, k=256, block_d=512)
    key = ProjectionKey(0)
    X = torch.from_numpy(rng.uniform(0, 1, (40, 1024)).astype(np.float32))
    qa, _, na = pack_sketch(sketch(X[:16], key, cfg), cfg)
    _, cb, nb = pack_sketch(sketch(X[16:], key, cfg), cfg)
    A, B = (t.to(_DTYPES[dtype][1]).float().numpy() for t in (qa, cb))
    return A, B, na.numpy(), nb.numpy()


@pytest.mark.parametrize("case,scheme,passes", [
    ("power_project_1..3", "3xtf32", True),
    ("power_project_1..7", "3xtf32", True),
    ("pairwise_lp", "3xtf32", True),
    ("pairwise_lp_bf16", "tf32_truncated", True),  # bf16 is exact in TF32: one MMA
    ("pairwise_lp", "tf32_truncated", False),      # a 1xTF32 shortcut fails here
    ("pairwise_lp", "tf32_rounded", False),
])
def test_tf32_emulation_error(case, scheme, passes):
    """The kernels' 3xTF32 sums stay within the 1e-5 x (largest sum of
    |terms|) tolerance that chip_smoke.py holds them to; a single TF32
    product does not."""
    if case.startswith("power_project"):
        powers = range(1, 4) if case.endswith("3") else range(1, 8)
        rng = np.random.default_rng(len(powers))
        X = rng.uniform(0, 1, (4, 16384)).astype(np.float32)
        R = rng.standard_normal((16384, 32)).astype(np.float32)
        xp, rows = X.copy(), []
        for e in range(1, max(powers) + 1):  # formed incrementally, as the kernel does
            if e > 1:
                xp = xp * X
            rows.append(xp)
        a = np.concatenate(rows)
        got = _emulate_mma(a, R, scheme, partial_steps=4)
        want = a.astype(np.float64) @ R.astype(np.float64)
        scale = float((np.abs(a.astype(np.float64)) @ np.abs(R.astype(np.float64))).max())
    else:
        A, B, na, nb = _sketch_factors("bfloat16" if case.endswith("bf16") else "float32")
        margins = na[:, None] + nb[None, :]
        got = margins + _emulate_mma(A, B.T, scheme, partial_steps=4)
        want = (margins.astype(np.float64)
                + A.astype(np.float64) @ B.T.astype(np.float64))
        scale = _pairwise_scale(A, B, na, nb)
    err = float(np.abs(got - want).max())
    assert (err <= 1e-5 * scale) == passes, (err / scale, scheme)


@pytest.mark.parametrize("case", ["power_project", "pairwise_lp"])
def test_tf32_fresh_partials_beat_round_toward_zero_running_sum(case):
    """Why both kernels sum each 32-deep slice's products from zero: the
    tensor cores' rounding toward zero, applied to one growing running sum,
    costs more than ten times the error of fresh partials added in IEEE
    float32, over power_project's D = 16,384 and over pairwise_lp's
    K = 768 on a real sketch's factors."""
    if case == "power_project":
        rng = np.random.default_rng(3)
        X = rng.uniform(0, 1, (4, 16384)).astype(np.float32)
        b = rng.standard_normal((16384, 32)).astype(np.float32)
        a = np.concatenate([X, X * X, X * X * X])
    else:
        a, B, _, _ = _sketch_factors("float32")
        b = B.T
    want = a.astype(np.float64) @ b.astype(np.float64)
    fresh, running = (float(np.abs(_emulate_mma(a, b, "3xtf32", steps) - want).max())
                      for steps in (4, None))
    assert 10 * fresh < running
