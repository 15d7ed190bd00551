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
