"""repro_torch.core.sketch against repro.core.sketch, with R carried across.

``repro`` draws its R tiles with JAX's threefry and the port with PyTorch's
generator, so one seed gives two different R's.  These tests take the
reference's tiles (``repro.core.projections.projection_block`` under the
reference's per-matrix key) and carry them into the port through
``repro_torch.convert``; the two sketches of one numpy X must then agree.

Tolerances: U is a float32 sum over D of x^j r products, taken in another
order by each side (the reference scans D-blocks, the port makes one pass),
so the atol is 1e-5 of the sum of |terms| of the largest entry.  Moments are
exact sums of non-negative terms: rtol 1e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projections as jproj
from repro.kernels.power_project.ops import sketch_via_kernel
from repro_torch import convert
from repro_torch.core import projections as tproj

# both packages export a ``sketch`` function that hides the module's name
jsketch = importlib.import_module("repro.core.sketch")
tsketch = importlib.import_module("repro_torch.core.sketch")

_FAMILIES = {"normal": {}, "uniform": {}, "threepoint": {"s": 3.0}}


def _configs(p, k, strategy, block_d, family="normal"):
    extra = _FAMILIES[family]
    jcfg = jsketch.SketchConfig(p=p, k=k, strategy=strategy, block_d=block_d,
                                projection=jproj.ProjectionSpec(family=family, **extra))
    tcfg = tsketch.SketchConfig(p=p, k=k, strategy=strategy, block_d=block_d,
                                projection=tproj.ProjectionSpec(family=family, **extra))
    return jcfg, tcfg


def _matrix_ids(cfg):
    return [0] if cfg.strategy == "basic" else list(range(1, cfg.p))


def carry_key(key, jcfg, tcfg, D, block_offset=0):
    """The port's key holding exactly the reference's tiles for D columns."""
    bd = min(jcfg.block_d, D)
    tiles = {}
    for mid in _matrix_ids(jcfg):
        mkey = jax.random.fold_in(key, mid)
        for b in range(block_offset, block_offset + -(-D // bd)):
            tiles[(mid, b)] = np.asarray(
                jproj.projection_block(mkey, b, bd, jcfg.k, jcfg.projection))
    r_max = max(float(np.abs(t).max()) for t in tiles.values())
    return convert.projection_key_from_tiles(tiles, tcfg.projection), r_max


def _assert_u_close(got_U: torch.Tensor, want_U, X: np.ndarray, R_abs_max: float, p: int):
    want_U = np.asarray(want_U)
    assert tuple(got_U.shape) == want_U.shape and got_U.dtype == torch.float32
    Xa = np.abs(X.astype(np.float64))
    scale = max(float((Xa ** j).sum(axis=1).max()) for j in range(1, p)) * R_abs_max
    np.testing.assert_allclose(got_U.numpy(), want_U, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
@pytest.mark.parametrize("p", [4, 6])
@pytest.mark.parametrize("D,block_d", [(256, 128), (300, 128)])
def test_sketch_matches_reference(strategy, p, D, block_d):
    """Even and ragged D (300 = 2 full blocks + a 44-column tail)."""
    X = np.random.default_rng(p * D).uniform(-1, 1, (20, D)).astype(np.float32)
    jcfg, tcfg = _configs(p, 32, strategy, block_d)
    key = jax.random.key(p + D)
    want = jsketch.sketch(jnp.asarray(X), key, jcfg)
    tkey, r_max = carry_key(key, jcfg, tcfg, D)
    got = tsketch.sketch(torch.from_numpy(X), tkey, tcfg)
    _assert_u_close(got.U, want.U, X, r_max, p)
    np.testing.assert_allclose(got.moments.numpy(), np.asarray(want.moments), rtol=1e-5)
    np.testing.assert_allclose(got.norm_pp(p).numpy(), np.asarray(want.norm_pp(p)),
                               rtol=1e-5)


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
def test_sketch_block_offset_matches_reference(strategy):
    """A shard owning columns from block 3 on draws blocks 3, 4, ... of R."""
    X = np.random.default_rng(5).uniform(0, 1, (12, 192)).astype(np.float32)
    jcfg, tcfg = _configs(4, 16, strategy, 64)
    key = jax.random.key(11)
    want = jsketch.sketch(jnp.asarray(X), key, jcfg, block_offset=3)
    tkey, r_max = carry_key(key, jcfg, tcfg, 192, block_offset=3)
    got = tsketch.sketch(torch.from_numpy(X), tkey, tcfg, block_offset=3)
    _assert_u_close(got.U, want.U, X, r_max, 4)
    # without the offset the port asks for tiles 0..2, which were not carried
    with pytest.raises(KeyError):
        tsketch.sketch(torch.from_numpy(X), tkey, tcfg)


@pytest.mark.parametrize("family", ["uniform", "threepoint"])
def test_sketch_other_families_match_reference(family):
    X = np.random.default_rng(9).uniform(0, 1, (10, 128)).astype(np.float32)
    jcfg, tcfg = _configs(4, 16, "basic", 128, family)
    key = jax.random.key(4)
    want = jsketch.sketch(jnp.asarray(X), key, jcfg)
    tkey, r_max = carry_key(key, jcfg, tcfg, 128)
    got = tsketch.sketch(torch.from_numpy(X), tkey, tcfg)
    _assert_u_close(got.U, want.U, X, r_max, 4)


@pytest.mark.parametrize("strategy", ["basic", "alternative"])
def test_sketch_matches_the_reference_kernel_route(strategy):
    """The port's ingest runs through power_project, like the reference's
    ``sketch_via_kernel`` (interpret-mode Pallas here).  That route cuts R
    by ``projection.block_d``, so the full matrices are carried across."""
    D = 256
    X = np.random.default_rng(2).uniform(0, 1, (12, D)).astype(np.float32)
    jcfg, tcfg = _configs(4, 32, strategy, 2048)
    key = jax.random.key(9)
    want = sketch_via_kernel(jnp.asarray(X), key, jcfg, interpret=True)
    mats = {mid: np.asarray(jproj.projection_matrix(
        jax.random.fold_in(key, mid), D, jcfg.k, jcfg.projection))
        for mid in _matrix_ids(jcfg)}
    tkey = convert.projection_key_from_matrices(
        mats, tcfg.projection, block_d=jcfg.projection.block_d)
    got = tsketch.sketch(torch.from_numpy(X), tkey, tcfg)
    r_max = max(float(np.abs(R).max()) for R in mats.values())
    _assert_u_close(got.U, want.U, X, r_max, 4)
    np.testing.assert_allclose(got.moments.numpy(), np.asarray(want.moments), rtol=1e-5)


def test_carried_sketch_round_trips():
    X = np.random.default_rng(3).uniform(0, 1, (6, 64)).astype(np.float32)
    jcfg, _ = _configs(4, 8, "basic", 64)
    want = jsketch.sketch(jnp.asarray(X), jax.random.key(0), jcfg)
    got = convert.sketch_from_reference(np.asarray(want.U), np.asarray(want.moments),
                                        device="cpu")
    np.testing.assert_array_equal(got.U.numpy(), np.asarray(want.U))
    np.testing.assert_array_equal(got.moments.numpy(), np.asarray(want.moments))
    assert got.n == want.n
    np.testing.assert_array_equal(got.row(2).U.numpy(), np.asarray(want.row(2).U))


@pytest.mark.parametrize("family", ["normal", "uniform", "threepoint"])
def test_port_tiles_have_the_reference_moments(family):
    """The port's own draws differ from threefry's, but each family keeps
    mean 0, variance 1 and the fourth moment the reference's variance
    formulas assume (``repro.core.projections.fourth_moment``).  Bounds are
    5 standard errors of the 64k-sample means."""
    spec = tproj.ProjectionSpec(family=family, **_FAMILIES[family])
    key = tproj.ProjectionKey(1234)
    R = tproj.projection_block(key, 0, 3, 256, 256, spec, device="cpu").double()
    s = jproj.fourth_moment(jproj.ProjectionSpec(family=family, **_FAMILIES[family]))
    assert s == tproj.fourth_moment(spec)
    se = 1.0 / 256
    assert abs(float(R.mean())) < 5 * se
    assert abs(float((R ** 2).mean()) - 1.0) < 5 * se * np.sqrt(s - 1)
    assert abs(float((R ** 4).mean()) - s) < 0.05 * s


def test_port_tiles_are_deterministic_and_cached():
    spec = tproj.ProjectionSpec()
    a = tproj.ProjectionKey(7)
    t1 = tproj.projection_block(a, 2, 5, 64, 16, spec, device="cpu")
    assert tproj.projection_block(a, 2, 5, 64, 16, spec, device="cpu") is t1  # cached
    # a fresh key with the same seed draws the same tile; other ids differ
    b = tproj.ProjectionKey(7)
    torch.testing.assert_close(tproj.projection_block(b, 2, 5, 64, 16, spec, device="cpu"),
                               t1, rtol=0, atol=0)
    assert not torch.equal(tproj.projection_block(b, 2, 6, 64, 16, spec, device="cpu"), t1)
    assert not torch.equal(tproj.projection_block(b, 3, 5, 64, 16, spec, device="cpu"), t1)


def test_sketch_config_rejects_what_the_reference_rejects():
    for bad in (dict(p=5), dict(p=2), dict(strategy="other")):
        with pytest.raises(ValueError):
            jsketch.SketchConfig(**bad)
        with pytest.raises(ValueError):
            tsketch.SketchConfig(**bad)
    with pytest.raises(ValueError):
        tproj.ProjectionSpec(family="threepoint", s=0.5)
    assert dataclasses.is_dataclass(tsketch.SketchConfig())
