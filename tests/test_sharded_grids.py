"""Mesh ≡ single device on the grids the sharded path must get right:
axis-0 and axis-1 splits (down to 2-column shards), 2D scan grids, cubes
with a long energy axis split over a 2D grid, thin axis-1 shards, and the
stop, hybrid and per-iteration MSE schedules on them.

Every case compares ``run_sharded`` on the 8-device virtual CPU mesh with
the single-device ops-path run of the same cube.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cytvdn_tpu.config import SolverOptions
from cytvdn_tpu.parallel.sharded import run_sharded
from cytvdn_tpu.solver.engine import run_solver


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = jnp.asarray(rng.standard_normal(shape) * 0.4 + 1.0, jnp.float32)
    li = jnp.full((ndim,), 32.0 if ndim == 4 else 16.0, jnp.float32)
    return orig, li, 1.0 / li


def _mesh_vs_single(shape, shard, seed, ref=None, **kw):
    orig, li, lm = _state(shape, seed)
    opts = SolverOptions(ndim=len(shape), calculate_mse=ref is not None,
                         **kw)
    single = run_solver(orig, li, lm, opts,
                        reference_data=None if ref is None
                        else jnp.asarray(ref))
    got = run_sharded(np.asarray(orig), np.asarray(li), np.asarray(lm),
                      opts, shard=shard, reference_data=ref)
    np.testing.assert_allclose(np.asarray(got["recon"]),
                               np.asarray(single["recon"]),
                               rtol=5e-7, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got["b_norm"]),
                               np.asarray(single["b_norm"]), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got["delta"]),
                               np.asarray(single["delta"]), rtol=2e-4)
    assert int(got["iterations_run"]) == int(single["iterations_run"])
    return got, single


@pytest.mark.parametrize("shard,shape,iters", [
    ((8, 1, 1, 1), (32, 8, 6, 16), (4, 0)),
    ((4, 1, 1, 1), (16, 8, 6, 16), (5, 0)),     # odd iteration count
    ((2, 1, 1, 1), (8, 8, 6, 16), (3, 2)),      # hybrid
    ((4, 1, 1), (16, 6, 64), (0, 4)),           # 3D unaccelerated
    ((1, 4, 1, 1), (8, 16, 6, 16), (4, 0)),     # axis-1 mesh
    ((1, 2, 1, 1), (8, 8, 6, 16), (3, 2)),      # axis-1 hybrid
    ((1, 8, 1, 1), (8, 16, 6, 16), (5, 0)),     # axis-1, 2-column shards
    ((1, 4, 1), (6, 12, 64), (0, 4)),           # axis-1 3D unaccelerated
])
def test_single_axis_meshes_match_single_device(shard, shape, iters):
    _mesh_vs_single(shape, shard, 13, iterations_fista=iters[0],
                    iterations_unacc=iters[1])


@pytest.mark.parametrize("shard,shape,iters", [
    ((2, 2, 1, 1), (8, 8, 6, 16), (4, 0)),      # smallest 2D grid
    ((2, 4, 1, 1), (8, 16, 6, 16), (5, 0)),     # odd iteration count
    ((4, 2, 1, 1), (16, 8, 6, 16), (3, 2)),     # hybrid
    ((2, 2, 1), (8, 8, 64), (0, 4)),            # 3D unaccelerated
    ((2, 2, 1, 1), (8, 8, 6, 16), (0, 6)),      # 4D unaccelerated
])
def test_2d_grids_match_single_device(shard, shape, iters):
    _mesh_vs_single(shape, shard, 13, iterations_fista=iters[0],
                    iterations_unacc=iters[1])


@pytest.mark.parametrize("shard,shape,seed", [
    ((2, 2, 1), (8, 8, 256), 15),    # 2D grid, long energy axis
    ((1, 4, 1), (6, 8, 256), 21),    # axis-1 mesh, long energy axis
])
def test_long_energy_axis_meshes_match_single_device(shard, shape, seed):
    _mesh_vs_single(shape, shard, seed, iterations_fista=4,
                    iterations_unacc=0)


@pytest.mark.parametrize("shard,shape,iters,seed", [
    ((2, 2, 1, 1), (8, 24, 6, 16), (4, 0), 14),  # 2D grid, wide axis 1
    ((4, 1, 1, 1), (16, 12, 6, 16), (4, 2), 9),  # axis 0, wide axis 1
    ((1, 2, 1, 1), (5, 24, 6, 16), (4, 2), 22),  # axis 1, 5-row axis 0
])
def test_uneven_aspect_meshes_match_single_device(shard, shape, iters, seed):
    _mesh_vs_single(shape, shard, seed, iterations_fista=iters[0],
                    iterations_unacc=iters[1])


def test_early_stop_on_axis0_mesh():
    """Same stop iteration and recon as the single device."""
    shape = (16, 8, 6, 16)
    orig, li, lm = _state(shape, 5)
    free = run_solver(orig, li, lm, SolverOptions(
        ndim=4, iterations_fista=14, iterations_unacc=0))
    d = np.asarray(free["delta"])
    stop = float(0.5 * (d[8] + d[9]))
    got, single = _mesh_vs_single(shape, (4, 1, 1, 1), 5,
                                  iterations_fista=14, iterations_unacc=0,
                                  stopping_relative_change=stop)
    assert int(single["iterations_run"]) == 10


def test_mse_on_axis0_mesh():
    shape = (16, 8, 6, 16)
    ref = np.random.default_rng(14).standard_normal(shape).astype(np.float32)
    got, single = _mesh_vs_single(shape, (4, 1, 1, 1), 13, ref=ref,
                                  iterations_fista=10, iterations_unacc=0)
    np.testing.assert_allclose(np.asarray(got["mse"]),
                               np.asarray(single["mse"]), rtol=1e-5)


@pytest.mark.parametrize("shard,shape,iters", [
    ((2, 2, 1, 1), (8, 8, 6, 16), (8, 0)),   # FISTA 2D grid
    ((2, 2, 1), (8, 8, 64), (0, 6)),         # 3D unaccelerated
    ((2, 4, 1, 1), (8, 16, 6, 16), (5, 2)),  # hybrid
])
def test_mse_on_2d_grids(shard, shape, iters):
    ref = np.random.default_rng(18).standard_normal(shape).astype(np.float32)
    got, single = _mesh_vs_single(shape, shard, 17, ref=ref,
                                  iterations_fista=iters[0],
                                  iterations_unacc=iters[1])
    np.testing.assert_allclose(np.asarray(got["mse"]),
                               np.asarray(single["mse"]), rtol=1e-5)
