"""Distributed-exactness tests on a virtual 8-device CPU mesh.

The single guardrail test class that replaces the reference's entire MPI
seam-bug surface (SURVEY.md §4.3, §8.3): the shard_map run must match the
single-device run to machine epsilon — traces AND reconstruction.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import golden
from cytvdn_tpu.config import BCMode, SolverOptions
from cytvdn_tpu.parallel.partition import choose_grid
from cytvdn_tpu.parallel.sharded import run_sharded, resolve_shard
from cytvdn_tpu.solver.engine import run_solver

RNG = np.random.default_rng(3)


def setup_module():
    assert len(jax.devices()) >= 8, "conftest must provide 8 fake devices"


def _params(ndim, dtype=np.float64):
    mu = np.full(ndim, 1.0, dtype=dtype)
    lam = mu / (32.0 if ndim == 4 else 16.0)
    return (1.0 / lam).astype(dtype), (lam / mu).astype(dtype)


def _cube(shape, dtype=np.float64):
    return (RNG.standard_normal(shape) * 0.5 + 2.0).astype(dtype)


@pytest.mark.parametrize(
    "shard", [(2, 4, 1, 1), (4, 2, 1, 1), (2, 2, 2, 1), (1, 2, 2, 2)]
)
def test_sharded_4d_fista_matches_single_device(shard):
    """Scan-axis and Q-axis splits (the latter exceeds the reference, which
    never splits axes 2/3 — mpi.py:357-358)."""
    cube = _cube((8, 8, 6, 8))
    lambda_inv, lam_mu = _params(4)
    opts = SolverOptions(ndim=4, iterations_fista=7, iterations_unacc=0)
    single = run_solver(jnp.asarray(cube), jnp.asarray(lambda_inv),
                        jnp.asarray(lam_mu), opts)
    sharded = run_sharded(cube, lambda_inv, lam_mu, opts, shard=shard)
    np.testing.assert_allclose(
        np.asarray(sharded["recon"]), np.asarray(single["recon"]), atol=2e-15
    )
    np.testing.assert_allclose(
        np.asarray(sharded["b_norm"]), np.asarray(single["b_norm"]), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(sharded["delta"]), np.asarray(single["delta"]), rtol=1e-10
    )


def test_sharded_3d_unaccelerated_matches_golden():
    cube = _cube((8, 8, 16))
    lambda_inv, lam_mu = _params(3)
    want_recon, want_bnorm, want_delta = golden.solve(
        cube, lambda_inv, lam_mu, 0, 10
    )
    opts = SolverOptions(ndim=3, iterations_fista=0, iterations_unacc=10)
    sharded = run_sharded(cube, lambda_inv, lam_mu, opts, shard=(2, 4, 1))
    np.testing.assert_allclose(np.asarray(sharded["recon"]), want_recon,
                               atol=1e-13)
    np.testing.assert_allclose(np.asarray(sharded["b_norm"]), want_bnorm,
                               rtol=1e-11)
    np.testing.assert_allclose(np.asarray(sharded["delta"]), want_delta,
                               rtol=1e-9)


@pytest.mark.parametrize("bc", [BCMode.PERIODIC, BCMode.MIRROR, BCMode.JIA_ZHAO])
def test_sharded_bc_modes_match_single_device(bc):
    """All three BC modes stay exact across seams (the reference MPI path
    supports JZ only, README.md:116)."""
    cube = _cube((8, 6, 8))
    lambda_inv, lam_mu = _params(3)
    opts = SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=3,
                         bc_mode=bc)
    single = run_solver(jnp.asarray(cube), jnp.asarray(lambda_inv),
                        jnp.asarray(lam_mu), opts)
    sharded = run_sharded(cube, lambda_inv, lam_mu, opts, shard=(4, 1, 2))
    np.testing.assert_allclose(
        np.asarray(sharded["recon"]), np.asarray(single["recon"]), atol=2e-15
    )


def test_sharded_early_stop_matches_single_device():
    """On-device convergence + early stop work distributed — the capability
    the reference MPI path lacks entirely (README.md:34)."""
    cube = _cube((8, 8, 12))
    lambda_inv, lam_mu = _params(3)
    opts = SolverOptions(
        ndim=3, iterations_fista=0, iterations_unacc=300,
        stopping_relative_change=0.05,
    )
    single = run_solver(jnp.asarray(cube), jnp.asarray(lambda_inv),
                        jnp.asarray(lam_mu), opts)
    sharded = run_sharded(cube, lambda_inv, lam_mu, opts, shard=(2, 2, 2))
    assert int(sharded["iterations_run"]) == int(single["iterations_run"])
    np.testing.assert_allclose(
        np.asarray(sharded["recon"]), np.asarray(single["recon"]), atol=1e-13
    )


def test_sharded_isotropic_matches_single_device():
    cube = _cube((8, 8, 4, 4))
    lambda_inv, lam_mu = _params(4)
    opts = SolverOptions(ndim=4, iterations_fista=5, iterations_unacc=0,
                         isotropic_R=True, isotropic_Q=True)
    single = run_solver(jnp.asarray(cube), jnp.asarray(lambda_inv),
                        jnp.asarray(lam_mu), opts)
    sharded = run_sharded(cube, lambda_inv, lam_mu, opts, shard=(2, 4, 1, 1))
    np.testing.assert_allclose(
        np.asarray(sharded["recon"]), np.asarray(single["recon"]), atol=2e-15
    )


def test_resolve_shard_and_partitioner():
    assert resolve_shard("auto", (128, 64, 32, 32), 8)[2:] == (1, 1)
    assert np.prod(resolve_shard("auto", (128, 64, 32, 32), 8)) == 8
    # square-ish domain: partitioner prefers the split with fewer seam elems
    grid = choose_grid(4, (100, 100))
    assert grid == (2, 2)
    with pytest.raises(ValueError):
        resolve_shard((3, 1, 1), (8, 8, 8), 8)  # non-divisible
    # 'auto' always splits the two scan axes only, over all devices
    got = resolve_shard("auto", (16, 64, 32, 32), 8)
    assert got[2:] == (1, 1) and np.prod(got) == 8
    assert resolve_shard(None, (8, 8, 8), 8) == (1, 1, 1)


def test_auto_shard_falls_back_on_indivisible_extents():
    """Regression: shard='auto' with scan extents that no 8-device tiling
    divides must degrade to fewer devices, not raise (the reference
    partitioner handles such shapes, mpi.py:130-170)."""
    shard = resolve_shard("auto", (250, 250, 16), 8)
    assert np.prod(shard) >= 1
    assert 250 % shard[0] == 0 and 250 % shard[1] == 0
    # and it still runs
    cube = _cube((250, 10, 4), dtype=np.float32)
    lambda_inv, lam_mu = _params(3, np.float32)
    opts = SolverOptions(ndim=3, iterations_fista=0, iterations_unacc=2)
    out = run_sharded(cube, lambda_inv, lam_mu, opts, shard="auto")
    assert np.all(np.isfinite(np.asarray(out["recon"])))


def test_sharded_fista_restart_matches_single_device():
    """The adaptive-restart schedule (device-computed tk) must evolve
    identically on the mesh: psum'd deltas drive the same restarts."""
    cube = _cube((8, 8, 12))
    lambda_inv, lam_mu = _params(3)
    opts = SolverOptions(ndim=3, iterations_fista=12, iterations_unacc=0,
                         fista_restart=True)
    single = run_solver(jnp.asarray(cube), jnp.asarray(lambda_inv),
                        jnp.asarray(lam_mu), opts)
    sharded = run_sharded(cube, lambda_inv, lam_mu, opts, shard=(2, 2, 2))
    np.testing.assert_allclose(
        np.asarray(sharded["recon"]), np.asarray(single["recon"]), atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(sharded["delta"]), np.asarray(single["delta"]), rtol=1e-9
    )


def test_sharded_progress_chunked_matches_single_shot():
    """denoise_sharded(progress=True) routes through chunked execution;
    results must match the single-shot sharded run bit-for-bit (and the
    progress callback path must actually fire)."""
    import io
    from contextlib import redirect_stdout, redirect_stderr

    import numpy as np

    from cytvdn_tpu.parallel.api import denoise_sharded

    rng = np.random.default_rng(11)
    cube = (rng.standard_normal((16, 8, 6, 8)) * 0.3 + 1.0).astype(
        np.float32)
    mu = np.full(4, 1.0, np.float32)
    kw = dict(iterations=(4, 3), shard=(4, 1, 1, 1), quiet=True)
    want = denoise_sharded(cube, mu, **kw)
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(buf):
        got = denoise_sharded(cube, mu, progress=True, **kw)
    np.testing.assert_array_equal(got["recon"], want["recon"])
    np.testing.assert_array_equal(got["delta"], want["delta"])
