"""Sharded half-isotropic runs.

The reference has NO distributed iso at all (reference README.md:25-26 —
its MPI path is anisotropic-only). Here the joint L2 projection runs on
a mesh through the same ops-path engine as the single-device run, with
the operand halos of ``parallel/halo.py`` at every split pair axis.

Every test asserts mesh == single device at the seam tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cytvdn_tpu.config import Backend, SolverOptions
from cytvdn_tpu.parallel.sharded import run_sharded
from cytvdn_tpu.solver.engine import run_solver

RNG = np.random.default_rng(7)


def _cube(shape):
    return (RNG.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)


def _params(ndim):
    mu = np.full(ndim, 1.0, np.float32)
    lam = mu / 32.0
    return (1.0 / lam).astype(np.float32), (lam / mu).astype(np.float32)


def _check(shape, shard, opts_kw, rtol=2e-6, atol=2e-7):
    cube = _cube(shape)
    li, lm = _params(4)
    base = SolverOptions(ndim=4, **opts_kw)
    opts = SolverOptions(**{**base.__dict__, "backend": Backend.JAX})
    single = run_solver(jnp.asarray(cube), jnp.asarray(li),
                        jnp.asarray(lm), opts)
    got = run_sharded(cube, li, lm, opts, shard=shard)
    np.testing.assert_allclose(
        np.asarray(got["recon"]), np.asarray(single["recon"]),
        rtol=rtol, atol=atol, err_msg=f"shard {shard}")
    np.testing.assert_allclose(
        np.asarray(got["b_norm"]), np.asarray(single["b_norm"]),
        rtol=2e-4)
    np.testing.assert_allclose(
        np.asarray(got["delta"]), np.asarray(single["delta"]),
        rtol=2e-4, atol=1e-7)


FISTA = dict(iterations_fista=4, iterations_unacc=0, isotropic_R=True)


@pytest.mark.parametrize("shard", [
    (4, 1, 1, 1),   # axis 0 split
    (1, 4, 1, 1),   # axis 1 split
    (2, 2, 1, 1),   # both pair axes split
])
def test_iso_r_fused_sharded(shard):
    _check((8, 8, 6, 16), shard, FISTA)


@pytest.mark.parametrize("shard", [
    (1, 1, 4, 1),   # Q pair, axis 2 split
    (1, 1, 1, 4),   # Q pair, axis 3 split
    (1, 1, 2, 2),   # both Q axes split
])
def test_iso_q_fused_sharded(shard):
    _check((6, 6, 8, 16), shard,
           dict(iterations_fista=4, iterations_unacc=0, isotropic_Q=True))


def test_iso_rq_fused_sharded_mixed_grid():
    # both pairs iso, splits touching one axis of each pair + a hybrid
    # schedule (FISTA then unaccelerated)
    _check((8, 6, 8, 16), (2, 1, 2, 1),
           dict(iterations_fista=3, iterations_unacc=2,
                isotropic_R=True, isotropic_Q=True))
    # both R axes split simultaneously with a split Q axis
    _check((8, 8, 8, 16), (2, 2, 2, 1),
           dict(iterations_fista=3, iterations_unacc=0,
                isotropic_R=True, isotropic_Q=True))


def test_iso_r_unaccelerated_sharded():
    _check((8, 8, 6, 16), (2, 2, 1, 1),
           dict(iterations_fista=0, iterations_unacc=5,
                isotropic_R=True))


def test_iso_r_sharded_multistrip():
    """Two-row shards: every row of a shard is next to a seam, so both
    halo directions feed the joint projection on every row."""
    shape = (8, 8, 4, 8)
    _check(shape, (4, 1, 1, 1), FISTA)
    _check(shape, (2, 2, 1, 1), FISTA)


def test_iso_r_sharded_early_stop_and_mse():
    """Distributed iso with the full metrics surface: early stopping and
    per-iteration SSE agree with the single-device run."""
    shape = (8, 8, 6, 16)
    cube = _cube(shape)
    ref = _cube(shape)
    li, lm = _params(4)
    kw = dict(ndim=4, iterations_fista=40, iterations_unacc=0,
              isotropic_R=True, isotropic_Q=True,
              stopping_relative_change=0.02, calculate_mse=True)
    opts = SolverOptions(**kw, backend=Backend.JAX)
    single = run_solver(jnp.asarray(cube), jnp.asarray(li),
                        jnp.asarray(lm), opts, jnp.asarray(ref))
    got = run_sharded(cube, li, lm, opts, reference_data=ref,
                      shard=(2, 2, 1, 1))
    assert int(got["iterations_run"]) == int(single["iterations_run"])
    np.testing.assert_allclose(np.asarray(got["recon"]),
                               np.asarray(single["recon"]),
                               rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(np.asarray(got["mse"]),
                               np.asarray(single["mse"]), rtol=2e-4)
