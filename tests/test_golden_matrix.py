"""The XLA ops path against the float64 numpy golden model (tests/golden.py).

The ops path is the engine on every device, so this file is its spec
check: every boundary condition × rank × FISTA/plain × float32/float64
on odd, non-power-of-two shapes, the half-isotropic pairs, hybrid
schedules with zero-padded traces, exact early stopping, per-iteration
MSE traces, and random shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import golden
from cytvdn_tpu.config import BCMode, SolverOptions
from cytvdn_tpu.solver.engine import run_solver

_run = jax.jit(run_solver, static_argnames=("opts",))


def _problem(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    cube = (rng.standard_normal(shape) * 0.4 + 1.0).astype(dtype)
    mu = np.full(ndim, 1.0, dtype)
    lam = mu / (32.0 if ndim == 4 else 16.0)
    return cube, (1.0 / lam).astype(dtype), (lam / mu).astype(dtype)


def _solve(cube, li, lm, ref=None, **kw):
    opts = SolverOptions(ndim=cube.ndim, calculate_mse=ref is not None,
                         **kw)
    out = _run(jnp.asarray(cube), jnp.asarray(li), jnp.asarray(lm), opts,
               None if ref is None else jnp.asarray(ref))
    return {k: np.asarray(v) for k, v in out.items()}


def _golden(cube, li, lm, n_f, n_u, ref=None, **kw):
    f64 = functools.partial(np.asarray, dtype=np.float64)
    return golden.solve(f64(cube), f64(li), f64(lm), n_f, n_u,
                        reference_data=None if ref is None else f64(ref),
                        **kw)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check(got, want, dtype):
    """float64 agrees to round-off; float32 to the 1e-5 parity budget."""
    g_recon, g_b, g_d = want[:3]
    if dtype == np.float64:
        np.testing.assert_allclose(got["recon"], g_recon, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(got["b_norm"], g_b, rtol=1e-10)
        np.testing.assert_allclose(got["delta"], g_d, rtol=1e-9, atol=1e-15)
    else:
        assert _rel_l2(got["recon"], g_recon) <= 1e-5
        np.testing.assert_allclose(got["b_norm"], g_b, rtol=1e-4)
        np.testing.assert_allclose(got["delta"], g_d, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", [(7, 5, 9), (5, 3, 6, 7)])
@pytest.mark.parametrize("bc", [0, 1, 2])
def test_ops_matches_golden_matrix(bc, shape, fista, dtype):
    cube, li, lm = _problem(shape, seed=bc + len(shape), dtype=dtype)
    n = 6
    n_f, n_u = (n, 0) if fista else (0, n)
    got = _solve(cube, li, lm, iterations_fista=n_f, iterations_unacc=n_u,
                 bc_mode=BCMode(bc))
    assert got["recon"].dtype == dtype
    _check(got, _golden(cube, li, lm, n_f, n_u, bc=bc), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("iso_r,iso_q", [(True, False), (False, True),
                                         (True, True)])
def test_iso_pairs_match_golden(iso_r, iso_q, fista, dtype):
    cube, li, lm = _problem((6, 5, 7, 3), seed=7, dtype=dtype)
    n_f, n_u = (5, 0) if fista else (0, 5)
    got = _solve(cube, li, lm, iterations_fista=n_f, iterations_unacc=n_u,
                 isotropic_R=iso_r, isotropic_Q=iso_q)
    want = _golden(cube, li, lm, n_f, n_u, isotropic_R=iso_r,
                   isotropic_Q=iso_q)
    _check(got, want, dtype)


@pytest.mark.parametrize("iters", [(4, 0), (5, 0), (0, 6), (3, 4), (5, 3)])
def test_hybrid_schedules_zero_padded_traces(iters):
    """Hybrid schedules: the FISTA phase stops early, the unaccelerated
    phase always follows, and the skipped iterations' trace slots stay
    zero — at exactly the golden model's positions."""
    cube, li, lm = _problem((6, 4, 5, 9), seed=3)
    n_f, n_u = iters
    free = _golden(cube, li, lm, n_f, n_u)
    # stop one iteration into whichever phase runs first
    stop = float(free[2][1]) * 1.0001
    got = _solve(cube, li, lm, iterations_fista=n_f, iterations_unacc=n_u,
                 stopping_relative_change=stop)
    want = _golden(cube, li, lm, n_f, n_u, stopping=stop)
    np.testing.assert_array_equal(got["delta"] == 0, want[2] == 0)
    _check(got, want, np.float32)


@pytest.mark.parametrize("iters,stop_at", [((16, 0), 9), ((0, 16), 10),
                                           ((8, 8), 5)])
def test_early_stop_matches_golden(iters, stop_at):
    """The stop lands on the converging iteration (recorded, then
    break) exactly as the golden loop's."""
    cube, li, lm = _problem((8, 6, 40), seed=11, dtype=np.float64)
    n_f, n_u = iters
    free = _golden(cube, li, lm, n_f, n_u)
    stop = 0.5 * (free[2][stop_at - 1] + free[2][stop_at])
    got = _solve(cube, li, lm, iterations_fista=n_f, iterations_unacc=n_u,
                 stopping_relative_change=stop)
    want = _golden(cube, li, lm, n_f, n_u, stopping=stop)
    # the global index after the last recorded iteration (a hybrid run
    # that stops in its FISTA phase resumes at index n_f)
    assert int(got["iterations_run"]) == int(np.flatnonzero(want[2])[-1]) + 1
    _check(got, want, np.float64)


def test_early_stop_on_first_iteration():
    cube, li, lm = _problem((6, 6, 20), seed=2)
    got = _solve(cube, li, lm, iterations_fista=10, iterations_unacc=0,
                 stopping_relative_change=10.0)
    assert int(got["iterations_run"]) == 1
    assert bool(got["early_stopped"])
    assert np.count_nonzero(got["delta"]) == 1


@pytest.mark.parametrize("iters", [(8, 0), (0, 8), (5, 4)])
def test_mse_traces_match_golden(iters):
    cube, li, lm = _problem((6, 5, 4, 7), seed=13)
    ref, _, _ = _problem((6, 5, 4, 7), seed=14)
    n_f, n_u = iters
    got = _solve(cube, li, lm, ref=ref, iterations_fista=n_f,
                 iterations_unacc=n_u)
    want = _golden(cube, li, lm, n_f, n_u, ref=ref)
    _check(got, want, np.float32)
    np.testing.assert_allclose(got["mse"], want[3], rtol=1e-4)


@pytest.mark.parametrize("shape", [(8, 6, 64), (6, 4, 6, 16)])
def test_mse_float64_reference_normalized(shape):
    """A float64 reference (numpy's default under x64) next to a float32
    cube is cast at run_solver entry: SSE is computed in the cube's
    dtype, as the reference does."""
    orig, li, lm = _problem(shape, seed=47)
    ref64 = np.random.default_rng(48).standard_normal(shape)
    opts = SolverOptions(ndim=len(shape), iterations_fista=4,
                         iterations_unacc=0, calculate_mse=True)
    out = run_solver(jnp.asarray(orig), jnp.asarray(li), jnp.asarray(lm),
                     opts, reference_data=jnp.asarray(ref64))
    assert out["mse"].dtype == jnp.float32
    assert np.all(np.asarray(out["mse"]) > 0)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_random_shapes_vs_golden(seed):
    """Random ranks, extents (including 1- and 2-wide axes), BCs and
    schedules against the golden model."""
    rng = np.random.default_rng(1000 + seed)
    ndim = int(rng.integers(3, 5))
    shape = tuple(int(v) for v in rng.integers(1, 9, size=ndim))
    shape = (max(shape[0], 2),) + shape[1:]
    bc = int(rng.integers(0, 3))
    n_f, n_u = int(rng.integers(0, 5)), int(rng.integers(0, 4))
    if n_f + n_u == 0:
        n_f = 3
    cube, li, lm = _problem(shape, seed=seed, dtype=np.float64)
    got = _solve(cube, li, lm, iterations_fista=n_f, iterations_unacc=n_u,
                 bc_mode=BCMode(bc))
    _check(got, _golden(cube, li, lm, n_f, n_u, bc=bc), np.float64)
