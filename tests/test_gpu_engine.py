"""The engine on the GPU step: backend selection, and the solver scenarios
(hybrid schedules, early stop, MSE traces, keep_state/resume, chunked
resume) with the step in interpret mode against the ops-path engine.

Also the entry points' run-time helpers: the compile cache and the device
memory probe.
"""

import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cytvdn_tpu
from cytvdn_tpu import kernels
from cytvdn_tpu.config import Backend, BCMode, SolverOptions
from cytvdn_tpu.solver import engine
from cytvdn_tpu.solver.engine import HaloComm, NullComm, run_solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_gpu_step(monkeypatch):
    """Route covered configurations through the GPU step, run in interpret
    mode with small blocks so every program edge is exercised."""
    monkeypatch.setattr(
        engine, "_use_gpu_step",
        lambda opts, dtype, size, comm: (type(comm) is NullComm
                                         and kernels.covers(opts, dtype,
                                                            size)))
    monkeypatch.setattr(kernels, "gpu_step", functools.partial(
        kernels.step.gpu_step, block=32, chunk=3, interpret=True))


def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    n = len(shape)
    cube = jnp.asarray(rng.standard_normal(shape) * 0.4 + 1.0, jnp.float32)
    li = jnp.full((n,), 32.0 if n == 4 else 16.0, jnp.float32)
    return cube, li, 1.0 / li


def _run(cube, li, lm, ref=None, **kw):
    opts = SolverOptions(ndim=cube.ndim, calculate_mse=ref is not None, **kw)
    out = jax.jit(run_solver, static_argnames=("opts", "keep_state"))(
        cube, li, lm, opts, ref)
    return {k: np.asarray(v) for k, v in out.items()}


def _agree(got, want):
    np.testing.assert_allclose(got["recon"], want["recon"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["b_norm"], want["b_norm"], rtol=1e-5)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-4,
                               atol=1e-9)
    assert int(got["iterations_run"]) == int(want["iterations_run"])


def _ops_then_gpu(request, fn):
    """``fn()`` on the ops path, then with the GPU step engaged."""
    want = fn()
    request.getfixturevalue("on_gpu_step")
    return fn(), want


# -- backend selection -------------------------------------------------

def test_auto_on_cpu_is_the_ops_path():
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0)
    assert engine._use_gpu_step(opts, jnp.float32, 64, NullComm()) is False


@pytest.mark.parametrize("backend", [Backend.JAX, Backend.CPP])
def test_other_backends_never_take_the_step(backend):
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0,
                         backend=backend)
    assert engine._use_gpu_step(opts, jnp.float32, 64, NullComm()) is False


def test_explicit_pallas_without_gpu_raises():
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0,
                         backend="pallas")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        engine._use_gpu_step(opts, jnp.float32, 64, NullComm())


def test_explicit_pallas_through_the_api_raises_on_cpu():
    cube = np.ones((4, 5, 6), np.float32)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cytvdn_tpu.denoise3D(cube, np.float32(1.0), iterations=2,
                             backend="pallas", quiet=True)


def test_cli_accepts_pallas_backend():
    from cytvdn_tpu.cli import build_parser

    args = build_parser().parse_args(
        ["-i", "x.npy", "-o", "y.emd", "-m", "1", "--backend", "pallas"])
    assert args.backend == "pallas"


@pytest.fixture
def fake_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("kw,dtype,comm,expect", [
    ({}, jnp.float32, NullComm(), True),
    ({}, jnp.float64, NullComm(), False),
    ({"bc_mode": BCMode.MIRROR}, jnp.float32, NullComm(), False),
    ({"isotropic_Q": True}, jnp.float32, NullComm(), False),
    ({"lossy_duals": True}, jnp.float32, NullComm(), False),
    ({}, jnp.float32, HaloComm(), False),
])
def test_auto_on_gpu_takes_the_step_where_it_covers(fake_gpu, kw, dtype,
                                                    comm, expect):
    opts = SolverOptions(ndim=4, iterations_fista=2, iterations_unacc=0, **kw)
    assert engine._use_gpu_step(opts, dtype, 64, comm) is expect


@pytest.mark.parametrize("kw,dtype,comm", [
    ({}, jnp.float64, NullComm()),
    ({"bc_mode": BCMode.PERIODIC}, jnp.float32, NullComm()),
    ({"isotropic_R": True}, jnp.float32, NullComm()),
    ({}, jnp.float32, HaloComm()),
])
def test_explicit_pallas_outside_its_cover_raises(fake_gpu, kw, dtype, comm):
    opts = SolverOptions(ndim=4, iterations_fista=2, iterations_unacc=0,
                         backend=Backend.PALLAS, **kw)
    with pytest.raises(ValueError, match="covers float32 Jia-Zhao"):
        engine._use_gpu_step(opts, dtype, 64, comm)


def test_explicit_pallas_on_gpu_takes_the_step(fake_gpu):
    opts = SolverOptions(ndim=3, iterations_fista=0, iterations_unacc=2,
                         backend=Backend.PALLAS)
    assert engine._use_gpu_step(opts, jnp.float32, 64, NullComm()) is True


@pytest.mark.parametrize("size,expect", [
    (kernels.step.MAX_SIZE, True),
    (kernels.step.MAX_SIZE + 1, False),
    (1024 * 1024 * 2560, False),
])
def test_auto_on_gpu_leaves_int32_overflowing_cubes_to_ops(fake_gpu, size,
                                                           expect):
    """The step's kernels index in int32, so cubes past MAX_SIZE (such as a
    1024×1024×2560 EELS cube, which fits the card in core) run the ops
    path."""
    opts = SolverOptions(ndim=3, iterations_fista=0, iterations_unacc=2)
    assert engine._use_gpu_step(opts, jnp.float32, size, NullComm()) is expect


def test_explicit_pallas_past_int32_raises(fake_gpu):
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0,
                         backend=Backend.PALLAS)
    with pytest.raises(ValueError, match="at most 2147482624 elements"):
        engine._use_gpu_step(opts, jnp.float32, 2**31, NullComm())


def test_engine_routes_an_int32_overflowing_cube_to_ops(fake_gpu,
                                                        monkeypatch):
    """Traced at 2**31 elements (never run), the solver on a GPU calls the
    ops path's step, not the GPU step."""
    def no_step(*a, **k):
        raise AssertionError("the GPU step was traced")

    monkeypatch.setattr(kernels, "gpu_step", no_step)
    opts = SolverOptions(ndim=3, iterations_fista=1, iterations_unacc=0)
    s = jax.ShapeDtypeStruct((1024, 1024, 2048), jnp.float32)
    v = jax.ShapeDtypeStruct((3,), jnp.float32)
    jax.eval_shape(functools.partial(run_solver, opts=opts), s, v, v)


# -- solver scenarios on the GPU step ----------------------------------

@pytest.mark.parametrize("shape", [(6, 5, 9), (5, 4, 3, 7)])
@pytest.mark.parametrize("iters", [(5, 0), (0, 5), (3, 4)])
def test_engine_on_gpu_step_matches_ops(request, shape, iters):
    cube, li, lm = _problem(shape, seed=len(shape))
    got, want = _ops_then_gpu(request, lambda: _run(
        cube, li, lm, iterations_fista=iters[0], iterations_unacc=iters[1]))
    _agree(got, want)


@pytest.mark.parametrize("iters", [(4, 0), (0, 6), (3, 4), (5, 3)])
def test_hybrid_early_stop_zero_padded_traces(request, iters):
    """The stop lands on the same iteration as the ops path, and the
    skipped trace slots stay zero at the same positions."""
    cube, li, lm = _problem((6, 4, 5, 9), seed=3)
    free = _run(cube, li, lm, iterations_fista=iters[0],
                iterations_unacc=iters[1])
    stop = float(free["delta"][1]) * 1.0001
    got, want = _ops_then_gpu(request, lambda: _run(
        cube, li, lm, iterations_fista=iters[0], iterations_unacc=iters[1],
        stopping_relative_change=stop))
    np.testing.assert_array_equal(got["delta"] == 0, want["delta"] == 0)
    _agree(got, want)


@pytest.mark.parametrize("iters", [(6, 0), (0, 6), (4, 3)])
def test_mse_traces_on_gpu_step(request, iters):
    cube, li, lm = _problem((6, 5, 4, 7), seed=13)
    ref, _, _ = _problem((6, 5, 4, 7), seed=14)
    got, want = _ops_then_gpu(request, lambda: _run(
        cube, li, lm, ref=ref, iterations_fista=iters[0],
        iterations_unacc=iters[1]))
    _agree(got, want)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 6, 64), (6, 4, 6, 16)])
def test_mse_float64_reference_on_gpu_step(on_gpu_step, shape):
    """A float64 reference next to a float32 cube is cast at entry, so the
    run stays on the float32 GPU step."""
    cube, li, lm = _problem(shape, seed=47)
    ref64 = jnp.asarray(np.random.default_rng(48).standard_normal(shape))
    opts = SolverOptions(ndim=len(shape), iterations_fista=4,
                         iterations_unacc=0, calculate_mse=True)
    out = run_solver(cube, li, lm, opts, reference_data=ref64)
    assert out["mse"].dtype == jnp.float32
    assert np.all(np.asarray(out["mse"]) > 0)


@pytest.mark.parametrize("split", [2, 4])
def test_keep_state_resume_on_gpu_step(on_gpu_step, split):
    """Resuming from a kept state reproduces the straight run bit for bit
    (a FISTA phase cut mid-way, then the unaccelerated phase)."""
    cube, li, lm = _problem((7, 5, 6, 5), seed=21)
    opts = SolverOptions(ndim=4, iterations_fista=5, iterations_unacc=3)
    straight = run_solver(cube, li, lm, opts)
    part = run_solver(cube, li, lm, opts, i_stop=split, keep_state=True)
    rest = run_solver(cube, li, lm, opts, state=part)
    for k in ("recon", "b_norm", "delta"):
        np.testing.assert_array_equal(np.asarray(rest[k]),
                                      np.asarray(straight[k]))


def test_chunked_resume_bitexact_on_gpu_step(on_gpu_step, tmp_path):
    """Checkpointed chunks (an odd cadence that cuts the FISTA phase) end
    where the straight run ends, bit for bit, and so does a resume from
    the checkpoint file."""
    from cytvdn_tpu.utils.checkpoint import run_chunked

    cube, li, lm = _problem((6, 5, 33), seed=31)
    opts = SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=3)
    straight = run_solver(cube, li, lm, opts)
    path = str(tmp_path / "state.ck")
    chunked = run_chunked(np.asarray(cube), li, lm, opts,
                          checkpoint_path=path, checkpoint_every=3)
    resumed = run_chunked(np.asarray(cube), li, lm, opts,
                          checkpoint_path=path, checkpoint_every=3,
                          resume=True)
    for out in (chunked, resumed):
        np.testing.assert_array_equal(np.asarray(out["recon"]),
                                      np.asarray(straight["recon"]))
        np.testing.assert_array_equal(np.asarray(out["delta"]),
                                      np.asarray(straight["delta"]))


# -- entry-point helpers -----------------------------------------------

def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from cytvdn_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_fixed_in_checkout_path(monkeypatch):
    from cytvdn_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", got)]
    assert cache.enable_compile_cache() == got  # the same path every call


def test_compile_cache_dir_is_git_ignored():
    r = subprocess.run(["git", "check-ignore", "-q", ".jax_cache/x"],
                       cwd=REPO)
    assert r.returncode == 0


def test_library_import_sets_no_compile_cache():
    code = ("import jax, cytvdn_tpu, cytvdn_tpu.parallel; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run(["python", "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "None"


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expect", [
    ({"bytes_limit": 76515742126, "bytes_in_use": 0}, 76515742126),
    ({"bytes_in_use": 0}, None),
    (None, None),
])
def test_device_memory_reads_bytes_limit(monkeypatch, stats, expect):
    from cytvdn_tpu.utils import memory

    monkeypatch.setattr(jax, "devices", lambda: [_Dev(stats)])
    assert memory._device_memory() == expect


def test_peak_bandwidth_unknown_kind_is_an_error():
    from cytvdn_tpu.utils.perf import peak_bandwidth

    assert peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no published bandwidth"):
        peak_bandwidth("cpu")
