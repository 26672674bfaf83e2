"""Smoke run of the solver's main path on NVIDIA GPUs.

    python chip_smoke.py            # every single-card phase, one card
    python chip_smoke.py --mesh4    # the four-card mesh phase only

Each phase drives the public entry points (``denoise4D``, ``denoise3D``,
``denoise_sharded``, the ``cytv`` CLI) with numpy in and numpy out, at the
reference's own workload sizes, and prints one JSON object: shape,
schedule, iterations run, compile and wall time, voxel-updates/s, the
process's peak device memory, the error against the phase's reference and
its tolerance, and the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``.

The script exits non-zero and prints no result line when JAX finds no GPU
or any phase fails; nothing here falls back to the CPU. One process owns
the card(s).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The 256²×128² 4D FISTA cube holds ~43 GB of state; one process owns the
# card, so it takes 90% of the device memory rather than JAX's default 75%.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.90")

import numpy as np  # noqa: E402

# Tolerances (recon relative L2 error against the reference):
#: float32 runs, ops path and GPU step alike, vs the float64 golden model
#: (tests/golden.py): the repo's
#: reference-parity budget (README "Correctness"); float32 rounding over
#: 10 iterations sits near 1e-7.
TOL_GOLDEN = 1e-5
#: traces (b_norm, delta) vs the golden model: float32 tree sums over
#: 10^6-10^7 terms against exact float64 sums.
TOL_GOLDEN_TRACE = 1e-4
#: float64 runs (the ops path) vs the golden model: the same arithmetic in
#: the same precision, so only round-off (FMA contraction, summation
#: order) separates them, near 1e-15; the budget is the CPU golden
#: matrix's (tests/test_golden_matrix.py).
TOL_GOLDEN_F64 = 1e-10
TOL_GOLDEN_F64_TRACE = 1e-9
#: the GPU step vs the XLA ops path on the same card, after 10 FISTA
#: iterations: the same float32 operations, but the GPU compiler contracts
#: ``d + t*(d - d_old)`` into FMAs differently from XLA, so states agree to
#: float32 rounding, not bitwise. The traces are sums over ~3e8 terms in
#: another order.
TOL_STEP = 1e-6
TOL_STEP_TRACE = 1e-5
#: four-card mesh vs one card on the same cube: the same arithmetic with
#: halo operands at the seams; XLA may fuse the seam slabs differently
#: (FMA contraction), so agreement is to float32 ulps, not bitwise.
#: There is no matrix product anywhere, so TF32 never applies.
TOL_MESH = 1e-6
#: the cytv CLI vs the library call on the same card: the same program.
TOL_CLI = 1e-6


#: what each ``backend`` value runs on a GPU
_PATHS = {"jax": "ops path (XLA)", "pallas": "GPU step",
          "auto": "GPU step where it covers the run, else ops path"}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| in float64, accumulated slab by slab."""
    num = den = 0.0
    for i in range(a.shape[0]):
        x = np.asarray(a[i], np.float64)
        y = np.asarray(b[i], np.float64)
        num += float(np.sum((x - y) ** 2))
        den += float(np.sum(y * y))
    return float(np.sqrt(num / den))


def _max_abs(a: np.ndarray, b: np.ndarray) -> float:
    return float(max(np.max(np.abs(a[i] - b[i])) for i in range(a.shape[0])))


def _peak_bytes(devices) -> int:
    return int(max(d.memory_stats()["peak_bytes_in_use"] for d in devices))


def _cube(shape, seed):
    rng = np.random.default_rng(seed)
    cube = rng.standard_normal(shape, dtype=np.float32)
    cube *= np.float32(0.3)
    cube += np.float32(1.0)
    return cube


def _params(ndim):
    mu = np.full(ndim, 1.0, np.float32)
    lam = mu * np.float32(1.0 / (32.0 if ndim == 4 else 16.0))
    return mu, (1.0 / lam).astype(np.float64), (lam / mu).astype(np.float64)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _emit(rec: dict, card: str) -> None:
    rec["card"] = card
    print(json.dumps(rec), flush=True)


def _compile_report(shape, opts):
    """AOT-compile the jitted solver the API calls; return the compile
    time and XLA's memory analysis of the program."""
    import jax
    import jax.numpy as jnp

    from cytvdn_tpu.api import _run_jit

    ndim = len(shape)
    sds = jax.ShapeDtypeStruct
    lowered = _run_jit.lower(
        sds(shape, jnp.float32), sds((ndim,), jnp.float32),
        sds((ndim,), jnp.float32), opts=opts, reference_data=None)
    compiled, secs = _timed(lowered.compile)
    ma = compiled.memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes")
        if hasattr(ma, k)}
    return secs, mem


def _api_phase(name, shape, iterations, fista, stopping, card, devices):
    """One public-API run (cold, then warm), numpy in and numpy out."""
    import cytvdn_tpu as tv
    from cytvdn_tpu.config import SolverOptions, normalize_iterations
    from cytvdn_tpu.solver.engine import NullComm, _use_gpu_step

    ndim = len(shape)
    cube = _cube(shape, seed=ndim)
    mu, _, _ = _params(ndim)
    n_f, n_u = normalize_iterations(iterations, fista)
    opts = SolverOptions(ndim=ndim, iterations_fista=n_f,
                         iterations_unacc=n_u,
                         stopping_relative_change=stopping)
    compile_s, mem = _compile_report(shape, opts)
    fn = tv.denoise4D if ndim == 4 else tv.denoise3D

    def run():
        return fn(cube, mu, iterations=iterations, FISTA=fista,
                  stopping_relative_change=stopping, quiet=True)

    _, cold_s = _timed(run)
    (recon, b_norm, delta), warm_s = _timed(run)
    ran = int(np.count_nonzero(delta))
    ok = (recon.shape == cube.shape and bool(np.all(np.isfinite(recon)))
          and bool(np.all(np.isfinite(b_norm))) and ran > 0
          and bool(np.all(delta[:ran] > 0)))
    on_step = _use_gpu_step(opts, cube.dtype, cube.size, NullComm())
    rec = {
        "phase": name, "shape": list(shape),
        "path": _PATHS["pallas" if on_step else "jax"],
        "schedule": {"iterations": iterations, "FISTA": fista,
                     "stopping_relative_change": stopping},
        "iterations_run": ran,
        "compile_s": compile_s, "wall_cold_s": cold_s, "wall_s": warm_s,
        "voxel_updates_per_s": float(np.prod(shape)) * ran / warm_s,
        "peak_bytes_in_use": _peak_bytes(devices),
        "memory_analysis": mem,
        "error": {"check": "finite recon of the input's shape; positive "
                           "delta on every iteration run (correctness "
                           "at this width rests on the golden phases "
                           "and the step-vs-ops phase)",
                  "passed": ok},
    }
    _emit(rec, card)
    if not ok:
        raise RuntimeError(f"{name}: output check failed")
    return recon


def _golden_phase(name, shape, iters, fista, card, devices,
                  dtype=np.float32, backends=("jax", "pallas")):
    """Each backend on the card vs the float64 numpy golden model, on one
    cube: ``jax`` is the XLA ops path, ``pallas`` the GPU step."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import golden

    import cytvdn_tpu as tv

    ndim = len(shape)
    cube = _cube(shape, seed=10 + ndim).astype(dtype)
    mu, li, lm = _params(ndim)
    mu = mu.astype(dtype)
    fn = tv.denoise4D if ndim == 4 else tv.denoise3D
    n_f, n_u = (iters, 0) if fista else (0, iters)
    g_recon, g_b, g_d = golden.solve(cube.astype(np.float64), li, lm,
                                     n_f, n_u)
    f64 = dtype == np.float64
    tol = TOL_GOLDEN_F64 if f64 else TOL_GOLDEN
    trace_tol = TOL_GOLDEN_F64_TRACE if f64 else TOL_GOLDEN_TRACE
    failed = []
    for backend in backends:
        def run(backend=backend):
            return fn(cube, mu, iterations=iters, FISTA=fista, quiet=True,
                      backend=backend)

        (recon, b_norm, delta), cold_s = _timed(run)
        _, warm_s = _timed(run)
        err = _rel_l2(recon, g_recon)
        err_b = float(np.max(np.abs(b_norm - g_b) / np.abs(g_b)))
        err_d = float(np.max(np.abs(delta - g_d) / np.abs(g_d)))
        ok = (recon.dtype == dtype and err <= tol
              and max(err_b, err_d) <= trace_tol)
        _emit({
            "phase": f"{name}_{backend}", "shape": list(shape),
            "dtype": np.dtype(dtype).name, "path": _PATHS[backend],
            "schedule": {"iterations": iters, "FISTA": fista},
            "iterations_run": iters,
            "wall_cold_s": cold_s, "wall_s": warm_s,
            "voxel_updates_per_s": float(np.prod(shape)) * iters / warm_s,
            "peak_bytes_in_use": _peak_bytes(devices),
            "error": {"reference": "tests/golden.py float64",
                      "recon_rel_l2": err, "tol": tol,
                      "b_norm_max_rel": err_b, "delta_max_rel": err_d,
                      "trace_tol": trace_tol, "passed": ok},
        }, card)
        if not ok:
            failed.append(backend)
    if failed:
        raise RuntimeError(f"{name}: {failed} outside tolerance")


def _cli_phase(card, devices):
    try:
        import h5py  # noqa: F401
    except ImportError:
        _emit({"phase": "cytv_npy", "ran": False,
               "reason": "h5py does not import here; cytv writes EMD "
                         "through h5py"}, card)
        return
    import cytvdn_tpu as tv
    from cytvdn_tpu.cli import main
    from cytvdn_tpu.io.emd import read_emd

    work = os.path.join(REPO, "chiprun_out", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    shape = (64, 64, 32, 32)
    cube = _cube(shape, seed=99)
    np.save(os.path.join(work, "in.npy"), cube)
    out = os.path.join(work, "out.emd")
    rc, wall = _timed(lambda: main([
        "-i", os.path.join(work, "in.npy"), "-o", out, "-m", "1.0",
        "-n", "10", "-f", "1", "-v", "0"]))
    got = read_emd(out)
    want = tv.denoise4D(cube, np.full(4, 1.0, np.float32), iterations=10,
                        quiet=True)[0]
    err = _rel_l2(got, want)
    ok = rc == 0 and err <= TOL_CLI
    _emit({"phase": "cytv_npy", "ran": True, "shape": list(shape),
           "schedule": {"iterations": 10, "FISTA": True},
           "wall_s": wall, "peak_bytes_in_use": _peak_bytes(devices),
           "error": {"reference": "denoise4D on the same card",
                     "recon_rel_l2": err, "tol": TOL_CLI, "passed": ok}},
          card)
    if not ok:
        raise RuntimeError("cytv: output differs from denoise4D")


def _step_phase(card, devices):
    """The GPU step against the ops path at a real 4D width: recon,
    accumulators and shadow duals after 10 FISTA iterations, and the
    traces, each as relative L2 on the card."""
    import jax
    import jax.numpy as jnp

    from cytvdn_tpu.config import Backend, SolverOptions
    from cytvdn_tpu.solver.engine import run_solver

    shape = (256, 256, 72, 72)
    cube = jnp.asarray(_cube(shape, seed=7))
    li = jnp.full((4,), 32.0, jnp.float32)
    lm = 1.0 / li

    def rel(x, y):
        x, y = jnp.ravel(x), jnp.ravel(y)
        return float(jnp.sqrt(jnp.sum(jnp.square(x - y)) / jnp.sum(y * y)))

    outs, walls = {}, {}
    for b in (Backend.JAX, Backend.PALLAS):
        opts = SolverOptions(ndim=4, iterations_fista=10,
                             iterations_unacc=0, backend=b)
        run = jax.jit(lambda c, o=opts: run_solver(c, li, lm, o,
                                                   keep_state=True))
        outs[b] = jax.block_until_ready(run(cube))
        t0 = time.perf_counter()
        del outs[b]
        outs[b] = jax.block_until_ready(run(cube))
        walls[b.value] = time.perf_counter() - t0
    ref, got = outs[Backend.JAX], outs[Backend.PALLAS]
    err = {"recon": rel(got["recon"], ref["recon"]),
           "accs": max(rel(x, y) for x, y in zip(got["accs"], ref["accs"])),
           "ds": max(rel(x, y) for x, y in zip(got["ds"], ref["ds"])),
           "b_norm": rel(got["b_norm"], ref["b_norm"]),
           "delta": rel(got["delta"], ref["delta"])}
    ok = (max(err["recon"], err["accs"], err["ds"]) <= TOL_STEP
          and max(err["b_norm"], err["delta"]) <= TOL_STEP_TRACE)
    _emit({"phase": "gpu_step_vs_ops_256x256x72x72", "shape": list(shape),
           "schedule": {"iterations": 10, "FISTA": True},
           "iterations_run": int(got["iterations_run"]),
           "wall_s": walls,
           "voxel_updates_per_s": {k: float(np.prod(shape)) * 10 / v
                                   for k, v in walls.items()},
           "peak_bytes_in_use": _peak_bytes(devices),
           "error": {"reference": "ops path (backend='jax') on the same "
                                  "card", **err, "tol": TOL_STEP,
                     "trace_tol": TOL_STEP_TRACE, "passed": ok}}, card)
    del outs, ref, got, cube
    if not ok:
        raise RuntimeError("GPU step disagrees with the ops path")


def _stem4d_phase(card, devices):
    """The 256²×128² 4D FISTA cube in core when XLA's memory analysis of
    the compiled solver fits the card's ``bytes_limit``; otherwise the
    256²×72² cube, with the fit check printed either way."""
    from cytvdn_tpu.config import SolverOptions

    full = (256, 256, 128, 128)
    opts = SolverOptions(ndim=4, iterations_fista=10, iterations_unacc=0,
                         stopping_relative_change=1e-6)
    _, mem = _compile_report(full, opts)
    need = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    limit = int(devices[0].memory_stats()["bytes_limit"])
    fits = need <= limit
    _emit({"phase": "stem4d_fit_check", "shape": list(full),
           "memory_analysis": mem, "need_bytes": need,
           "bytes_limit": limit, "fits": fits}, card)
    shape = full if fits else (256, 256, 72, 72)
    _api_phase(f"stem4d_fista_{'x'.join(map(str, shape))}", shape, 10,
               True, 1e-6, card, devices)


def single_card(card, devices):
    import jax

    _golden_phase("golden_4d_fista_64x64x32x32", (64, 64, 32, 32), 10,
                  True, card, devices)
    _golden_phase("golden_3d_fista_64x64x256", (64, 64, 256), 10, True,
                  card, devices)
    _api_phase("eels3d_default_64x64x512", (64, 64, 512), 7500, False,
               None, card, devices)
    _api_phase("eels3d_fista_256x256x2048", (256, 256, 2048), 10, True,
               None, card, devices)
    _step_phase(card, devices)
    _stem4d_phase(card, devices)
    _cli_phase(card, devices)
    # float64 last: x64 stays on for the rest of the process. It runs the
    # ops path (the GPU step is float32 only).
    jax.config.update("jax_enable_x64", True)
    _golden_phase("golden_4d_fista_64x64x32x32_f64", (64, 64, 32, 32), 10,
                  True, card, devices, np.float64, ("jax",))
    _golden_phase("golden_3d_plain_64x64x256_f64", (64, 64, 256), 10, False,
                  card, devices, np.float64, ("jax",))


def mesh4(card, devices):
    """denoise_sharded over a 2×2 mesh of four cards vs one card."""
    import cytvdn_tpu as tv
    from cytvdn_tpu.parallel.api import denoise_sharded

    if len(devices) < 4:
        raise RuntimeError(f"--mesh4 needs 4 GPUs, JAX sees {len(devices)}")
    shape = (256, 256, 128, 128)
    cube = _cube(shape, seed=4)
    mu = np.full(4, 1.0, np.float32)
    (single, _, _), single_s = _timed(
        lambda: tv.denoise4D(cube, mu, iterations=10, quiet=True))

    def run():
        return denoise_sharded(cube, mu, iterations=10, FISTA=True,
                               shard=(2, 2, 1, 1), devices=devices[:4])

    _, cold_s = _timed(run)
    res, warm_s = _timed(run)
    err = _rel_l2(res["recon"], single)
    ok = err <= TOL_MESH and len(set(res["devices"])) == 4
    _emit({
        "phase": "mesh4_fista_256x256x128x128", "shape": list(shape),
        "shard": [2, 2, 1, 1], "devices_used": res["devices"],
        "schedule": {"iterations": 10, "FISTA": True},
        "iterations_run": int(res["iterations_run"]),
        "single_card_wall_s": single_s,
        "wall_cold_s": cold_s, "wall_s": warm_s,
        "voxel_updates_per_s": float(np.prod(shape)) * 10 / warm_s,
        "peak_bytes_in_use": _peak_bytes(devices[:4]),
        "error": {"reference": "denoise4D on one card, same process",
                  "recon_rel_l2": err, "max_abs": _max_abs(res["recon"],
                                                           single),
                  "tol": TOL_MESH, "passed": ok},
    }, card)
    if not ok:
        raise RuntimeError("mesh4: mesh result disagrees with one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh4", action="store_true",
                   help="run only the four-card mesh phase")
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"error: JAX finds no GPU (default backend "
              f"{jax.default_backend()!r}); this smoke run needs the card",
              file=sys.stderr)
        return 2
    from cytvdn_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    card = _card()
    print("# card (nvidia-smi --query-gpu=name,power.limit):", flush=True)
    print(card, flush=True)
    print(f"# compile cache: {cache}; XLA_PYTHON_CLIENT_MEM_FRACTION="
          f"{os.environ['XLA_PYTHON_CLIENT_MEM_FRACTION']}", flush=True)
    if args.mesh4:
        mesh4(card, devices)
    else:
        single_card(card, devices)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
