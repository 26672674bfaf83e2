"""Benchmark harness: voxel-update throughput of the 4D FISTA solver on one
NVIDIA GPU.

    python bench.py            # headline line only
    python bench.py --full     # also the BASELINE.json config matrix,
                               # written to chiprun_out/bench_detail.json

Prints ONE JSON line last: {"metric": ..., "value": N, "unit": ...,
"vs_baseline": N, "platform": ..., "device_kind": ...}. The metric is
voxel-updates/sec (one voxel-update = one voxel through one full TV
iteration: all per-axis dual updates + the reconstruction update), per
BASELINE.json.

Methodology:
- One process owns the card. It fails (exit 2, no result line) when JAX
  finds no GPU; nothing here falls back to the CPU.
- Data is generated on the device; completion is observed with
  ``block_until_ready`` on the delta trace; the best of three timed runs
  after a compile-and-warm run counts.
- Cells are sized against the device's own ``memory_stats()["bytes_limit"]``.
- Baseline: the reference's Cython/OpenMP kernels at 64 threads, taken as
  the single-thread CPU measurement of the reference (REFERENCE_PARITY.json
  or BASELINE_MEASURED.json) times 64 — an upper bound on the real
  64-thread reference, which makes ``vs_baseline`` conservative.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The 256²×128² 4D FISTA state (~52 GB with the input) needs more than
# JAX's default 75% share of an 80 GB card; this process owns the card.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.90")

# Headline candidates, largest first: the first whose in-core state fits
# the card is measured (BASELINE.json configs[4] is 256²×128²).
CONFIGS = [
    (256, 256, 128, 128),
    (256, 256, 72, 72),
    (128, 128, 128, 128),
    (64, 64, 64, 64),
]
# 25 iterations amortize fixed dispatch costs the way production runs do
# (the reference's Cori job runs 40, cori_MPI_example.sh:21-27)
ITERS = 25
#: cube-size buffers of an in-core 4D FISTA run: orig + recon + 4 accs +
#: 4 ds, plus one of slack for the solver's temporaries
_IN_CORE_BUFFERS = 11

# BASELINE.json's configs. A cube whose state does not fit the card runs
# through the out-of-core slab solver (solver/outofcore.py).
FULL_CONFIGS = [
    ("cfg1_3d_unacc_64x64x512", (64, 64, 512), False, None),
    ("cfg1_full_3d_unacc_64x64x512_7500it", (64, 64, 512), False, None),
    # the reference-default 3D budget through run_chunked at a
    # 500-iteration checkpoint/progress cadence (one dispatch per chunk)
    ("cfg1_chunked_3d_unacc_64x64x512_7500it", (64, 64, 512), False, None),
    ("cfg3_4d_unacc_128x128x64x64", (128, 128, 64, 64), False, None),
    ("cfg2_3d_fista_256x256x2048", (256, 256, 2048), True, None),
    # the reference's converged workflow sets stopping_relative_change
    # (reference cyTVDN.py:44,253); a non-triggering threshold keeps the
    # stop check active for every iteration
    ("cfg2_stop_3d_fista_256x256x2048", (256, 256, 2048), True, 1e-9),
    ("cfg4_proxy_4d_fista_256x256x72x72", (256, 256, 72, 72), True, None),
    ("cfg4_proxy_lossy_4d_fista_256x256x72x72",
     (256, 256, 72, 72), True, None),
    ("cfg4_4d_fista_256x256x128x128", (256, 256, 128, 128), True, None),
]
ITERS_OVERRIDE = {
    "cfg1_full_3d_unacc_64x64x512_7500it": 7500,
    "cfg1_chunked_3d_unacc_64x64x512_7500it": 7500,
}
_CHUNK_EVERY = 500


def _bytes_limit() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["bytes_limit"])


def _fits(shape) -> bool:
    return int(np.prod(shape)) * 4 * _IN_CORE_BUFFERS <= _bytes_limit()


def _params(ndim):
    mu = np.full(ndim, 1.0, dtype=np.float32)
    lam = mu / (32.0 if ndim == 4 else 16.0)
    return (1.0 / lam).astype(np.float32), (lam / mu).astype(np.float32)


def _device_cube(shape):
    import jax
    import jax.numpy as jnp

    return jax.jit(
        lambda key: jax.random.normal(key, shape, jnp.float32) * 0.3 + 1.0
    )(jax.random.key(0))


def _measure(shape, iters, fista=True, stopping=None, lossy=False):
    import jax
    import jax.numpy as jnp

    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.solver.engine import run_solver

    ndim = len(shape)
    opts = SolverOptions(
        ndim=ndim,
        iterations_fista=iters if fista else 0,
        iterations_unacc=0 if fista else iters,
        stopping_relative_change=stopping,
        lossy_duals=lossy,
    )
    li, lm = (jnp.asarray(x) for x in _params(ndim))
    cube = _device_cube(shape)
    fn = jax.jit(lambda c, a, b: run_solver(c, a, b, opts)["delta"])
    d = np.asarray(fn(cube, li, lm))  # compile + warm
    if not np.all(np.isfinite(d)):
        raise RuntimeError("non-finite delta")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(cube, li, lm).block_until_ready()
        times.append(time.perf_counter() - t0)
    return int(np.prod(shape)) * iters / min(times)


def _measure_chunked(shape, iters, every):
    """run_chunked at a checkpoint/progress cadence (one dispatch per
    chunk, state resumed on the device); the final recon fetch (numpy
    contract) is included."""
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.utils.checkpoint import run_chunked

    ndim = len(shape)
    li, lm = _params(ndim)
    opts = SolverOptions(ndim=ndim, iterations_fista=0,
                         iterations_unacc=iters)
    cube = _device_cube(shape)
    kw = dict(checkpoint_path=None, checkpoint_every=every)
    out = run_chunked(cube, li, lm, opts, **kw)  # compile + warm
    if not np.all(np.isfinite(out["recon"])):
        raise RuntimeError("non-finite recon")
    t0 = time.perf_counter()
    run_chunked(cube, li, lm, opts, **kw)
    return int(np.prod(shape)) * iters / (time.perf_counter() - t0)


def _measure_outofcore(shape, temporal_k=5):
    """A cube whose state exceeds the card: host-resident state streamed
    through the device in slabs, K iterations per residency. One sweep
    (K iterations) is timed, compiles included."""
    from cytvdn_tpu.config import SolverOptions
    from cytvdn_tpu.solver.outofcore import solve_outofcore_temporal

    ndim = len(shape)
    n0 = shape[0]
    li, lm = _params(ndim)
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.3)
    cube += np.float32(1.0)
    # three extended-slab generations x ~11 buffers live at the pipeline
    # peak: (core + 2K) rows per slab must fit bytes_limit / 33
    row_bytes = cube.nbytes // n0
    core = int(_bytes_limit() / 33 / row_bytes) - 2 * temporal_k
    if core < max(2, temporal_k):
        raise RuntimeError("cube too large for temporal out-of-core here")
    n_slabs = int(np.ceil(n0 / core))
    opts = SolverOptions(ndim=ndim, iterations_fista=temporal_k,
                         iterations_unacc=0)
    t0 = time.perf_counter()
    out = solve_outofcore_temporal(cube, li, lm, opts, n_slabs, temporal_k)
    dt = time.perf_counter() - t0
    if not np.isfinite(out["delta"][temporal_k - 1]):
        raise RuntimeError("non-finite delta")
    return int(np.prod(shape)) * temporal_k / dt, n_slabs


def _measure_row(name, shape, fista, stopping, device_kind):
    """Measure one FULL_CONFIGS row and return its record."""
    from cytvdn_tpu.utils.perf import efficiency

    iters = ITERS_OVERRIDE.get(name, ITERS)
    if len(shape) == 4 and fista and not _fits(shape):
        v, n_slabs = _measure_outofcore(shape)
        return {"voxel_updates_per_sec": v, "shape": list(shape),
                "fista": fista,
                "mode": f"out-of-core, temporal K=5 ({n_slabs} slabs)"}
    if name.startswith("cfg1_chunked"):
        v = _measure_chunked(shape, iters, _CHUNK_EVERY)
        return {"voxel_updates_per_sec": v, "shape": list(shape),
                "fista": fista, "iterations": iters,
                "mode": f"run_chunked every {_CHUNK_EVERY}"}
    lossy = "_lossy_" in name
    v = _measure(shape, iters, fista, stopping, lossy=lossy)
    rec = {"voxel_updates_per_sec": v, "shape": list(shape),
           "fista": fista, "iterations": iters,
           "fraction_of_two_pass_model_at_peak": efficiency(
               v, shape, device_kind, fista, "two_pass")}
    if lossy:
        rec["lossy_duals"] = True
    if stopping is not None:
        rec["stopping_relative_change"] = stopping
    return rec


def _reference_baseline():
    """Measured reference single-thread CPU rate (vox-upd/s) + provenance.
    Prefers the actual reference build (tools/reference_parity.py builds
    the real cyTVDN Cython kernels); falls back to the C++ proxy."""
    ref_path = os.path.join(REPO, "REFERENCE_PARITY.json")
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            rp = json.load(f)
        st = rp.get("reference_measured", {}).get(
            "vox_updates_per_sec_1thread_4d_fista_48x48x48x48")
        if st:
            return st, "cyTVDN Cython build, 1 CPU thread"
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        st = json.load(f)["reference_voxel_updates_per_sec_1thread"]
    return st, "C++ proxy of the reference kernels, 1 CPU thread"


def run_full(device_kind, out):
    """Measure FULL_CONFIGS into ``out`` (rewritten after every row)."""
    detail = {}
    for name, shape, fista, stopping in FULL_CONFIGS:
        rec = _measure_row(name, shape, fista, stopping, device_kind)
        detail[name] = rec
        print(f"# {name}: {rec['voxel_updates_per_sec'] / 1e9:.3f} "
              "Gvox-upd/s", file=sys.stderr)
        with open(out, "w") as f:
            json.dump(detail, f, indent=2)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import jax

    if jax.default_backend() != "gpu":
        print(f"error: JAX finds no GPU (default backend "
              f"{jax.default_backend()!r}); bench.py measures the card",
              file=sys.stderr)
        return 2
    from cytvdn_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if "--full" in argv:
        out = os.path.join(REPO, "chiprun_out", "bench_detail.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        run_full(dev.device_kind, out)
        print(f"# detail written to {out}", file=sys.stderr)

    shape = next(s for s in CONFIGS if _fits(s))
    value = _measure(shape, ITERS)
    baseline, prov = _reference_baseline()
    print(json.dumps({
        "metric": "voxel_updates_per_sec_4d_fista",
        "value": value,
        "unit": "voxel-updates/s",
        "vs_baseline": value / (baseline * 64.0),
        "baseline": f"{prov}, x64 (linear 64-thread bound)",
        "headline_shape": "x".join(map(str, shape)),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
