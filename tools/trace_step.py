"""Device-time anatomy of the solver's iteration on the GPU, per backend.

    python tools/trace_step.py [--shapes 256,256,72,72 256,256,2048]
                               [--backends jax pallas] [--iters 10]
                               [--plain]
                               [--out chiprun_out/trace_step.json]

For each shape (float32, Jia-Zhao, anisotropic; FISTA, or unaccelerated
with ``--plain``) and backend (``jax``:
the XLA ops path; ``pallas``: the two-pass GPU step) this reports:

- ``bytes_per_iter`` / ``traversals``: for ``jax``, the bytes XLA's cost
  analysis charges one compiled ``iteration_step``; for ``pallas``, the
  two-pass model (5n+4 traversals, ``utils/perf.py``), since the cost
  analysis does not see into a kernel. ``traversals`` is that over one
  cube-size array, beside the one-pass floor (4n+3);
- ``kernels_per_iter`` and ``device_s_per_iter``: GPU kernel events and
  their summed duration in a ``jax.profiler`` trace of a steady
  ``iters``-iteration solve, divided by ``iters``; ``top_kernels`` lists
  the kernels by device time;
- ``busy_share``: the union of kernel intervals over the traced window;
- ``achieved_bytes_per_s``: ``bytes_per_iter / device_s_per_iter``, beside
  the card's published peak and a device copy measured in the same
  process (``copy_bytes_per_s``);
- ``e2e``: wall time of the public API (``denoise4D``/``denoise3D``, numpy
  in and out) and of the jitted solver on a device-resident cube, run in
  the order jax, pallas, pallas, jax after a warm-up of each.

Needs the GPU: exits non-zero on any other backend.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _device_events(xplane_path):
    """(name, start_ns, end_ns) of every kernel on the GPU stream lines,
    plus a per-line summary for inspection."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    events, lines = [], []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines.append({"plane": plane.name, "line": line.name,
                          "events": len(evs),
                          "sum_s": sum(e.duration_ns for e in evs) * 1e-9})
            if not line.name.startswith("Stream"):
                continue
            events += [(e.name, e.start_ns, e.end_ns) for e in evs]
    return events, lines


def _union_ns(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _copy_bandwidth(nbytes=4 << 30, reps=5):
    import jax
    import jax.numpy as jnp

    x = jnp.ones((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda v: v * 1.0001)
    f(x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = f(x)
    y.block_until_ready()
    return 2 * nbytes * reps / (time.perf_counter() - t0)


def _opts(ndim, iters, backend, fista):
    from cytvdn_tpu.config import Backend, SolverOptions

    return SolverOptions(ndim=ndim, iterations_fista=iters if fista else 0,
                         iterations_unacc=0 if fista else iters,
                         backend=Backend(backend))


def anatomy(shape, iters, backend, fista=True):
    import jax
    import jax.numpy as jnp

    from cytvdn_tpu.solver.engine import iteration_step, run_solver
    from cytvdn_tpu.utils.perf import traversals_per_iteration

    ndim = len(shape)
    vox = int(np.prod(shape))
    opts = _opts(ndim, iters, backend, fista)
    li = jnp.full((ndim,), 32.0 if ndim == 4 else 16.0, jnp.float32)
    lm = jnp.full((ndim,), 1.0 / 32.0 if ndim == 4 else 1.0 / 16.0,
                  jnp.float32)

    sds = jax.ShapeDtypeStruct(shape, jnp.float32)
    step = jax.jit(lambda o, r, a, d, t, x, y: iteration_step(
        o, r, a, d, t, x, y, opts))
    compiled = step.lower(
        sds, sds, (sds,) * ndim, (sds,) * ndim if fista else None,
        jax.ShapeDtypeStruct((), jnp.float32) if fista else None,
        li, lm).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla_bytes = float(cost.get("bytes accessed", float("nan")))
    del compiled
    bytes_per_iter = xla_bytes if backend == "jax" else \
        4.0 * vox * traversals_per_iteration(ndim, fista, "two_pass")

    cube = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32)
                   * 0.3 + 1.0)(jax.random.key(0))
    solve = jax.jit(lambda c: run_solver(c, li, lm, opts)["delta"])
    solve(cube).block_until_ready()  # compile + warm
    t0 = time.perf_counter()
    solve(cube).block_until_ready()
    wall = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "chiprun_out")) \
            as tdir:
        with jax.profiler.trace(tdir):
            solve(cube).block_until_ready()
        path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                         recursive=True)[0]
        events, lines = _device_events(path)
    per_kernel = {}
    for name, s, e in events:
        c, t = per_kernel.get(name, (0, 0.0))
        per_kernel[name] = (c + 1, t + (e - s) * 1e-9)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    dev_s = sum(t for _, t in per_kernel.values())
    window = (max(e for _, _, e in events) - min(s for _, s, _ in events)) \
        if events else 0.0
    busy = _union_ns([(s, e) for _, s, e in events])
    per_iter = dev_s / iters
    return {
        "shape": list(shape), "backend": backend, "fista": fista,
        "iterations": iters,
        "bytes_per_iter": bytes_per_iter,
        "xla_cost_bytes_per_iter": xla_bytes,
        "traversals": bytes_per_iter / (4.0 * vox),
        "model_traversals": {
            m: traversals_per_iteration(ndim, fista, m)
            for m in ("one_pass", "two_pass")},
        "kernels_per_iter": len(events) / iters,
        "device_s_per_iter": per_iter,
        "wall_s_per_iter": wall / iters,
        "busy_share": busy / window if window else None,
        "achieved_bytes_per_s": bytes_per_iter / per_iter
        if per_iter else None,
        "voxel_updates_per_s_device": vox / per_iter if per_iter else None,
        "voxel_updates_per_s_wall": vox * iters / wall,
        "top_kernels": [{"name": n[:160], "count": c, "sum_s": t}
                        for n, (c, t) in top],
        "trace_lines": lines,
    }


def end_to_end(shape, iters, backends, fista=True):
    """Wall seconds of the public API and of the device-resident solver,
    per backend, in the order b0, b1, b1, b0 after one warm-up each."""
    import jax
    import jax.numpy as jnp

    import cytvdn_tpu as tv
    from cytvdn_tpu.solver.engine import run_solver

    ndim = len(shape)
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(shape, dtype=np.float32)
    cube *= np.float32(0.3)
    cube += np.float32(1.0)
    mu = np.full(ndim, 1.0, np.float32)
    fn = tv.denoise4D if ndim == 4 else tv.denoise3D
    li = jnp.full((ndim,), 32.0 if ndim == 4 else 16.0, jnp.float32)
    lm = 1.0 / li
    dev_cube = jnp.asarray(cube)
    solvers = {b: jax.jit(lambda c, o=_opts(ndim, iters, b, fista):
                          run_solver(c, li, lm, o)["recon"])
               for b in backends}

    def api(b):
        t0 = time.perf_counter()
        fn(cube, mu, iterations=iters, FISTA=fista, quiet=True,
           backend=b)
        return time.perf_counter() - t0

    def device(b):
        t0 = time.perf_counter()
        solvers[b](dev_cube).block_until_ready()
        return time.perf_counter() - t0

    for b in backends:
        api(b)
        device(b)
    order = list(backends) + list(reversed(backends))
    rec = {"order": order, "api_s": {b: [] for b in backends},
           "device_resident_s": {b: [] for b in backends}}
    for b in order:
        rec["api_s"][b].append(api(b))
        rec["device_resident_s"][b].append(device(b))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+",
                   default=["256,256,72,72", "256,256,2048"])
    p.add_argument("--backends", nargs="+", default=["jax", "pallas"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--plain", action="store_true",
                   help="unaccelerated schedule instead of FISTA")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "trace_step.json"))
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("error: trace_step needs the GPU", file=sys.stderr)
        return 2
    from cytvdn_tpu.utils.cache import enable_compile_cache
    from cytvdn_tpu.utils.perf import peak_bandwidth

    enable_compile_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    d = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    rec = {"device_kind": d.device_kind, "card": card,
           "copy_bytes_per_s": _copy_bandwidth(), "cells": []}
    for s in args.shapes:
        shape = tuple(int(v) for v in s.split(","))
        for backend in args.backends:
            cell = anatomy(shape, args.iters, backend, not args.plain)
            rec["cells"].append(cell)
            brief = {k: v for k, v in cell.items()
                     if k not in ("top_kernels", "trace_lines")}
            print(json.dumps(brief), flush=True)
        e2e = {"shape": list(shape),
               **end_to_end(shape, args.iters, args.backends,
                            not args.plain)}
        rec.setdefault("e2e", []).append(e2e)
        print(json.dumps(e2e), flush=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    rec["peak_bytes_per_s"] = peak_bandwidth(d.device_kind)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("device_kind", "card",
                                          "peak_bytes_per_s",
                                          "copy_bytes_per_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
