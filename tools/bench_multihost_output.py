"""Measure the two multihost out-of-core OUTPUT paths against each other:

- ``proc0_gather``: rows stream to process 0 in slab-sized chunks over
  the collective fabric (``process_allgather`` — every chunk reaches
  EVERY process) and process 0 region-writes the one EMD file. Works
  with no shared filesystem; wire bytes ≈ nproc × cube.
- ``concurrent_row_writes``: every process writes its OWN rows into the
  one EMD file on a shared filesystem via raw-offset positioned POSIX
  writes (truly concurrent — no HDF5 writer lock; the reference's
  analog is parallel-HDF5 ``write_direct``, reference
  cyTVDN/mpi.py:444-498). Wire bytes: ZERO. The run also times the
  HDF5 token-ring fallback (``CYTV_NO_RAW_WRITES=1`` — serialized by
  process): on one host the two coincide (page-cache memcpy on shared
  cores), on a cluster the ring's writer wall is sum-of-processes while the
  raw path's is max-of-processes.

Spawns N real processes (jax.distributed over localhost, gloo), times
both writers on the same data, and appends an ``output_bench`` row to
the ``--artifact`` JSON file. On one host the wire advantage cannot show
(loopback ≈ memcpy), so the row also records the analytic network-byte
counts at the config-5 geometry — the quantity that separates the paths
on a cluster.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _rows(n0, nproc, pid):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cytvdn_tpu.solver.outofcore import process_row_range

    return process_row_range(n0, nproc, pid)


def child(args) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc, process_id=args.pid)
    from jax.experimental import multihost_utils

    from cytvdn_tpu.io.emd import (
        read_emd,
        write_emd_rows_gathered,
        write_emd_rows_multihost,
    )

    shape = tuple(args.shape)
    g0, g1 = _rows(shape[0], args.nproc, args.pid)
    rng = np.random.default_rng(100 + args.pid)
    rows = rng.standard_normal((g1 - g0,) + shape[1:]).astype(np.float32)
    work = args.workdir
    timings = {}

    # --- concurrent per-process row writes (shared FS, raw offsets) ---
    multihost_utils.sync_global_devices("t0")
    t0 = time.perf_counter()
    out_p = write_emd_rows_multihost(
        f"{work}/concurrent.emd", shape, np.float32, rows, (g0, g1))
    multihost_utils.sync_global_devices("t1")
    timings["concurrent_row_writes_s"] = time.perf_counter() - t0
    assert out_p is not None

    # --- the HDF5 token-ring fallback (serialized-by-process writes) ---
    os.environ["CYTV_NO_RAW_WRITES"] = "1"
    try:
        multihost_utils.sync_global_devices("t1r")
        t0 = time.perf_counter()
        out_r = write_emd_rows_multihost(
            f"{work}/ring.emd", shape, np.float32, rows, (g0, g1))
        multihost_utils.sync_global_devices("t2r")
        timings["token_ring_writes_s"] = time.perf_counter() - t0
        assert out_r is not None
    finally:
        del os.environ["CYTV_NO_RAW_WRITES"]

    # --- chunked proc-0 gather (the no-shared-FS fallback) — the ONE
    # shared implementation the CLI also calls (io/emd.py) ---
    ch = max(1, -(-shape[0] // (args.nproc * 2)))
    multihost_utils.sync_global_devices("t2")
    t0 = time.perf_counter()
    write_emd_rows_gathered(f"{work}/gathered.emd", shape, np.float32,
                            rows, (g0, g1), ch)
    multihost_utils.sync_global_devices("t3")
    timings["proc0_gather_s"] = time.perf_counter() - t0

    if args.pid == 0:
        a = read_emd(f"{work}/concurrent.emd")
        r = read_emd(f"{work}/ring.emd")
        b = read_emd(f"{work}/gathered.emd")
        timings["outputs_identical"] = bool(
            np.array_equal(a, b) and np.array_equal(a, r))
        with open(f"{work}/timings.json", "w") as f:
            json.dump(timings, f)
    return 0


def parent(args) -> int:
    import shutil

    work = tempfile.mkdtemp(prefix="cytv_outbench_")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--pid", str(pid), "--nproc", str(args.nproc),
         "--port", str(args.port), "--workdir", work,
         "--shape", *map(str, args.shape)],
        env=env) for pid in range(args.nproc)]
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        print(f"FAIL: exit codes {rcs}", file=sys.stderr)
        return 1
    with open(f"{work}/timings.json") as f:
        t = json.load(f)
    cube_b = int(np.prod(args.shape)) * 4
    # wire-byte model at THIS geometry and at the config-5 deployment
    # geometry (512^2 x 256^2 f32 over 4 hosts): allgather delivers every
    # chunk to every process → ~nproc x cube received per run; the
    # concurrent writer moves nothing
    cfg5_bytes = 512 * 512 * 256 * 256 * 4
    result = {
        "output_bench": True,
        "nproc": args.nproc,
        "shape": list(args.shape),
        "cube_mib": round(cube_b / 2**20, 1),
        **{k: round(v, 4) if isinstance(v, float) else v
           for k, v in t.items()},
        "speedup_concurrent_vs_gather": round(
            t["proc0_gather_s"] / t["concurrent_row_writes_s"], 2),
        "wire_bytes_gather_this_shape": cube_b * args.nproc,
        "wire_bytes_concurrent": 0,
        "note": ("same-host measurement (loopback ≈ memcpy) — on a "
                 "cluster the gather additionally pays network bytes for ~nproc x cube "
                 f"({args.nproc * cfg5_bytes / 2**30:.0f} GiB at the "
                 "config-5 geometry over 4 hosts) while the concurrent "
                 "writer pays zero; raw-offset pwrite writers run truly "
                 "concurrently (writer wall = max over processes) where "
                 "the token-ring fallback serializes (sum over "
                 "processes) — indistinguishable on one shared-core "
                 "host, ~nproc x apart on a cluster; CLI auto-selects "
                 "concurrent when the output filesystem is shared "
                 "(reference MPI-IO precondition, mpi.py:115,447)"),
    }
    print(json.dumps(result))
    if args.artifact:
        existing = []
        if os.path.exists(args.artifact):
            with open(args.artifact) as f:
                existing = json.load(f)
        existing.append(result)
        with open(args.artifact, "w") as f:
            json.dump(existing, f, indent=2)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--child", action="store_true")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--pid", type=int, default=0)
    p.add_argument("--port", type=int,
                   default=31000 + (os.getpid() * 7) % 9000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--shape", type=int, nargs="+",
                   default=[64, 64, 64, 64])
    p.add_argument("--artifact", default=None)
    a = p.parse_args()
    sys.exit(child(a) if a.child else parent(a))
