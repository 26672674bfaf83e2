"""True multi-process end-to-end exercise of the distributed stack.

The reference's distributed story is exercised by running real MPI ranks
(reference local_MPI_example.sh:11-20); the JAX equivalent is N Python
processes joined by ``jax.distributed`` — here N=2 processes x 4 virtual
CPU devices each, collectives over gloo, which is exactly the multi-host
code path a GPU cluster takes (process group + global mesh), minus the
hardware.

What one run covers, end to end:

- ``jax.distributed.initialize`` via ``cytvdn_tpu.parallel.distributed
  .init_distributed`` (env-var path, as the ``cytv`` console script uses);
- the full CLI pipeline in every process (``cytv -i ... --shard ...``);
- per-process lazy input reads (``load_sharded_array``: each process reads
  only its devices' blocks from the HDF5 file);
- the shard_map solver over a global 8-device mesh spanning both
  processes — halo ``ppermute``s and ``psum`` reductions cross the
  process boundary;
- multi-process EMD output (per-process part files + stitch into ONE
  self-contained EMD by process 0);
- optional: chunked checkpoint/resume with per-process sharded state
  (``--checkpoint-every``), including a kill-and-resume cycle.

Parent mode (default) builds the input, computes the expected result
single-process, spawns the children, and verifies the stitched output
matches to float32 round-off.

Usage: python tools/multiproc_e2e.py [--nproc 2] [--keep WORKDIR]
Child mode (internal): python tools/multiproc_e2e.py --child ...
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

SHAPE = (16, 16, 6, 8)
ITERS = (3, 2)
MU = 1.0
SHARD = "2,4,1,1"


def _force_cpu(n_local_devices: int):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{n_local_devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")


def child(args) -> int:
    _force_cpu(args.local_devices)
    # the CLI joins the runtime itself through init_distributed(), driven
    # by the same env vars a cluster launcher would set
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{args.port}"
    os.environ["JAX_NUM_PROCESSES"] = str(args.nproc)
    os.environ["JAX_PROCESS_ID"] = str(args.pid)

    from cytvdn_tpu.cli import main

    work = args.workdir
    argv = [
        "-i", f"{work}/noisy.emd", "-o", f"{work}/denoised.emd",
        "-m", str(MU), "-n", str(ITERS[0]), str(ITERS[1]), "-f", "1",
        "-v", "1",
    ]
    # an axis-0 mesh puts a shard seam ON the process boundary: the
    # one-row halos ppermute across it
    argv += ["--shard", "8,1,1,1" if args.axis0 else SHARD]
    if args.checkpoint:
        argv += ["--checkpoint", f"{work}/state.ck",
                 "--checkpoint-every", "2", "--resume", "1"]
    rc = main(argv)

    import jax

    assert jax.process_count() == args.nproc, jax.process_count()
    return rc


def _expected(noisy: np.ndarray) -> np.ndarray:
    """Single-process reference result (1-device mesh ≡ plain solver)."""
    _force_cpu(1)
    from cytvdn_tpu import denoise4D

    mu = np.full(4, MU, dtype=np.float32)
    recon = denoise4D(noisy, mu, iterations=ITERS, FISTA=True,
                      quiet=True)[0]
    return recon


def parent(args) -> int:
    work = args.keep or tempfile.mkdtemp(prefix="cytv_mp_")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(7)
    noisy = (rng.standard_normal(SHAPE) * 0.3 + 1.5).astype(np.float32)

    # input as EMD so the children exercise the lazy HDF5 block reads
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cytvdn_tpu.io.emd import read_emd, write_emd

    write_emd(f"{work}/noisy.emd", noisy)
    expected = _expected(noisy)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # children set their own device count
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")

    def spawn(port):
        return [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--pid", str(pid), "--nproc", str(args.nproc),
             "--port", str(port), "--workdir", work,
             "--local-devices", str(8 // args.nproc)]
            + (["--checkpoint"] if args.checkpoint else [])
            + (["--axis0"] if args.axis0 else []),
            env=env,
        ) for pid in range(args.nproc)]

    result_sink = args.artifact
    interrupted = False
    if args.checkpoint:
        # pass 1: run until the first multi-process checkpoint generation
        # (master + all parts) is on disk, then kill every child — the
        # "crashed cluster job" the reference cannot recover from (SURVEY §5)
        import time

        procs = spawn(args.port)
        ck_files = [f"{work}/state.ck"] + [
            f"{work}/state.ck.p{p}" for p in range(1, args.nproc)]
        deadline = time.time() + 590
        while time.time() < deadline:
            if all(p.poll() is not None for p in procs):
                break  # finished before we could interrupt — still fine
            if all(os.path.exists(f) for f in ck_files):
                time.sleep(0.5)  # let the atomic renames settle everywhere
                for p in procs:
                    p.kill()
                interrupted = True
                break
            time.sleep(0.2)
        for p in procs:
            p.wait(timeout=60)
        args.port += 1  # fresh coordinator port for the resume pass

    procs = spawn(args.port)
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        print(f"FAIL: child exit codes {rcs}")
        return 1

    out = read_emd(f"{work}/denoised.emd")
    assert out.shape == SHAPE, out.shape
    err = float(np.max(np.abs(out - expected)))
    rel = err / float(np.max(np.abs(expected)))
    # one self-contained file: no dangling part files after solid stitch
    parts = [p for p in os.listdir(work) if ".part" in p]
    result = {
        "multiproc_e2e": "ok" if rel < 1e-6 else "FAIL",
        "nproc": args.nproc,
        "global_devices": 8,
        "shard": "8,1,1,1" if args.axis0 else SHARD,
        "max_abs_err_vs_single_process": err,
        "rel_err": rel,
        "leftover_part_files": parts,
        "checkpoint_cycle": bool(args.checkpoint),
        "interrupted_mid_run": interrupted,
    }
    print(json.dumps(result))
    if result_sink:
        existing = []
        if os.path.exists(result_sink):
            with open(result_sink) as f:
                existing = json.load(f)
        existing.append(result)
        with open(result_sink, "w") as f:
            json.dump(existing, f, indent=2)
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if rel < 1e-6 and not parts else 1


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--child", action="store_true")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--pid", type=int, default=0)
    p.add_argument("--port", type=int,
                   default=20000 + (os.getpid() * 7) % 20000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument("--checkpoint", action="store_true",
                   help="exercise chunked checkpointed execution")
    p.add_argument("--axis0", action="store_true",
                   help="split axis 0 over all 8 devices, so a shard "
                        "seam lies on the process boundary")
    p.add_argument("--keep", default=None, metavar="WORKDIR",
                   help="use (and keep) WORKDIR instead of a temp dir")
    p.add_argument("--artifact", default=None, metavar="JSON",
                   help="append the result record to this JSON file")
    return p


if __name__ == "__main__":
    a = build_parser().parse_args()
    sys.exit(child(a) if a.child else parent(a))
