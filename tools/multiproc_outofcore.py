"""Multi-host out-of-core e2e: N real processes (jax.distributed over
localhost, gloo — the same path a cluster takes over its network), each owning an
axis-0 row range of the host-resident state and streaming its own slabs
while sharding each resident slab over its local virtual devices.

Checks, against a single-process IN-CORE run of the same schedule:

- stitched recon from the per-process row ranges matches (the margins'
  light cone + the once-per-sweep pre-sweep band exchange are exact);
- b_norm/delta sweep-final traces match (allgather-summed partials);
- (--checkpoint) a REAL kill of every process right after a checkpoint
  generation lands, followed by a resume pass, reproduces the
  uninterrupted result bit-for-bit.

Reference analog: the MPI ranks' row-range ownership (reference
cyTVDN/mpi.py:130-153) — which has no temporal blocking, no metrics and
no resume (reference README.md:22-34, SURVEY §5).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

SHAPE = (17, 8, 32)  # odd rows: uneven per-process ranges (--rows resizes)
ITERS = (4, 2)
K = 2
MU = 1.0


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


def _rows(n0: int, nproc: int, pid: int):
    # the PRODUCTION partition policy — the same function the CLI uses,
    # so the e2e's stitch always matches the run under test
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cytvdn_tpu.solver.outofcore import process_row_range

    return process_row_range(n0, nproc, pid)


def child(args) -> int:
    _force_cpu(args.local_devices)
    import jax

    if args.cli:
        # the CLI joins the runtime itself (init_distributed), reads only
        # its own rows lazily from the EMD, and process 0 writes the one
        # output file — the full `cytv --out-of-core` multi-host launch
        os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{args.port}"
        os.environ["JAX_NUM_PROCESSES"] = str(args.nproc)
        os.environ["JAX_PROCESS_ID"] = str(args.pid)
        from cytvdn_tpu.cli import main

        work = args.workdir
        return main([
            "-i", f"{work}/noisy.emd", "-o", f"{work}/denoised.emd",
            "-d", "3", "-f", "1", "-n", str(ITERS[0]), str(ITERS[1]),
            "-m", str(MU), "--out-of-core", str(args.slabs),
            "--temporal", str(K), "--shard", str(args.local_devices),
        ] + (["--lossy-duals", "1"] if args.lossy else []))

    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc, process_id=args.pid)

    import cytvdn_tpu.solver.outofcore as O
    from cytvdn_tpu.config import SolverOptions

    work = args.workdir
    cube = np.load(f"{work}/noisy.npy")
    ref = np.load(f"{work}/ref.npy")
    g0, g1 = _rows(cube.shape[0], args.nproc, args.pid)
    opts = SolverOptions(ndim=3, iterations_fista=ITERS[0],
                         iterations_unacc=ITERS[1], calculate_mse=True,
                         lossy_duals=bool(args.lossy))
    kw = {}
    if args.checkpoint:
        kw = dict(checkpoint_path=f"{work}/ooc.ck", checkpoint_every=2,
                  resume=True)
        if args.die_after_save:
            # kill THIS process right after a full checkpoint generation
            # at/after --die-at-iter exists everywhere (the hook runs
            # post-barrier) — a real crashed-process cycle, not a simulated
            # one. --die-at-iter > first lets the resume pass make
            # progress before the SECOND kill (double-kill cycles).
            die_at = args.die_at_iter
            O._POST_CKPT_HOOK = (
                lambda it: os._exit(17) if it >= die_at else None)
        elif args.stop_after_save:
            # this process is NOT the crash victim: it exits at the same
            # generation with a distinct code, simulating the launcher
            # tearing down the surviving ranks after a rank loss (what
            # SLURM/mpirun do when one rank dies)
            die_at = args.die_at_iter
            O._POST_CKPT_HOOK = (
                lambda it: os._exit(18) if it >= die_at else None)
    out = O.solve_outofcore_multihost(
        np.ascontiguousarray(cube[g0:g1]),
        np.full(3, 1.0 / (MU / 16.0), np.float32),
        np.full(3, 1 / 16.0, np.float32),
        opts, args.slabs, K, global_rows=(g0, g1, cube.shape[0]),
        shard_w=args.local_devices,
        reference_local=np.ascontiguousarray(ref[g0:g1]), **kw)
    np.save(f"{work}/rows{args.pid}.npy", out["recon"])
    if args.pid == 0:
        np.save(f"{work}/traces.npy",
                np.stack([out["b_norm"], out["delta"]]))
        np.save(f"{work}/mse.npy", out["mse"])
    return 0


def _expected(noisy: np.ndarray, ref: np.ndarray, lossy: bool):
    """Single-process in-core run (same schedule, sweep-final trace
    indices will be compared)."""
    _force_cpu(1)
    from cytvdn_tpu import denoise3D

    mu = np.full(3, MU, np.float32)
    return denoise3D(noisy, mu, iterations=ITERS, FISTA=True, quiet=True,
                     reference_data=ref, lossy_duals=lossy)


def parent(args) -> int:
    work = args.keep or tempfile.mkdtemp(prefix="cytv_mpooc_")
    os.makedirs(work, exist_ok=True)
    shape = (args.rows,) + SHAPE[1:]
    rng = np.random.default_rng(11)
    noisy = (rng.standard_normal(shape) * 0.4 + 1.5).astype(np.float32)
    ref = (rng.standard_normal(shape) * 0.2 + 1.5).astype(np.float32)
    np.save(f"{work}/noisy.npy", noisy)
    np.save(f"{work}/ref.npy", ref)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    expected = _expected(noisy, ref, args.lossy)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if args.no_shared_fs:
        # force the CLI's chunked proc-0 gather output (the non-shared-FS
        # fallback) instead of the concurrent per-process row writes
        env["CYTV_NO_SHARED_FS"] = "1"

    if args.cli:
        from cytvdn_tpu.io.emd import write_emd

        write_emd(f"{work}/noisy.emd", noisy)

    def spawn(port, victim=None, die_at_iter=0):
        def kill_flags(pid):
            if victim is None:
                return []
            base = ["--die-at-iter", str(die_at_iter)]
            if victim == "all" or pid == victim:
                return ["--die-after-save"] + base
            return ["--stop-after-save"] + base

        return [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--pid", str(pid), "--nproc", str(args.nproc),
             "--port", str(port), "--workdir", work,
             "--local-devices", str(args.local_devices),
             "--slabs", str(args.slabs), "--rows", str(args.rows)]
            + (["--checkpoint"] if args.checkpoint else [])
            + (["--cli"] if args.cli else [])
            + (["--lossy"] if args.lossy else [])
            + kill_flags(pid),
            env=env,
        ) for pid in range(args.nproc)]

    def kill_pass(victim, die_at_iter):
        """One crashed-process cycle: the victim os._exit(17)s right after
        the first complete checkpoint generation at/after die_at_iter;
        the other ranks exit 18 at the same generation (launcher
        teardown after a rank loss)."""
        procs = spawn(args.port, victim=victim, die_at_iter=die_at_iter)
        rcs = [p.wait(timeout=600) for p in procs]
        if victim == "all":
            ok = all(rc == 17 for rc in rcs)
        else:
            ok = all(rc == (17 if pid == victim else 18)
                     for pid, rc in enumerate(rcs))
        if not ok:
            print(f"FAIL: kill pass (victim {victim}, "
                  f"die_at_iter {die_at_iter}) exit codes {rcs}")
        args.port += 1  # fresh coordinator for the next pass
        return ok

    interrupted = False
    kills = 0
    if args.checkpoint:
        victim1 = "all" if args.die_pid is None else args.die_pid
        if not kill_pass(victim1, 0):
            return 1
        kills = 1
        interrupted = True
        if args.die_pid2 is not None:
            # double-kill: a SECOND, distinct process crashes at a LATER
            # checkpoint generation — the resume pass itself makes
            # progress, checkpoints, and dies; resume-of-a-resume must
            # still be bit-exact
            if not kill_pass(args.die_pid2, args.die_at_iter2):
                return 1
            kills = 2

    procs = spawn(args.port)
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        print(f"FAIL: child exit codes {rcs}")
        return 1

    if args.cli:
        from cytvdn_tpu.io.emd import read_emd

        got = read_emd(f"{work}/denoised.emd")
        err = float(np.max(np.abs(got - expected[0])))
        rel = err / float(np.max(np.abs(expected[0])))
        result = {
            "multiproc_outofcore_cli_e2e": "ok" if rel < 1e-6 else "FAIL",
            "nproc": args.nproc,
            "local_devices": args.local_devices,
            "recon_rel_err_vs_incore": rel,
            "output_path_mode": ("proc0_gather" if args.no_shared_fs
                                 else "concurrent_row_writes"),
        }
        print(json.dumps(result))
        _append_artifact(args.artifact, result)
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
        return 0 if rel < 1e-6 else 1

    got = np.concatenate([np.load(f"{work}/rows{p}.npy")
                          for p in range(args.nproc)])
    err = float(np.max(np.abs(got - expected[0])))
    rel = err / float(np.max(np.abs(expected[0])))
    # sweep-final traces vs the in-core per-iteration traces
    traces = np.load(f"{work}/traces.npy")
    n_f, n_u = ITERS
    finals = [i - 1 for i in range(K, n_f + 1, K)] \
        + [n_f + i - 1 for i in range(K, n_u + 1, K)]
    if n_f % K:
        finals.append(n_f - 1)
    if n_u % K:
        finals.append(n_f + n_u - 1)
    finals = sorted(set(finals))
    tr_rel = max(
        float(np.max(np.abs(traces[0][finals] - expected[1][finals])
                     / np.maximum(np.abs(expected[1][finals]), 1e-30))),
        float(np.max(np.abs(traces[1][finals] - expected[2][finals])
                     / np.maximum(np.abs(expected[2][finals]), 1e-30))),
    )
    # per-sweep SSE vs the in-core per-iteration trace (mse[i+1] records
    # the SSE after iteration i in both layouts)
    mse = np.load(f"{work}/mse.npy")
    mslots = [0] + [f + 1 for f in finals]
    mse_rel = float(np.max(
        np.abs(mse[mslots] - expected[3][mslots])
        / np.maximum(np.abs(expected[3][mslots]), 1e-30)))
    result = {
        "multiproc_outofcore_e2e": "ok"
        if rel < 1e-6 and tr_rel < 1e-4 and mse_rel < 1e-4 else "FAIL",
        "nproc": args.nproc,
        "local_devices": args.local_devices,
        "temporal_k": K,
        "n_slabs_per_process": args.slabs,
        "rows": args.rows,
        "lossy_duals": bool(args.lossy),
        "recon_rel_err_vs_incore": rel,
        "trace_rel_err_vs_incore": tr_rel,
        "mse_rel_err_vs_incore": mse_rel,
        "checkpoint_cycle": bool(args.checkpoint),
        "killed_after_first_generation": interrupted,
        "kill_cycles": kills,
        "band_exchange": "neighbor_ppermute",
    }
    if args.checkpoint and args.die_pid is not None:
        result["killed_pid"] = args.die_pid
        result["interior_kill"] = 0 < args.die_pid < args.nproc - 1
    if args.checkpoint and args.die_pid2 is not None:
        result["killed_pid2"] = args.die_pid2
        result["double_kill_distinct"] = args.die_pid2 != args.die_pid
    print(json.dumps(result))
    _append_artifact(args.artifact, result)
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if result["multiproc_outofcore_e2e"] == "ok" else 1


def _append_artifact(path, result):
    if not path:
        return
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.append(result)
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--child", action="store_true")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--pid", type=int, default=0)
    p.add_argument("--port", type=int,
                   default=24000 + (os.getpid() * 13) % 9000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--checkpoint", action="store_true",
                   help="kill every process after the first checkpoint "
                        "generation, then resume")
    p.add_argument("--die-after-save", action="store_true")
    p.add_argument("--stop-after-save", action="store_true")
    p.add_argument("--die-pid", type=int, default=None,
                   help="with --checkpoint: only this pid crashes "
                        "(os._exit 17); the others exit 18 at the same "
                        "generation (launcher teardown). Default: all "
                        "pids crash")
    p.add_argument("--die-pid2", type=int, default=None,
                   help="with --checkpoint: run a SECOND kill cycle — "
                        "this pid crashes at the first checkpoint "
                        "generation at/after --die-at-iter2 during the "
                        "first resume pass")
    p.add_argument("--die-at-iter", type=int, default=0,
                   help="(child) crash at the first checkpoint "
                        "generation whose iteration >= this")
    p.add_argument("--die-at-iter2", type=int, default=4,
                   help="iteration threshold for the --die-pid2 cycle")
    p.add_argument("--slabs", type=int, default=2,
                   help="slabs per process (host-resident streaming)")
    p.add_argument("--rows", type=int, default=SHAPE[0],
                   help="axis-0 rows of the test cube")
    p.add_argument("--lossy", action="store_true",
                   help="run with lossy_duals (bf16 host-resident shadow "
                        "duals); compared against the in-core LOSSY run")
    p.add_argument("--cli", action="store_true",
                   help="drive the whole flow through the cytv CLI "
                        "(lazy per-host row reads; concurrent row-write "
                        "or proc-0 gather EMD output)")
    p.add_argument("--no-shared-fs", action="store_true",
                   help="with --cli: force the proc-0 gather output path "
                        "(simulate hosts without a shared filesystem)")
    p.add_argument("--keep", default=None, metavar="WORKDIR")
    p.add_argument("--artifact", default=None, metavar="JSON")
    return p


if __name__ == "__main__":
    a = build_parser().parse_args()
    if a.cli and a.checkpoint:
        print("error: --cli does not drive the checkpoint/kill cycle "
              "(use the library mode for kill-resume; the CLI flags are "
              "covered by the single-host CLI tests)", file=sys.stderr)
        sys.exit(2)
    sys.exit(child(a) if a.child else parent(a))
