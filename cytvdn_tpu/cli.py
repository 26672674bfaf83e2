"""Command-line launcher — the reference's ``cyTVMPI`` console script
rebuilt on JAX (reference cyTVDN/mpi.py:27-501, flag surface
mpi.py:47-76).

Same flags: ``-i/--input``, ``-o/--output``, ``-d/--dimensions``,
``-f/--fista``, ``-n/--niterations`` (one value, or two for the hybrid
schedule), ``-L/--lambda``, ``-m/--mu``, ``-v/--verbose``. Additions:
``--shard`` (device-mesh tiling, 'auto' = edge-minimizing partitioner over
the scan axes like the reference's mpi.py:130-153), ``--backend``,
``--bc-mode``, ``--stop`` (the stopping criterion the reference MPI path
lacks, README.md:34), ``--checkpoint``/``--checkpoint-every`` and
``--resume`` (periodic solver-state checkpointing; the reference has none,
SURVEY.md §5).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def str2bool(v) -> bool:
    # same accepted spellings as the reference (reference mpi.py:37-45)
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cytv",
        description="TV denoising of 3D/4D microscopy datacubes on JAX "
                    "devices.",
    )
    p.add_argument("-i", "--input", type=os.path.abspath, required=True,
                   help="input file (.h5/.emd/.dm3/.dm4/.npy)")
    p.add_argument("-o", "--output", type=os.path.abspath, required=True,
                   help="output file (written as EMD v0.7, extension "
                        "forced to .emd)")
    p.add_argument("-d", "--dimensions", type=int, choices=(3, 4),
                   help="number of dimensions (inferred from input if "
                        "omitted)")
    p.add_argument("-f", "--fista", type=str2bool, default=None,
                   help="use FISTA acceleration (0 or 1)")
    p.add_argument("-n", "--niterations", type=int, nargs="+", default=None,
                   help="iterations (two values = hybrid FISTA+unacc); "
                        "required unless --preset supplies it")
    p.add_argument("-L", "--lambda", dest="lam", type=float, nargs="+",
                   help="per-axis lambda (default mu/32 in 4D, mu/16 in 3D)")
    p.add_argument("-m", "--mu", type=float, nargs="+", required=True,
                   help="per-axis mu")
    p.add_argument("-v", "--verbose", type=str2bool, default=True)
    p.add_argument("--preset", default=None,
                   help="named solver preset (cytvdn_tpu.presets, e.g. "
                        "'eels3d', 'stem4d-converged'); explicit flags "
                        "override preset values")
    p.add_argument("--bc-mode", type=int, default=None, choices=(0, 1, 2),
                   help="boundary conditions: 0 periodic, 1 mirror, "
                        "2 Jia-Zhao (default)")
    p.add_argument("--stop", type=float, default=None,
                   help="stopping_relative_change (e.g. 0.05)")
    p.add_argument("--iso-r", type=str2bool, default=None,
                   help="half-isotropic on axes 0,1 (4D only)")
    p.add_argument("--iso-q", type=str2bool, default=None,
                   help="half-isotropic on axes 2,3 (4D only)")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "jax", "pallas", "cpp"),
                   help="auto: the hand-written GPU step where it covers "
                        "the run on an NVIDIA GPU, else the XLA ops path; "
                        "jax: the XLA ops path; pallas: the GPU step, or "
                        "an error; cpp: native C++/OpenMP kernels on the "
                        "CPU host")
    p.add_argument("--shard", default=None,
                   help="'auto' or comma-separated per-axis tile counts "
                        "(e.g. 2,4,1,1) to run over a device mesh")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for periodic state saves")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save solver state every N iterations")
    p.add_argument("--resume", type=str2bool, default=False,
                   help="resume from --checkpoint if it exists")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a jax.profiler device trace into LOGDIR")
    p.add_argument("--out-of-core", type=int, default=0, metavar="N_SLABS",
                   help="stream the cube through the device in N slabs with "
                        "host-resident state (for cubes whose state exceeds "
                        "device memory; Jia-Zhao anisotropic float32 only)")
    p.add_argument("--temporal", type=int, default=1, metavar="K",
                   help="with --out-of-core: K iterations per slab "
                        "residency (temporal blocking; cuts host-device "
                        "traffic ~Kx; traces/early-stop at sweep "
                        "granularity)")
    p.add_argument("--lossy-duals", action="store_true",
                   help="LOSSY opt-in: store the FISTA shadow duals as "
                        "bfloat16 (half their memory traffic; the recon "
                        "drifts far beyond the 1e-5 reference-parity "
                        "budget). Jia-Zhao anisotropic float32 FISTA only")
    return p


def _apply_preset(args) -> bool:
    """Fill unset flags from ``--preset``; explicit flags always win
    (unset flags parse as None sentinels). Returns False on a missing
    ``-n`` with no preset to supply it."""
    if args.preset:
        from cytvdn_tpu.presets import get_preset

        pr = get_preset(args.preset)  # raises KeyError listing presets
        if args.niterations is None and "iterations" in pr:
            v = pr["iterations"]
            args.niterations = (list(v) if isinstance(v, (list, tuple))
                                else [v])
        if args.fista is None:
            args.fista = pr.get("FISTA")
        if args.bc_mode is None:
            args.bc_mode = pr.get("BC_mode")
        if args.stop is None:
            args.stop = pr.get("stopping_relative_change")
        if args.iso_r is None:
            args.iso_r = pr.get("isotropic_R")
        if args.iso_q is None:
            args.iso_q = pr.get("isotropic_Q")
    if args.niterations is None:
        return False
    # resolve remaining sentinels to the documented defaults
    args.fista = bool(args.fista)
    args.bc_mode = 2 if args.bc_mode is None else args.bc_mode
    args.iso_r = bool(args.iso_r)
    args.iso_q = bool(args.iso_q)
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        ok = _apply_preset(args)
    except KeyError as e:
        # unknown preset: same print-error-and-exit-2 convention as every
        # other argument failure (get_preset's message lists the presets)
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if not ok:
        print("error: -n/--niterations is required (or use a --preset "
              "that supplies it)", file=sys.stderr)
        return 2

    # join the multi-host runtime first (no-op on a single host; on a
    # cluster every host runs this same command — the analog of the
    # reference's one-MPI-rank-per-node launch, cori_MPI_example.sh:44)
    from cytvdn_tpu.parallel.distributed import init_distributed
    from cytvdn_tpu.utils.cache import enable_compile_cache

    multihost = init_distributed()
    enable_compile_cache()
    proc, n_proc = 0, 1
    if multihost:
        import jax

        proc, n_proc = jax.process_index(), jax.process_count()

    # rank-aware logging like the reference (head rank INFO, others quiet,
    # reference mpi.py:298-305); CYTV_LOG_ALL_PROCS=1 un-gates the rest
    verbose = args.verbose and (
        proc == 0 or os.environ.get("CYTV_LOG_ALL_PROCS"))
    tag = f"[cytv p{proc}]" if n_proc > 1 else "[cytv]"

    def log(msg):
        if verbose:
            print(f"{tag} {msg}", flush=True)

    if args.dtype == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)

    if n_proc > 1 and not args.shard:
        log("multi-host run without --shard: defaulting to --shard auto")
        args.shard = "auto"

    from cytvdn_tpu.io.loaders import load_input, open_input
    from cytvdn_tpu.io.emd import write_emd

    t0 = time.time()
    data_path = None
    ooc_multihost = bool(args.out_of_core) and n_proc > 1
    # single-host out-of-core needs the full cube host-resident (that is
    # the mode), so only mesh runs and MULTIHOST out-of-core open lazily
    lazy = ((args.shard and not args.out_of_core) or ooc_multihost)
    if lazy and args.dtype == "float32":
        # sharded float32 runs read per-shard blocks lazily (per-host on a
        # cluster — no process ever loads the full cube, like the reference's
        # memmap/MPI-IO opens, mpi.py:93-124); peek only at the shape here
        with open_input(args.input) as h:
            shape, in_dtype = h.shape, h.dtype
        data_path = args.input
        data = None
        log(f"opened {args.input} lazily: shape {shape}, {in_dtype}")
    else:
        data = load_input(args.input, dtype=np.dtype(args.dtype))
        shape = data.shape
        log(f"loaded {args.input}: shape {data.shape}, {data.dtype}, "
            f"{data.nbytes / 2**20:.1f} MiB in {time.time() - t0:.2f}s")

    ndim = args.dimensions or len(shape)
    if len(shape) != ndim:
        print(f"error: input is {len(shape)}D but -d {ndim} given",
              file=sys.stderr)
        return 2

    run_dtype = np.dtype(args.dtype)
    mu = np.asarray(args.mu, dtype=run_dtype)
    if mu.size == 1:
        mu = np.full(ndim, mu[0], dtype=run_dtype)
    lam = None
    if args.lam is not None:
        lam = np.asarray(args.lam, dtype=run_dtype)
        if lam.size == 1:
            lam = np.full(ndim, lam[0], dtype=run_dtype)

    iterations = (args.niterations[0] if len(args.niterations) == 1
                  else tuple(args.niterations[:2]))

    kwargs = dict(
        mu=mu,
        lam=lam,
        iterations=iterations,
        FISTA=bool(args.fista),
        stopping_relative_change=args.stop,
        BC_mode=args.bc_mode,
        # NB: `quiet` must be IDENTICAL on every process of a multi-host
        # run (it feeds the chunk-vs-single-shot progress decision, which
        # must not diverge across processes); rank-gating applies only to
        # the log lines above. Progress display itself is head-only.
        quiet=not args.verbose,
        backend=args.backend,
    )

    if args.temporal != 1 and not args.out_of_core:
        print("error: --temporal requires --out-of-core", file=sys.stderr)
        return 2
    if args.lossy_duals:
        if args.bc_mode != 2 or args.iso_r or args.iso_q \
                or args.dtype != "float32" or not args.fista:
            # `not args.fista` matters: without FISTA there ARE no
            # shadow duals — silently accepting the flag would let the
            # user believe they opted into the traffic saving
            print("error: --lossy-duals covers float32 Jia-Zhao "
                  "anisotropic FISTA runs only", file=sys.stderr)
            return 2
        kwargs["lossy_duals"] = True

    import contextlib

    from cytvdn_tpu.utils.log import profile_trace

    t0 = time.time()
    stack = contextlib.ExitStack()
    stack.enter_context(profile_trace(args.profile))
    if args.out_of_core:
        # out-of-core covers Jia-Zhao anisotropic float32 only and manages
        # its own state/devices: reject silently-ignored flag combinations
        # rather than computing something the user didn't ask for
        bad = []
        if args.bc_mode != 2:
            bad.append("--bc-mode")
        if args.iso_r or args.iso_q:
            bad.append("--iso-r/--iso-q")
        if args.backend != "auto":
            bad.append("--backend")
        shard_w = 1
        if args.shard:
            # out-of-core sharding: each resident slab split over W local
            # devices on axis 1 (the config-5 deployment shape)
            try:
                shard_w = int(args.shard) if args.shard != "auto" else 0
            except ValueError:
                bad.append("--shard (out-of-core takes a device COUNT or "
                           "'auto', not a per-axis tiling)")
        if args.dtype != "float32":
            bad.append("--dtype")
        if bad:
            print(f"error: --out-of-core does not support {', '.join(bad)} "
                  "(Jia-Zhao anisotropic float32)",
                  file=sys.stderr)
            return 2
        if ooc_multihost:
            # every host reads ONLY its own axis-0 rows (the reference's
            # per-rank memmap opens, mpi.py:93-124) and runs the
            # multihost solver; one boundary-band exchange per sweep
            from cytvdn_tpu.api import _validate_and_derive
            from cytvdn_tpu.config import (
                SolverOptions,
                normalize_iterations,
            )
            from cytvdn_tpu.solver.outofcore import (
                process_row_range,
                solve_outofcore_multihost,
            )

            g0, g1 = process_row_range(shape[0], n_proc, proc)
            with open_input(args.input) as h:
                local = np.ascontiguousarray(h.read_block(
                    (slice(g0, g1),) + (slice(None),) * (ndim - 1)),
                    dtype=np.float32)
            log(f"multihost out-of-core: rows [{g0}, {g1}) of "
                f"{shape[0]}, {n_proc} processes")
            local, _, _, lambda_inv, lam_mu = _validate_and_derive(
                local, mu, lam, ndim, 32.0 if ndim == 4 else 16.0)
            n_f, n_u = normalize_iterations(iterations, bool(args.fista))
            out_mh = solve_outofcore_multihost(
                local, lambda_inv, lam_mu,
                SolverOptions(ndim=ndim, iterations_fista=n_f,
                              iterations_unacc=n_u,
                              stopping_relative_change=args.stop,
                              lossy_duals=bool(args.lossy_duals)),
                args.out_of_core, max(args.temporal, 1),
                global_rows=(g0, g1, shape[0]),
                shard_w=(shard_w if shard_w > 0 else 0),
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                resume=bool(args.resume),
            )
            b_norm, delta = out_mh["b_norm"], out_mh["delta"]
            # output, fastest available path first: when the output sits
            # on a filesystem every process can see (the reference's
            # MPI-IO precondition, mpi.py:115,447), each process
            # region-writes its OWN rows into the one EMD file — zero
            # bytes over the network. Otherwise fall back to streaming the rows
            # to process 0 in SLAB-SIZED chunks (each padded to a fixed
            # row count so the allgather shapes agree) — no process ever
            # materializes the full cube (the config-5 recon is ~64 GiB)
            from cytvdn_tpu.io.emd import (
                write_emd_rows_gathered,
                write_emd_rows_multihost,
            )

            out_p = write_emd_rows_multihost(
                args.output, shape, np.float32, out_mh["recon"], (g0, g1))
            if out_p is not None:
                log(f"wrote {out_p} (concurrent per-process row writes)")
            else:
                ch = max(1, -(-shape[0] // (n_proc * args.out_of_core)))
                out_p = write_emd_rows_gathered(
                    args.output, shape, np.float32, out_mh["recon"],
                    (g0, g1), ch)
                if out_p is not None:
                    log(f"wrote {out_p} (chunked multihost gather)")
            recon = None
        else:
            from cytvdn_tpu.solver.outofcore import denoise_outofcore

            recon, b_norm, delta = denoise_outofcore(
                data, mu, lam=lam, iterations=iterations,
                FISTA=bool(args.fista),
                stopping_relative_change=args.stop,
                n_slabs=args.out_of_core,
                temporal_k=args.temporal, shard_w=shard_w,
                lossy_duals=bool(args.lossy_duals),
                quiet=not verbose,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume,
            )
    elif args.shard:
        from cytvdn_tpu.parallel.api import denoise_sharded

        shard = ("auto" if args.shard == "auto"
                 else tuple(int(s) for s in args.shard.split(",")))
        result = denoise_sharded(
            data_path if data_path is not None else data, shard=shard,
            isotropic_R=args.iso_r, isotropic_Q=args.iso_q,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            **kwargs,
        )
        recon, b_norm, delta = (result["recon"], result["b_norm"],
                                result["delta"])
    else:
        from cytvdn_tpu import denoise3D, denoise4D
        from cytvdn_tpu.utils.checkpoint import run_with_checkpointing

        if args.checkpoint and args.checkpoint_every:
            result = run_with_checkpointing(
                data, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                isotropic_R=args.iso_r, isotropic_Q=args.iso_q, **kwargs)
            recon, b_norm, delta = (result["recon"], result["b_norm"],
                                    result["delta"])
        elif ndim == 3:
            recon, b_norm, delta = denoise3D(data, **kwargs)[:3]
        else:
            recon, b_norm, delta = denoise4D(
                data, isotropic_R=args.iso_r, isotropic_Q=args.iso_q,
                **kwargs)[:3]
    stack.close()
    log(f"denoising took {time.time() - t0:.2f}s; "
        f"final delta {delta[np.nonzero(delta)][-1] if np.any(delta) else 0:.5f}")

    t0 = time.time()
    if recon is None:
        # multihost out-of-core: the chunked gather already wrote the
        # file from process 0
        return 0
    if isinstance(recon, np.ndarray):
        out = write_emd(args.output, recon)
    else:
        # sharded device array (possibly multihost): region-write /
        # per-host parts + stitch, no full-cube gather
        from cytvdn_tpu.io.emd import write_emd_sharded

        out = write_emd_sharded(args.output, recon)
    log(f"wrote {out} in {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
