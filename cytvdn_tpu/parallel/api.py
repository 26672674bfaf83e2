"""User-level sharded denoising — the ``cyTVMPI`` replacement as a library
call (the reference exposes distribution only through the MPI console
script, reference cyTVDN/mpi.py; here it is one keyword away from the
single-device API, with all solver features available distributed).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from cytvdn_tpu.config import Backend, BCMode, SolverOptions, normalize_iterations
from cytvdn_tpu.parallel.sharded import run_sharded


def denoise_sharded(
    datacube: np.ndarray,
    mu,
    lam=None,
    iterations=10,
    FISTA: bool = True,
    stopping_relative_change: Optional[float] = None,
    BC_mode: int = 2,
    isotropic_R: bool = False,
    isotropic_Q: bool = False,
    reference_data: Optional[np.ndarray] = None,
    quiet: bool = True,
    backend="auto",
    shard="auto",
    devices=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    progress: Optional[bool] = None,
    lossy_duals: bool = False,
) -> Dict[str, Any]:
    """Denoise a datacube sharded over a device mesh.

    Returns a dict with ``recon``, ``b_norm``, ``delta``,
    ``iterations_run`` [, ``mse``] as numpy arrays, and ``devices``: the
    ids of this process's devices that hold a shard of the result. Supports everything the
    single-device path does — FISTA, hybrid schedules, early stopping,
    MSE tracking, all BC modes, half-isotropic pairs, checkpoint/resume,
    live progress — none of which the reference's MPI runtime implements
    (reference mpi.py:252-255, 310-311; README.md:22-34; its head rank
    shows tqdm only in the single-node driver, cyTVDN.py:147-152).

    ``progress``: live per-iteration progress via chunked execution
    (state bit-exact; traces to the last ulp); default = on for long
    non-quiet runs, displayed on the head process only.
    """
    from cytvdn_tpu.api import _validate_and_derive
    from cytvdn_tpu.io.loaders import InputHandle

    lazy = isinstance(datacube, (str, InputHandle))
    if lazy:
        from cytvdn_tpu.io.loaders import open_input

        if isinstance(datacube, str):
            with open_input(datacube) as h:
                ndim = len(h.shape)
                in_shape = tuple(h.shape)
        else:
            in_shape = tuple(datacube.shape)
            ndim = len(in_shape)
    else:
        ndim = np.asarray(datacube).ndim
    n_f, n_u = normalize_iterations(iterations, FISTA)
    opts = SolverOptions(
        ndim=ndim,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        bc_mode=BCMode(BC_mode),
        stopping_relative_change=stopping_relative_change,
        isotropic_R=isotropic_R,
        isotropic_Q=isotropic_Q,
        calculate_mse=reference_data is not None,
        backend=Backend(backend),
        lossy_duals=lossy_duals,
    )

    if lazy:
        # lazy source: each device's shard is read directly from the file
        # (per-host on a cluster) — no process ever holds the full cube, like
        # the reference's memmap/MPI-IO opens (mpi.py:93-124). Data is cast
        # to float32 as the reference loader does (mpi.py:223-230).
        # The mesh is resolved BEFORE loading so blocks are read with
        # their final sharding.
        import jax

        from cytvdn_tpu.parallel.multihost import load_sharded_array
        from cytvdn_tpu.parallel.sharded import resolve_shard

        n_dev = len(devices) if devices is not None else len(jax.devices())
        shard = resolve_shard(shard, in_shape, n_dev)
        data_arr = load_sharded_array(datacube, shard, devices,
                                      dtype=np.float32)
        mu = np.asarray(mu, dtype=np.float32)
        if mu.ndim == 0:
            mu = np.full((ndim,), mu, dtype=np.float32)
        if lam is None:
            lam = mu * (1.0 / (32.0 if ndim == 4 else 16.0))
        lam = np.asarray(lam, dtype=np.float32)
        lambda_inv = (1.0 / lam).astype(np.float32)
        lam_mu = (lam / mu).astype(np.float32)
        datacube = data_arr
    else:
        datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
            datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
        )
    n_total = opts.total_iterations
    meta = {
        "ndim": ndim,
        "shape": list(datacube.shape),
        "iterations_fista": n_f,
        "iterations_unacc": n_u,
        "lossy_duals": bool(lossy_duals and n_f),
    }

    from cytvdn_tpu.api import _resolve_progress
    from cytvdn_tpu.utils.checkpoint import checkpoint_exists

    checkpointing = bool(checkpoint_path and checkpoint_every)
    resuming = bool(resume and checkpoint_exists(checkpoint_path))
    if resume:
        import jax

        if jax.process_count() > 1:
            # the resume decision must be COLLECTIVE: a crash between one
            # process's part write and another's leaves mixed generations,
            # and divergent resume-vs-fresh programs would deadlock the
            # collectives. All processes resume only if every one of them
            # has a checkpoint; otherwise all start fresh (stale parts are
            # overwritten at the next save).
            from jax.experimental import multihost_utils

            votes = multihost_utils.process_allgather(
                np.asarray([1 if resuming else 0], np.int32))
            resuming = bool(votes.min())
            resume = resuming
    # NB: the chunk-vs-single-shot decision must be IDENTICAL on every
    # process of a multi-host run (divergent programs would deadlock the
    # collectives) — only the display is head-process-only
    want_progress = _resolve_progress(progress, quiet, opts)
    show_progress = want_progress
    if want_progress:
        import jax

        show_progress = jax.process_index() == 0

    if not checkpointing and not resuming and not want_progress:
        out = run_sharded(datacube, lambda_inv, lam_mu, opts,
                          reference_data, shard, devices)
    else:
        from cytvdn_tpu.utils.checkpoint import chunk_driver

        def run_chunk(engine_state, i_stop):
            return run_sharded(
                datacube, lambda_inv, lam_mu, opts, reference_data, shard,
                devices, state=engine_state, i_stop=i_stop, keep_state=True,
            )

        cb = None
        every = checkpoint_every
        if want_progress and not every:
            from cytvdn_tpu.utils.checkpoint import progress_chunk_size

            every = progress_chunk_size(n_total)
        if show_progress:
            from cytvdn_tpu.utils.log import make_progress

            cb = make_progress("TV denoising (sharded)")
        try:
            out = chunk_driver(run_chunk, n_total, checkpoint_path,
                               every, resume, meta, datacube.shape,
                               progress=cb)
        finally:
            if cb is not None:
                cb.close()

    recon = out["recon"]
    devices_used = sorted({s.device.id for s in recon.addressable_shards})
    if getattr(recon, "is_fully_addressable", True):
        recon = np.asarray(recon)
    # else: multihost — no process can hold the global cube; the sharded
    # jax.Array is returned as-is and writers take it directly
    # (io.emd.write_emd_sharded writes per-host parts + stitch)
    result = {
        "recon": recon,
        "b_norm": np.asarray(out["b_norm"]),
        "delta": np.asarray(out["delta"]),
        "iterations_run": int(out["iterations_run"]),
        "devices": devices_used,
    }
    if opts.calculate_mse:
        result["mse"] = np.asarray(out["mse"])
    return result
