"""Periodic checkpoint / resume for the TV solver.

The reference has no checkpointing: a crashed 40-iteration Cori job
restarts from scratch (SURVEY.md §5). The iteration state is fully
summarized by ``(recon, accs, ds, tk-index, traces)`` — here the solver
runs in chunks of ``checkpoint_every`` iterations (a *dynamic* iteration
cap: one compilation, no retraces) and the state is written atomically to
an .npz after each chunk. Resume picks up mid-phase, mid-schedule, with
bit-identical results to an uninterrupted run (tested).
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Any, Dict, Optional

import jax
import numpy as np

from cytvdn_tpu.config import Backend, BCMode, SolverOptions, normalize_iterations

_FMT_VERSION = 1

# np.savez round-trips ml_dtypes bfloat16 as a raw void16 ('|V2') that
# nothing can cast back; bf16 state (lossy_duals shadow duals) is stored
# as its uint16 bit pattern and viewed back on load — bit-exact resume.
_BF16 = np.dtype(jax.numpy.bfloat16)


class ShardedBlocks:
    """A checkpointed state array held as this process's shard blocks.

    Multi-host checkpoints never materialize global cubes: each process
    saves exactly the blocks its devices own and reloads the same blocks
    on resume (``run_sharded`` reassembles the global array via
    ``jax.make_array_from_callback``, which asks each process only for its
    own blocks). The analog of per-rank MPI-IO checkpointing.
    """

    def __init__(self, shape, dtype, blocks):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._blocks = dict(blocks)  # bounds tuple -> np.ndarray

    @staticmethod
    def bounds_of(index, shape):
        return tuple(
            (0, d) if s == slice(None) else s.indices(d)[:2]
            for s, d in zip(index, shape)
        )

    def lookup(self, index) -> np.ndarray:
        key = self.bounds_of(index, self.shape)
        try:
            return self._blocks[key]
        except KeyError:
            raise ValueError(
                f"checkpoint resume asked for block {key} but this "
                f"process saved {sorted(self._blocks)} — resume must use "
                f"the same process count, device order and --shard tiling "
                f"as the run that wrote the checkpoint"
            ) from None

    def items(self):
        return self._blocks.items()


def _is_distributed(x) -> bool:
    return (isinstance(x, jax.Array)
            and not getattr(x, "is_fully_addressable", True))


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".ckpt.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _part_path(path: str, proc: int) -> str:
    return f"{path}.p{proc}" if proc else path


def save_state(path: str, state: Dict[str, Any], meta: Dict[str, Any]):
    """Atomic .npz checkpoint write (tmp file + rename).

    Single-process state saves one file at ``path``. Multi-process state
    (non-fully-addressable ``jax.Array``s) saves one self-contained file
    per process — process 0 at ``path``, process p at ``path.p<p>`` —
    each holding only that process's shard blocks plus the replicated
    scalars/traces; a chunk counter guards against mixed-generation parts.
    """
    data_items = [("recon", state["recon"])]
    data_items += [(f"acc{k}", a) for k, a in enumerate(state["accs"])]
    data_items += [(f"d{k}", a) for k, a in enumerate(state.get("ds") or ())]

    arrays = {
        "b_norm": np.asarray(state["b_norm"]),
        "delta": np.asarray(state["delta"]),
        "mse": np.asarray(state.get("mse", np.zeros(0))),
        "i": np.asarray(state["i"]),
        "tk": np.asarray(state.get("tk", 1.0), np.float32),
        "early_stopped": np.asarray(bool(state.get("early_stopped", False))),
    }
    distributed = any(_is_distributed(v) for _, v in data_items)
    blockmeta = None
    if distributed:
        proc = jax.process_index()
        blockmeta = {}
        for k, v in data_items:
            bounds = []
            # bf16 blocks get the same uint16-bit-pattern encoding as the
            # single-process branch (np.savez would otherwise store raw
            # '|V2' voids that cannot be decoded on load)
            is_bf16 = np.dtype(v.dtype) == _BF16
            for j, sh in enumerate(v.addressable_shards):
                a = np.asarray(sh.data)
                arrays[f"{k}.b{j}"] = a.view(np.uint16) if is_bf16 else a
                bounds.append(ShardedBlocks.bounds_of(sh.index, v.shape))
            blockmeta[k] = {
                "shape": list(v.shape),
                "dtype": np.dtype(v.dtype).name,
                "bounds": bounds,
                "bf16": is_bf16,
            }
        path = _part_path(path, proc)
    else:
        bf16_keys = []
        for k, v in data_items:
            a = np.asarray(v)
            if a.dtype == _BF16:
                a = a.view(np.uint16)
                bf16_keys.append(k)
            arrays[k] = a

    arrays["meta"] = np.frombuffer(
        json.dumps({
            **meta, "version": _FMT_VERSION,
            **({"blocks": blockmeta,
                "num_processes": jax.process_count()} if distributed else
               {"bf16_keys": bf16_keys} if bf16_keys else {}),
        }).encode(), dtype=np.uint8
    )
    _atomic_savez(path, arrays)
    if distributed:
        from jax.experimental import multihost_utils

        # no process may resume until every part of this generation exists
        multihost_utils.sync_global_devices("cytv_ckpt_saved")


def load_state(path: str):
    """Load a checkpoint; returns ``(state, meta)``.

    For a multi-process checkpoint each process reads only its own part
    file; data entries come back as :class:`ShardedBlocks` (reassembled
    into global arrays by ``run_sharded``), and a cross-process agreement
    check rejects mixed-generation parts.
    """
    # read this process's own part when one exists (hosts of a cluster need
    # not share a filesystem: each process saves and reloads locally);
    # otherwise the master (single-process saves, or process 0)
    proc = jax.process_index()
    own = _part_path(path, proc)
    path = own if os.path.exists(own) else path
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
    if meta.get("blocks") is not None:
        if jax.process_count() != meta["num_processes"]:
            raise ValueError(
                f"checkpoint was written by {meta['num_processes']} "
                f"processes; this run has {jax.process_count()}"
            )
        if path != own:
            raise ValueError(
                f"process {proc} found the multi-process checkpoint master "
                f"but not its own part '{own}' — resume on the same hosts "
                f"(or copy each part to its host) with the same process "
                f"count"
            )
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        ndim = meta["ndim"]
        blockmeta = meta.get("blocks")

        bf16_keys = set(meta.get("bf16_keys") or ())

        def data(k):
            if blockmeta is None:
                return z[k].view(_BF16) if k in bf16_keys else z[k]
            bm = blockmeta[k]
            dec = ((lambda a: a.view(_BF16)) if bm.get("bf16")
                   else (lambda a: a))
            return ShardedBlocks(
                bm["shape"], _BF16 if bm.get("bf16") else bm["dtype"],
                {tuple(map(tuple, b)): dec(z[f"{k}.b{j}"])
                 for j, b in enumerate(bm["bounds"])},
            )

        state = {
            "recon": data("recon"),
            "b_norm": z["b_norm"],
            "delta": z["delta"],
            "mse": z["mse"],
            "i": z["i"],
            "tk": (z["tk"] if "tk" in z.files else np.float32(1.0)),
            "accs": tuple(data(f"acc{k}") for k in range(ndim)),
            "ds": tuple(data(f"d{k}") for k in range(ndim)
                        if (f"d{k}" in z.files
                            or (blockmeta and f"d{k}" in blockmeta))),
        }
        if "early_stopped" in z.files:
            state["early_stopped"] = bool(z["early_stopped"])
    if blockmeta is not None:
        from jax.experimental import multihost_utils

        # every process must hold the same generation (a crash between
        # part writes leaves a mixed set; sync_global_devices above makes
        # the window narrow but not zero). A process can only hold its
        # own latest part, so a mixed set cannot be reconciled — recover
        # by collectively discarding the checkpoint and starting fresh
        # (the allgather result is identical everywhere, so every process
        # takes the same branch; stale parts are overwritten at the next
        # save). The reference cannot resume a crashed job at all
        # (SURVEY.md §5), so a from-scratch restart is the worst case.
        import warnings

        gens = multihost_utils.process_allgather(
            np.asarray([int(state["i"])], np.int64))
        if int(gens.min()) != int(gens.max()):
            warnings.warn(
                f"checkpoint parts disagree on iteration ({gens.ravel()})"
                " — the job died mid-save; discarding the checkpoint and "
                "restarting from scratch", stacklevel=2)
            return None, meta
    return state, meta


def progress_chunk_size(n_total: int) -> int:
    """Chunk length for progress-driven chunked execution: frequent
    enough for a live bar, long enough to amortize dispatch (shared by
    the single-device and sharded entry points)."""
    return max(25, min(250, n_total // 40 or 1))


def checkpoint_exists(path: Optional[str]) -> bool:
    """Whether a resumable checkpoint exists for THIS process: the master
    file, or (multi-process without a shared filesystem) the process's own
    part file."""
    if not path:
        return False
    if os.path.exists(path):
        return True
    try:
        proc = jax.process_index()
    except Exception:
        return False
    return proc > 0 and os.path.exists(_part_path(path, proc))


def chunk_driver(
    run_chunk,
    n_total: int,
    checkpoint_path: Optional[str],
    checkpoint_every: int,
    resume: bool,
    meta: Dict[str, Any],
    expected_shape,
    progress=None,
):
    """The shared chunked-execution loop behind both the single-device and
    sharded checkpointing entry points.

    ``run_chunk(engine_state_or_None, i_stop) -> out_dict`` runs the solver
    up to the (dynamic) global iteration cap and returns the
    ``keep_state=True`` result dict. The driver persists state (including
    the early-stop latch, so resuming a converged job is an idempotent
    no-op) and stops on convergence or completion.
    """
    state = None
    if resume and checkpoint_exists(checkpoint_path):
        state, ck_meta = load_state(checkpoint_path)
        if state is None:  # mixed-generation multi-process parts
            ck_meta = None
    if state is not None:
        if ck_meta["shape"] != list(expected_shape):
            raise ValueError(
                f"checkpoint shape {ck_meta['shape']} does not match input "
                f"{list(expected_shape)}"
            )
        for k, v in meta.items():
            # a checkpoint from a different schedule would silently
            # misinterpret the saved iteration index / momentum state
            if k != "shape" and ck_meta.get(k, v) != v:
                raise ValueError(
                    f"checkpoint {k}={ck_meta.get(k)!r} does not match the "
                    f"requested run's {k}={v!r}"
                )

    out = None
    while True:
        if state is not None and (
            state.get("early_stopped", False)
            or int(state["i"]) >= n_total
        ):
            break
        i_now = int(state["i"]) if state is not None else 0
        i_stop = (min(i_now + checkpoint_every, n_total)
                  if checkpoint_every > 0 else n_total)
        engine_state = (
            {k: v for k, v in state.items() if k != "early_stopped"}
            if state is not None else None
        )
        out = run_chunk(engine_state, i_stop)
        state = {
            "recon": out["recon"],
            "accs": tuple(out["accs"]),
            "ds": tuple(out["ds"]) if out["ds"] else (),
            "b_norm": out["b_norm"],
            "delta": out["delta"],
            "mse": out.get("mse", np.zeros(0)),
            "i": out["i"],
            "tk": out.get("tk", np.float32(1.0)),
            "early_stopped": bool(out["early_stopped"]),
        }
        if checkpoint_path:
            save_state(checkpoint_path, state, meta)
        if progress is not None:
            d = np.asarray(out["delta"])
            nz = d[np.nonzero(d)]
            progress(int(out["iterations_run"]), n_total,
                     float(nz[-1]) if nz.size else float("nan"))
        if state["early_stopped"] or int(out["iterations_run"]) >= n_total:
            break
    if out is None:
        # checkpoint already covered the whole schedule: run one
        # zero-iteration chunk so the result comes back through the
        # engine's normal output contract (device arrays with the target
        # sharding — the loaded state may be per-process ShardedBlocks)
        engine_state = {k: v for k, v in state.items()
                        if k != "early_stopped"}
        out = run_chunk(engine_state, int(state["i"]))
        out = {**out, "early_stopped": state.get("early_stopped", False)}
    return out


@functools.partial(jax.jit, static_argnames=("opts", "with_state"))
def _chunk_jit(orig, lambda_inv, lam_mu, opts, state, i_stop, reference_data,
               with_state):
    from cytvdn_tpu.solver.engine import run_solver

    return run_solver(
        orig, lambda_inv, lam_mu, opts, reference_data,
        state=state if with_state else None, i_stop=i_stop, keep_state=True,
    )


def run_chunked(
    datacube: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    checkpoint_path: str,
    checkpoint_every: int,
    resume: bool = False,
    reference_data: Optional[np.ndarray] = None,
    progress=None,
) -> Dict[str, np.ndarray]:
    """Run the solver in checkpointed chunks; returns the result dict.

    ``progress``: optional callback ``(iterations_done, n_total, delta)``
    invoked after each chunk — the jit-compatible equivalent of the
    reference's per-iteration tqdm (reference cyTVDN.py:147-152)."""
    import jax.numpy as jnp

    if opts.backend == Backend.CPP:
        raise ValueError(
            "checkpointing runs on the JAX/Pallas backends; backend='cpp' "
            "is not supported here"
        )
    n_total = opts.total_iterations
    meta = {
        "ndim": opts.ndim,
        "shape": list(datacube.shape),
        "iterations_fista": opts.iterations_fista,
        "iterations_unacc": opts.iterations_unacc,
        # an exact checkpoint resumed lossy (or vice versa) would
        # silently change the duals' rounding cadence mid-run
        "lossy_duals": bool(opts.lossy_duals and opts.iterations_fista),
    }

    orig = jnp.asarray(datacube)
    li = jnp.asarray(lambda_inv)
    lm = jnp.asarray(lam_mu)
    ref = jnp.asarray(reference_data) if opts.calculate_mse else None

    def run_chunk(engine_state, i_stop):
        jstate = None
        if engine_state is not None:
            jstate = {k: (tuple(jnp.asarray(x) for x in v)
                          if isinstance(v, tuple)
                          else jnp.asarray(v))
                      for k, v in engine_state.items()}
        return _chunk_jit(orig, li, lm, opts, jstate,
                          jnp.asarray(i_stop, jnp.int32), ref,
                          jstate is not None)

    out = chunk_driver(run_chunk, n_total, checkpoint_path,
                       checkpoint_every, resume, meta, datacube.shape,
                       progress=progress)

    result = {
        "recon": np.asarray(out["recon"]),
        "b_norm": np.asarray(out["b_norm"]),
        "delta": np.asarray(out["delta"]),
        "iterations_run": int(out["iterations_run"]),
    }
    if opts.calculate_mse:
        result["mse"] = np.asarray(out["mse"])
    return result


def run_with_checkpointing(
    datacube: np.ndarray,
    mu,
    lam=None,
    iterations=10,
    FISTA=True,
    stopping_relative_change=None,
    BC_mode=2,
    isotropic_R=False,
    isotropic_Q=False,
    reference_data=None,
    quiet=True,
    backend="auto",
    checkpoint_path: str = "",
    checkpoint_every: int = 0,
    resume: bool = False,
    lossy_duals: bool = False,
) -> Dict[str, np.ndarray]:
    """User-level checkpointed run with the ``denoise*`` parameter surface."""
    from cytvdn_tpu.api import _memory_note, _validate_and_derive

    ndim = np.asarray(datacube).ndim
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
    )
    n_f, n_u = normalize_iterations(iterations, FISTA)
    _memory_note(datacube, n_f > 0, ndim, quiet)
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
    return run_chunked(
        datacube, lambda_inv, lam_mu, opts, checkpoint_path,
        checkpoint_every, resume, reference_data,
    )
