"""The iteration engine: one ``lax.while_loop`` solver for every path.

The reference has *three* copies of the iteration loop — ``denoise4D``
(reference cyTVDN/cyTVDN.py:147-242), ``denoise3D`` (cyTVDN.py:368-430) and
the MPI runtime's inline loop (cyTVDN/mpi.py:314-438), which drifted apart
(the MPI loop has no FISTA, no 3D, no convergence metrics). Here there is one
engine, parameterized by

- a :class:`Comm` strategy (``NullComm`` for single device;
  ``cytvdn_tpu.parallel.MeshComm`` inside ``shard_map`` for a device mesh),
- the static :class:`~cytvdn_tpu.config.SolverOptions`.

Iteration structure per step (SURVEY.md §8.1; reference cyTVDN.py:147-194):

1. per-axis dual accumulator updates (all reading the same ``recon``),
2. reconstruction update + relative-change statistic,
3. optional SSE vs reference data,
4. early stop when ``delta < stopping_relative_change``.

The convergence check runs **on device** inside the while-loop predicate —
no host sync per iteration (the reference MPI path has no stopping criterion
at all, reference README.md:34; here the distributed path gets it for free
via ``psum``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cytvdn_tpu import kernels, ops
from cytvdn_tpu.config import Backend, SolverOptions

Array = jax.Array


class NullComm:
    """Single-device communication strategy: no halos, identity reductions."""

    #: data axes that are split across devices (none)
    split_axes: Tuple[int, ...] = ()

    def prev_halo(self, a: Array, ax: int) -> Optional[Array]:
        """Neighbor's trailing slab of ``a`` along ``ax`` (backward-diff
        operand at the shard seam), or None when ``ax`` is not split."""
        return None

    def next_halo(self, b: Array, ax: int) -> Optional[Array]:
        """Neighbor's leading slab of the *updated* ``b`` along ``ax``
        (forward-diff operand), or None when ``ax`` is not split."""
        return None

    def allsum(self, x: Array) -> Array:
        return x


class HaloComm(NullComm):
    """Fixed operand halos for one slab of a larger cube.

    ``prev`` / ``next`` map a data axis to the slab that
    :meth:`prev_halo` / :meth:`next_halo` return (the neighbor's last
    pre-update ``recon`` slab, and its first *updated* accumulator slab);
    axes absent from a map fall back to the boundary condition. The
    out-of-core solver streams a host-resident cube through the device
    with it, so every slab runs the same :func:`step_partials` as the
    in-core engine.
    """

    def __init__(self, prev: Optional[Dict[int, Array]] = None,
                 next: Optional[Dict[int, Array]] = None):
        self.prev = dict(prev or {})
        self.next = dict(next or {})

    def prev_halo(self, a: Array, ax: int) -> Optional[Array]:
        return self.prev.get(ax)

    def next_halo(self, b: Array, ax: int) -> Optional[Array]:
        return self.next.get(ax)


def fista_tk_ratios(n: int) -> np.ndarray:
    """Precompute the FISTA momentum schedule on the host in float64,
    exactly as the reference's Python-float loop does
    (reference cyTVDN/cyTVDN.py:153-156): ``t' = (1+sqrt(1+4t²))/2``,
    ``ratio_i = (t-1)/t'`` starting from ``t=1`` (so ``ratio_0 = 0``)."""
    ratios = np.zeros((max(n, 1),), dtype=np.float64)
    tk = 1.0
    for i in range(n):
        tk_new = (1.0 + np.sqrt(1.0 + 4.0 * tk * tk)) / 2.0
        ratios[i] = (tk - 1.0) / tk_new
        tk = tk_new
    return ratios


def _accumulator_phase(
    recon: Array,
    accs: Tuple[Array, ...],
    ds: Optional[Tuple[Array, ...]],
    tk_ratio: Optional[Array],
    lambda_inv: Array,
    opts: SolverOptions,
    comm,
) -> Tuple[Tuple[Array, ...], Optional[Tuple[Array, ...]], Array]:
    """All per-axis dual updates for one iteration.

    Mirrors the driver's dispatch over iso flags
    (reference cyTVDN/cyTVDN.py:159-180 / 204-225). Returns
    ``(accs_new, ds_new, bnorm_partial)`` — ``bnorm_partial`` is the local
    (pre-``psum``) sum of accumulator L1 norms.
    """
    ndim = opts.ndim
    fista = ds is not None
    halos = [comm.prev_halo(recon, ax) for ax in range(ndim)]

    accs_new = list(accs)
    ds_new = list(ds) if fista else None
    bnorm = jnp.zeros((), dtype=recon.dtype)

    def aniso(ax):
        nonlocal bnorm
        if fista:
            b, d, n = ops.accumulator_update_fista(
                recon, accs[ax], ds[ax], tk_ratio, ax, lambda_inv[ax],
                opts.bc_mode, halos[ax],
            )
            # lossy duals: d stores at the carried dtype (bf16 rounds
            # every iteration); no-op when f32
            accs_new[ax], ds_new[ax] = b, d.astype(ds[ax].dtype)
        else:
            b, n = ops.accumulator_update(
                recon, accs[ax], ax, lambda_inv[ax], opts.bc_mode, halos[ax]
            )
            accs_new[ax] = b
        bnorm = bnorm + n

    def iso(ax1, ax2):
        # the pair shares one clip radius (reference cyTVDN.py:160-162,171-173)
        nonlocal bnorm
        if fista:
            b1, b2, d1, d2, n = ops.iso_accumulator_update_fista(
                recon, accs[ax1], accs[ax2], ds[ax1], ds[ax2], tk_ratio,
                ax1, ax2, lambda_inv[ax1], halos[ax1], halos[ax2],
            )
            accs_new[ax1], accs_new[ax2] = b1, b2
            ds_new[ax1], ds_new[ax2] = d1, d2
        else:
            b1, b2, n = ops.iso_accumulator_update(
                recon, accs[ax1], accs[ax2], ax1, ax2, lambda_inv[ax1],
                halos[ax1], halos[ax2],
            )
            accs_new[ax1], accs_new[ax2] = b1, b2
        bnorm = bnorm + n

    if ndim == 4:
        if opts.isotropic_R:
            iso(0, 1)
        else:
            aniso(0)
            aniso(1)
        if opts.isotropic_Q:
            iso(2, 3)
        else:
            aniso(2)
            aniso(3)
    else:
        for ax in range(3):
            aniso(ax)

    return tuple(accs_new), (tuple(ds_new) if fista else None), bnorm


def step_partials(
    orig: Array,
    recon: Array,
    accs: Tuple[Array, ...],
    ds: Optional[Tuple[Array, ...]],
    tk_ratio: Optional[Array],
    lambda_inv: Array,
    lam_mu: Array,
    opts: SolverOptions,
    comm,
):
    """One full TV iteration with *local* statistics.

    Returns ``(recon_new, accs_new, ds_new, bnorm, delta_num, recon_norm)``;
    the three scalars are this shard's (or slab's) partial sums, before any
    ``comm.allsum``. Operand halos come from ``comm``: :class:`NullComm`
    for a whole cube, ``MeshComm`` inside ``shard_map``, :class:`HaloComm`
    for one slab of a host-resident cube (``solver/outofcore.py``).
    """
    accs_new, ds_new, bnorm = _accumulator_phase(
        recon, accs, ds, tk_ratio, lambda_inv, opts, comm
    )
    halos_next = [comm.next_halo(accs_new[k], k) for k in range(opts.ndim)]
    recon_new, delta_num, recon_norm = ops.datacube_update(
        orig, recon, accs_new, lam_mu, opts.bc_mode, halos_next
    )
    return recon_new, accs_new, ds_new, bnorm, delta_num, recon_norm


def _use_gpu_step(opts: SolverOptions, dtype, size: int, comm) -> bool:
    """Whether the iteration runs the hand-written GPU step
    (``kernels/step.py``) instead of the XLA ops path.

    ``AUTO`` takes it on a GPU when it covers the configuration on one
    device; ``PALLAS`` demands it and raises where it cannot run — it
    never falls back to an interpreter.
    """
    if opts.backend not in (Backend.AUTO, Backend.PALLAS):
        return False
    fits = type(comm) is NullComm and kernels.covers(opts, dtype, size)
    if opts.backend == Backend.AUTO:
        return fits and jax.default_backend() == "gpu"
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "backend='pallas' needs an NVIDIA GPU; JAX's default backend "
            f"is {jax.default_backend()!r}")
    if not fits:
        raise ValueError(
            "backend='pallas' covers float32 Jia-Zhao anisotropic runs "
            "with exact duals on one device, of at most "
            f"{kernels.step.MAX_SIZE} elements; use 'auto' or 'jax'")
    return True


def iteration_step(
    orig: Array,
    recon: Array,
    accs: Tuple[Array, ...],
    ds: Optional[Tuple[Array, ...]],
    tk_ratio: Optional[Array],
    lambda_inv: Array,
    lam_mu: Array,
    opts: SolverOptions,
    comm=None,
):
    """One full TV iteration (accumulators + reconstruction + statistics).

    Returns ``(recon_new, accs_new, ds_new, bnorm, delta)`` with ``bnorm``
    and ``delta`` already globally reduced through ``comm.allsum``. The
    body is the GPU step where :func:`_use_gpu_step` selects it, and the
    XLA ops path (``ops/stencil.py``) otherwise.
    """
    comm = comm or NullComm()
    if _use_gpu_step(opts, recon.dtype, recon.size, comm):
        step = kernels.gpu_step(orig, recon, accs, ds, tk_ratio, lambda_inv,
                                lam_mu)
    else:
        step = step_partials(orig, recon, accs, ds, tk_ratio, lambda_inv,
                             lam_mu, opts, comm)
    recon_new, accs_new, ds_new, bnorm, delta_num, recon_norm = step
    bnorm = comm.allsum(bnorm)
    delta = comm.allsum(delta_num) / comm.allsum(recon_norm)
    return recon_new, accs_new, ds_new, bnorm, delta


class _PhaseCarry(NamedTuple):
    i: Array          # global iteration/trace index
    done: Array       # early-stop latch
    recon: Array
    accs: Tuple[Array, ...]
    ds: Any           # tuple of arrays, or () when not carried
    b_norm: Array     # full-length trace
    delta: Array      # full-length trace
    mse: Array        # full-length (+1) trace, or shape-(0,) placeholder
    tk: Array         # FISTA momentum scalar (used when fista_restart)


def _run_phase(
    fista: bool,
    i_bound,
    carry: _PhaseCarry,
    orig: Array,
    tk_ratios: Array,
    lambda_inv: Array,
    lam_mu: Array,
    opts: SolverOptions,
    comm,
    reference_data: Optional[Array],
    i_stop,
) -> _PhaseCarry:
    """Run one phase (FISTA or unaccelerated) as a fixed-structure
    ``lax.while_loop`` bounded by the global iteration index, with
    on-device early stopping.

    Matches the reference's loop semantics: the stop check happens *after*
    the iteration's traces are recorded, so the converging iteration is
    included (reference cyTVDN/cyTVDN.py:182-194). ``i_stop`` additionally
    caps the run (dynamic — used for chunked checkpointing)."""
    stopping = opts.stopping_relative_change
    bound = jnp.minimum(jnp.asarray(i_bound, jnp.int32),
                        jnp.asarray(i_stop, jnp.int32))

    def cond(c: _PhaseCarry):
        return jnp.logical_and(c.i < bound, jnp.logical_not(c.done))

    def body(c: _PhaseCarry):
        if fista and opts.fista_restart:
            # device-computed momentum with adaptive (function-value)
            # restart: reset tk when the relative change increased —
            # opt-in, deviates from the reference's fixed schedule
            tk_new = (1.0 + jnp.sqrt(1.0 + 4.0 * c.tk * c.tk)) / 2.0
            tk_ratio = ((c.tk - 1.0) / tk_new).astype(orig.dtype)
        elif fista:
            tk_ratio = tk_ratios[c.i].astype(orig.dtype)
        else:
            tk_ratio = None
        ds = c.ds if fista else None
        recon, accs, ds_new, bnorm, delta = iteration_step(
            orig, c.recon, c.accs, ds, tk_ratio, lambda_inv, lam_mu, opts, comm
        )
        b_norm = c.b_norm.at[c.i].set(bnorm.astype(c.b_norm.dtype))
        delta_tr = c.delta.at[c.i].set(delta.astype(c.delta.dtype))
        if opts.calculate_mse:
            sse = comm.allsum(ops.sum_square_error(reference_data, recon))
            mse = c.mse.at[c.i + 1].set(sse.astype(c.mse.dtype))
        else:
            mse = c.mse
        done = (
            delta < stopping if stopping is not None
            else jnp.zeros((), dtype=bool)
        )
        if fista and opts.fista_restart:
            prev_delta = jnp.where(
                c.i > 0,
                c.delta[jnp.maximum(c.i - 1, 0)].astype(jnp.float32),
                jnp.float32(jnp.inf),
            )
            tk_next = jnp.where(delta.astype(jnp.float32) > prev_delta,
                                jnp.float32(1.0), tk_new.astype(jnp.float32))
        else:
            tk_next = c.tk
        return _PhaseCarry(
            i=c.i + 1,
            done=done,
            recon=recon,
            accs=accs,
            ds=ds_new if fista else c.ds,
            b_norm=b_norm,
            delta=delta_tr,
            mse=mse,
            tk=tk_next,
        )

    return lax.while_loop(cond, body, carry)


def run_solver(
    orig: Array,
    lambda_inv: Array,
    lam_mu: Array,
    opts: SolverOptions,
    reference_data: Optional[Array] = None,
    comm=None,
    state: Optional[Dict[str, Any]] = None,
    i_stop=None,
    keep_state: bool = False,
) -> Dict[str, Array]:
    """Run the full (possibly hybrid) TV-denoising schedule on device.

    Hybrid semantics are faithful to the reference: when both phase lengths
    are nonzero, the FISTA phase runs first and the unaccelerated phase
    *always* follows (even if FISTA early-stopped), sharing accumulators;
    trace entries for skipped iterations remain zero
    (reference cyTVDN/cyTVDN.py:100-108, 127-128, 195-201).

    ``state``/``i_stop``/``keep_state`` support chunked execution and
    checkpoint/resume (a capability the reference lacks, SURVEY.md §5):
    ``state`` is a dict with ``recon``, ``accs``, ``ds``, ``b_norm``,
    ``delta``, ``mse``, ``i`` (as produced with ``keep_state=True``);
    ``i_stop`` dynamically caps the global iteration index.

    Returns a dict with ``recon``, ``b_norm``, ``delta``, ``iterations_run``
    [, ``mse``] [, ``accs``, ``ds``, ``i`` when ``keep_state``].
    """
    comm = comm or NullComm()
    dtype = orig.dtype
    lossy = opts.lossy_duals and opts.iterations_fista > 0
    if lossy:
        # opt-in bfloat16 storage of the FISTA shadow duals: compute stays
        # f32, ``d`` rounds on every store (the same cadence on the
        # single-device, mesh, chunked and out-of-core paths, so lossy
        # runs keep the chunk/checkpoint and mesh ≡ single-device
        # invariants, tests/test_lossy.py)
        if dtype != jnp.float32:
            raise ValueError("lossy_duals requires float32 data")
    if reference_data is not None and reference_data.dtype != dtype:
        # normalize ONCE at entry: an f64 reference next to an f32 cube
        # (numpy's default under x64) computes SSE in the cube's dtype,
        # as the reference does (utils.pyx)
        reference_data = reference_data.astype(dtype)
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    if i_stop is None:
        i_stop = n_total

    # schedule computed on host in float64 then stored at the data dtype —
    # bitwise identical to the reference passing a Python float into a
    # ``_float``-typed kernel argument (reference cyTVDN.py:153-156).
    tk_ratios = jnp.asarray(fista_tk_ratios(n_f), dtype=dtype)

    d_dt = jnp.bfloat16 if lossy else dtype
    if state is not None:
        recon = state["recon"]
        accs = tuple(state["accs"])
        ds = tuple(d.astype(d_dt) for d in state["ds"]) if n_f else ()
        b_norm = state["b_norm"]
        delta = state["delta"]
        mse = state["mse"] if opts.calculate_mse else jnp.zeros((0,), dtype)
        i0 = jnp.asarray(state["i"], jnp.int32)
        tk0 = jnp.asarray(state.get("tk", 1.0), jnp.float32)
    else:
        accs = tuple(jnp.zeros_like(orig) for _ in range(opts.ndim))
        ds = tuple(jnp.zeros(orig.shape, d_dt) for _ in range(opts.ndim)) \
            if n_f else ()
        recon = orig  # functional copy-on-write (reference cyTVDN.py:145)
        b_norm = jnp.zeros((n_total,), dtype=dtype)
        delta = jnp.zeros((n_total,), dtype=dtype)
        if opts.calculate_mse:
            mse = jnp.zeros((n_total + 1,), dtype=dtype)
            sse0 = comm.allsum(ops.sum_square_error(orig, reference_data))
            mse = mse.at[0].set(sse0.astype(dtype))
        else:
            mse = jnp.zeros((0,), dtype=dtype)
        i0 = jnp.zeros((), jnp.int32)
        tk0 = jnp.ones((), jnp.float32)

    carry = _PhaseCarry(
        i=i0,
        done=jnp.zeros((), bool),
        recon=recon,
        accs=accs,
        ds=ds,
        b_norm=b_norm,
        delta=delta,
        mse=mse,
        tk=tk0,
    )

    i_stop2 = jnp.asarray(i_stop, jnp.int32)
    if n_f:
        carry = _run_phase(
            True, n_f, carry, orig, tk_ratios, lambda_inv, lam_mu, opts,
            comm, reference_data, i_stop,
        )
        # Was the FISTA phase cut short by the chunk cap (not by early
        # stop)? Then keep the index where it is and skip the second phase
        # this call — the next chunk resumes FISTA.
        chunk_capped = jnp.logical_and(
            jnp.logical_not(carry.done), carry.i < n_f
        )
        if n_u:
            # advance to the unaccelerated phase's first index on completion
            # or early stop; the early-stop latch does NOT carry across (the
            # reference runs the second phase unconditionally,
            # cyTVDN.py:195-201). With no second phase scheduled, the index
            # and latch stay put so iterations_run/early_stopped are honest.
            carry = carry._replace(
                i=jnp.where(chunk_capped, carry.i,
                            jnp.maximum(carry.i,
                                        jnp.asarray(n_f, jnp.int32))),
                done=jnp.zeros((), bool),
            )
        i_stop2 = jnp.where(chunk_capped, jnp.zeros((), jnp.int32), i_stop2)
        if not keep_state:
            carry = carry._replace(ds=())
    if n_u:
        carry = _run_phase(
            False, n_total, carry, orig, tk_ratios, lambda_inv, lam_mu, opts,
            comm, reference_data, i_stop2,
        )

    out = {
        "recon": carry.recon,
        "b_norm": carry.b_norm,
        "delta": carry.delta,
        "iterations_run": carry.i,
        "early_stopped": carry.done,
    }
    if opts.calculate_mse:
        out["mse"] = carry.mse
    if keep_state:
        out["accs"] = carry.accs
        out["ds"] = carry.ds
        out["i"] = carry.i
        out["tk"] = carry.tk
    return out
