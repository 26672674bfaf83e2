"""Out-of-core solver: datacubes whose iteration state exceeds one card's
device memory stream through the device in axis-0 slabs.

The reference's only answer to a cube larger than one node is MPI
scale-out; here a single card can also run it with state resident in host
RAM:

- State lives in numpy arrays; each iteration sweeps slabs of S rows
  through the device in order.
- Each slab is one engine step (``engine.step_partials``) with **operand
  halos** — the same mechanism the shard_map path uses. Because
  slabs are processed in ascending order, the +1 neighbor's pre-update
  state is still untouched in host RAM, and the -1 neighbor's pre-update
  state is read before its write-back: the math is *identical* to the
  in-core run (tested to f32 equality).
- **Software pipeline**: slab i+1's host→device transfers are enqueued
  while slab i computes and slab i-1's results stream back — JAX's async
  dispatch overlaps all three. Device inputs are donated, so XLA updates
  the state in place (≈11 slab-size buffers per slab generation; THREE
  generations are live at the pipeline's peak — pending outputs,
  executing, prefetched — so size slabs for ~33 slab-buffers of device
  memory).
- bnorm/delta partials are summed across slabs host-side (deterministic);
  early stopping works per iteration.

This trades speed for capacity: every iteration moves the full state over
PCIe. Use the mesh path when chips are available; use this when they are
not.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np

from cytvdn_tpu.config import BCMode, SolverOptions, normalize_iterations
from cytvdn_tpu.solver.engine import fista_tk_ratios


def _make_temporal_chunk(opts: SolverOptions):
    """K engine iterations on one device-resident extended slab.

    Temporal blocking (trapezoidal tiling): the slab is loaded with a
    K-row margin on each interior side; each on-device iteration lets
    boundary garbage creep exactly one row inward from the margins (the
    stencil's light cone is ±1 row/iteration), so after K iterations the
    core rows are bit-identical to the serial sweep while host↔device
    traffic per iteration drops K×. The axis-0 operand halos are the
    cube's own Jia-Zhao edges: a zero forward halo (the global leading
    accumulator slab is identically zero) and the slab's own first row
    backward — exact at true cube edges, and confined to the discarded
    margin elsewhere.

    Returns ``(recon, accs, ds, recon_prev)`` after the K scanned
    iterations — ``recon_prev`` (the K-1st recon) lets the caller compute
    the true iteration-(T+K) delta over the core region.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from cytvdn_tpu.solver.engine import HaloComm, step_partials

    @functools.partial(jax.jit, static_argnames=("fista",),
                       donate_argnums=(1, 2, 3))
    def chunk(orig, recon, accs, ds, tk_ratios, li, lm, fista):
        comm = HaloComm(next={0: jnp.zeros_like(recon[:1])})

        def body(carry, tk):
            r, a, d, _ = carry
            r2, a2, d2 = step_partials(
                orig, r, a, d if fista else None, tk if fista else None,
                li, lm, opts, comm)[:3]
            return (r2, a2, d2 if fista else (), r), None

        (r, a, d, r_prev), _ = lax.scan(
            body, (recon, accs, ds, recon), tk_ratios)
        return r, a, d, r_prev

    return chunk


def _make_step(opts: SolverOptions):
    """Donating jitted engine step for one slab with explicit axis-0
    operand halos: ``prev0`` (the -1 neighbor's last pre-update recon
    row) and the +1 neighbor's first *updated* axis-0 accumulator row,
    recomputed here from its pre-update state (``next0_recon``,
    ``next0_acc``, ``next0_d``) with the same arithmetic as that slab's
    own update — so a slab sweep is bit-identical to the in-core run.
    The device copies of recon/accs/ds are consumed by the call, so XLA
    updates them in place."""
    import jax

    from cytvdn_tpu import ops
    from cytvdn_tpu.solver.engine import HaloComm, step_partials

    @functools.partial(jax.jit, static_argnames=("fista",),
                       donate_argnums=(1, 2, 3))
    def step(orig, recon, accs, ds, tk_ratio, li, lm, halos, fista):
        own_last = recon[-1:]
        if fista:
            nxt = ops.accumulator_update_fista(
                halos["next0_recon"], halos["next0_acc"], halos["next0_d"],
                tk_ratio, 0, li[0], opts.bc_mode, own_last)[0]
        else:
            nxt = ops.accumulator_update(
                halos["next0_recon"], halos["next0_acc"], 0, li[0],
                opts.bc_mode, own_last)[0]
        comm = HaloComm(prev={0: halos["prev0"]}, next={0: nxt})
        return step_partials(
            orig, recon, accs, ds if fista else None,
            tk_ratio if fista else None, li, lm, opts, comm)

    return step


#: test hook — called with ``it_run`` after each COMPLETED checkpoint
#: save (post-barrier in multihost mode, so killing here leaves a
#: consistent generation on every process)
_POST_CKPT_HOOK = None


def _ckpt_meta(opts: SolverOptions, shape, mode: str) -> Dict:
    """Schedule/geometry fingerprint stored in out-of-core checkpoints —
    a resume against a different schedule would silently misinterpret
    the saved iteration index (same rule as utils.checkpoint)."""
    return {
        "shape": list(shape), "ndim": opts.ndim,
        "iterations_fista": opts.iterations_fista,
        "iterations_unacc": opts.iterations_unacc,
        "stopping": opts.stopping_relative_change,
        "bc_mode": int(opts.bc_mode),
        "mode": mode,
        # an exact checkpoint resumed lossy (or vice versa) would
        # silently change the duals' rounding cadence mid-run
        "lossy": bool(opts.lossy_duals),
    }


def _ckpt_resume(path, resume: bool, meta: Dict, shape):
    """Load-and-validate an out-of-core checkpoint, or None."""
    from cytvdn_tpu.utils.checkpoint import checkpoint_exists, load_state

    if not (resume and checkpoint_exists(path)):
        return None
    state, ck_meta = load_state(path)
    if state is None:
        return None
    if ck_meta["shape"] != list(shape):
        raise ValueError(
            f"checkpoint shape {ck_meta['shape']} does not match input "
            f"{list(shape)}")
    for k, v in meta.items():
        if k != "shape" and ck_meta.get(k, v) != v:
            raise ValueError(
                f"checkpoint {k}={ck_meta.get(k)!r} does not match the "
                f"requested run's {k}={v!r}")
    return state


def _restore_state(st, sl, recon, accs, ds, b_norm, delta, mse):
    """Restore a loaded checkpoint into the run's host arrays in place
    (``sl`` targets the owned rows — the whole array single-process, the
    ghost-framed own range multihost). Returns ``(start, resumed_stop)``.
    Shared by all four out-of-core modes so the restore logic cannot
    drift between them."""
    recon[sl] = np.asarray(st["recon"], np.float32)
    for k, a in enumerate(accs):
        a[sl] = np.asarray(st["accs"][k], np.float32)
    if ds:
        for k, d in enumerate(ds):
            # ds restore preserves the run's storage dtype (bf16 under
            # lossy_duals; the checkpoint holds the same grid, so any
            # widen/narrow here is exact)
            d[sl] = np.asarray(st["ds"][k], d.dtype)
    b_norm[:] = st["b_norm"]
    delta[:] = st["delta"]
    if mse is not None and np.asarray(st["mse"]).size == mse.size:
        mse[:] = st["mse"]
    return int(st["i"]), bool(st.get("early_stopped", False))


def _ckpt_save(path, meta, it_run, recon, accs, ds, b_norm, delta, mse,
               stopped: bool):
    """Atomic full-state save of a host-resident out-of-core run."""
    from cytvdn_tpu.utils.checkpoint import save_state

    save_state(path, {
        "recon": recon,
        "accs": tuple(accs),
        "ds": tuple(ds) if ds else (),
        "b_norm": b_norm,
        "delta": delta,
        "mse": mse if mse is not None else np.zeros(0, np.float32),
        "i": np.int32(it_run),
        "early_stopped": bool(stopped),
    }, meta)


def _host_sse(a: np.ndarray, b: np.ndarray) -> float:
    """SSE over host arrays, float64-accumulated in row chunks (no
    cube-size float64 temporary; agrees with the engine's on-device
    float32 tree sums within the trace tolerance)."""
    tot = 0.0
    for lo in range(0, a.shape[0], 8):
        d = (a[lo:lo + 8].astype(np.float64)
             - b[lo:lo + 8].astype(np.float64)).ravel()
        tot += float(np.dot(d, d))
    return tot


def process_row_range(n0: int, nproc: int, pid: int) -> Tuple[int, int]:
    """Balanced axis-0 row range owned by process ``pid`` in a
    multi-host out-of-core run (sizes differ by at most one; the same
    policy as :func:`_slab_bounds`)."""
    base, extra = divmod(n0, nproc)
    g0 = pid * base + min(pid, extra)
    return g0, g0 + base + (1 if pid < extra else 0)


@functools.lru_cache(maxsize=8)
def _neighbor_band_exchange(nproc: int, n_arrays: int, k: int,
                            rest: Tuple[int, ...]):
    """Point-to-point K-row band exchange between axis-0 neighbor
    processes, as one packed ``ppermute`` pair over a process-spanning
    1-device-per-process mesh.

    Each process contributes a ``(n_arrays, 2k, *rest)`` block — its
    arrays' head K rows then tail K rows — and receives the same-shape
    block holding ``[:, :k]`` = its LEFT neighbor's tail band and
    ``[:, k:]`` = its RIGHT neighbor's head band (edge processes receive
    ``ppermute``'s zero fill in the missing slot; their ghost rows don't
    exist, so it is never read). Unlike an allgather this moves each
    band only to the one process that needs it — the transfers ride the
    same XLA collective machinery as the in-core halos, and wire bytes per
    process
    per sweep are O(1) in nproc.

    Reference analog: the MPI ranks' point-to-point boundary sends
    (reference cyTVDN/mpi.py:186-214) — which exchange per-iteration;
    here temporal blocking makes it per-sweep (K iterations).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    by_proc: Dict[int, object] = {}
    for d in jax.devices():
        prev = by_proc.get(d.process_index)
        if prev is None or d.id < prev.id:  # type: ignore[attr-defined]
            by_proc[d.process_index] = d
    devs = np.array([by_proc[p] for p in range(nproc)])
    mesh = Mesh(devs, ("p",))
    sharding = NamedSharding(mesh, P("p"))
    gshape = (nproc, n_arrays, 2 * k) + rest

    def body(b):  # local block: (1, n_arrays, 2k, *rest)
        head, tail = b[:, :, :k], b[:, :, k:]
        from_left = lax.ppermute(
            tail, "p", [(i, i + 1) for i in range(nproc - 1)])
        from_right = lax.ppermute(
            head, "p", [(i + 1, i) for i in range(nproc - 1)])
        return jnp.concatenate([from_left, from_right], axis=2)

    fx = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("p"), out_specs=P("p")))

    def exchange(local_block: np.ndarray, pid: int) -> np.ndarray:
        arr = jax.make_array_from_single_device_arrays(
            gshape, sharding,
            [jax.device_put(local_block[None], devs[pid])])
        out = fx(arr)
        return np.asarray(out.addressable_shards[0].data)[0]

    return exchange


def _d_store_dtype(opts: SolverOptions, n_f: int):
    """Host storage dtype of the FISTA shadow duals: bfloat16 under
    ``lossy_duals`` (halves the d arrays' host RAM and their transfer
    bytes per sweep; the device kernels compute f32 and round on
    writeback — the same cadence as in-core lossy runs)."""
    if opts.lossy_duals and n_f:
        import jax.numpy as jnp

        return np.dtype(jnp.bfloat16)
    return np.dtype(np.float32)


def _slab_bounds(n0: int, n_slabs: int):
    """Balanced split of ``n0`` rows into ``n_slabs`` contiguous slabs
    (sizes differ by at most one — a greedy ceil split can leave an
    undersized tail slab and spuriously reject valid configurations)."""
    n_slabs = max(1, min(n_slabs, n0))
    base, extra = divmod(n0, n_slabs)
    bounds = []
    start = 0
    for i in range(n_slabs):
        stop = start + base + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def solve_outofcore(
    orig: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    reference: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> Dict[str, np.ndarray]:
    """Run the full schedule with host-resident state, streaming slabs.

    Requirements: float32, Jia-Zhao BCs, anisotropic axes; each slab must
    have ≥2 rows.

    ``reference`` (with ``opts.calculate_mse``): per-iteration SSE vs the
    host-resident reference cube (reference cyTVDN/cyTVDN.py:176-181),
    accumulated per slab at write-back — ``mse[0]`` is the input's SSE,
    ``mse[i+1]`` the SSE after iteration ``i`` (the in-core layout).

    ``checkpoint_path``/``checkpoint_every``/``resume``: atomic
    full-state saves every N iterations (utils.checkpoint format) and
    bit-exact resume — the longest-running execution mode gets the same
    failure recovery as the in-core paths. Resuming a completed or
    early-stopped run is an idempotent no-op.
    """
    import jax
    import jax.numpy as jnp

    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    orig = np.ascontiguousarray(orig)
    if orig.dtype != np.float32:
        raise ValueError("out-of-core mode requires float32 data, got "
                         f"{orig.dtype}")
    ndim = opts.ndim
    n0 = orig.shape[0]
    bounds = _slab_bounds(n0, n_slabs)
    if min(b - a for a, b in bounds) < 2:
        raise ValueError("slabs must have at least 2 rows")

    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    stopping = opts.stopping_relative_change
    tk_ratios = fista_tk_ratios(n_f)

    recon = orig.copy()
    accs = [np.zeros_like(orig) for _ in range(ndim)]
    # lossy_duals: the host-resident shadow duals live at bf16 — half
    # the d arrays' host RAM and half their PCIe bytes per sweep (the
    # engine computes f32 and rounds on writeback, same as in-core)
    d_dt = _d_store_dtype(opts, n_f)
    ds = [np.zeros(orig.shape, d_dt) for _ in range(ndim)] if n_f else None
    b_norm = np.zeros(n_total, np.float32)
    delta = np.zeros(n_total, np.float32)
    with_mse = opts.calculate_mse and reference is not None
    mse = np.zeros(n_total + 1, np.float32) if with_mse else None
    if with_mse:
        mse[0] = _host_sse(orig, reference)

    ck_meta = _ckpt_meta(opts, orig.shape, "stream") \
        if checkpoint_path else None
    start = 0
    resumed_stop = False
    if checkpoint_path:
        st = _ckpt_resume(checkpoint_path, resume, ck_meta, orig.shape)
        if st is not None:
            start, resumed_stop = _restore_state(
                st, slice(None), recon, accs, ds if n_f else (),
                b_norm, delta, mse)

    li = jnp.asarray(lambda_inv.astype(np.float32))
    lm = jnp.asarray(lam_mu.astype(np.float32))

    it_run = start
    stopped = resumed_stop
    step = _make_step(opts)
    put = jax.device_put

    # device-resident zero halo row, allocated once
    zero_row = jnp.zeros((1,) + orig.shape[1:], jnp.float32)

    def load_slab(si: int, fista: bool, prev_last_old):
        """Enqueue slab ``si``'s host→device transfers (inputs + halos)
        from *pre-update* host state. Called before slab ``si-1``'s results
        are written back, so the -1 neighbor's last row is still pre-update
        in host RAM (``prev_last_old`` carries it when the write-back has
        already happened — i.e. never, under the 1-slab lookahead, but kept
        for the serial first slab of each sweep)."""
        a0, a1 = bounds[si]
        sl = slice(a0, a1)
        r = recon[sl]
        if si == 0:
            prev0 = r[0:1]                 # JZ edge: zero difference
        else:
            prev0 = prev_last_old
        if si + 1 < len(bounds):
            nb = bounds[si + 1][0]
            next0_recon = recon[nb:nb + 1]
            next0_acc = accs[0][nb:nb + 1]
            next0_d = ds[0][nb:nb + 1] if fista else None
        else:
            next0_recon = r[-1:]
            next0_acc = zero_row
            next0_d = zero_row if fista else None
        # only axis 0 is slab-split; the other axes keep their BC edges
        halos = {
            "prev0": put(np.ascontiguousarray(prev0)),
            "next0_recon": put(np.ascontiguousarray(next0_recon)),
            "next0_acc": put(next0_acc if next0_acc is zero_row
                             else np.ascontiguousarray(next0_acc)),
        }
        if fista:
            # halo d rows widen to f32 host-side (exact; bf16 under
            # lossy_duals) — the recomputed halo row is f32 either way
            halos["next0_d"] = put(next0_d if next0_d is zero_row
                                   else np.ascontiguousarray(
                                       next0_d.astype(np.float32)))
        dev = {
            "orig": put(orig[sl]),
            "recon": put(r),
            "accs": tuple(put(acc[sl]) for acc in accs),
            "ds": tuple(put(d[sl]) for d in ds) if fista else (),
            "halos": halos,
            "prev_last_old": r[-1:].copy(),
        }
        return dev

    def iteration(fista: bool, tk_ratio: float):
        """One full sweep over the slabs, software-pipelined: slab i+1
        transfers in while slab i computes and slab i-1 streams back.
        Returns (bnorm, delta, sse)."""
        bnorm_tot = dnum_tot = dden_tot = 0.0
        sse_tot = 0.0
        tk = jnp.asarray(np.float32(tk_ratio))
        dev = load_slab(0, fista, None)
        pending = None  # (slice, out tuple) awaiting write-back

        def write_back(psl, pout):
            nonlocal bnorm_tot, dnum_tot, dden_tot, sse_tot
            recon_new, accs_new, ds_new, bnorm, dnum, dden = pout
            rn = np.asarray(recon_new)
            recon[psl] = rn
            if with_mse:
                sse_tot += _host_sse(rn, reference[psl])
            for k in range(ndim):
                accs[k][psl] = np.asarray(accs_new[k])
                if fista:
                    ds[k][psl] = np.asarray(ds_new[k])
            bnorm_tot += float(bnorm)
            dnum_tot += float(dnum)
            dden_tot += float(dden)

        for si in range(len(bounds)):
            a0, a1 = bounds[si]
            out = step(
                dev["orig"], dev["recon"], dev["accs"], dev["ds"],
                tk, li, lm, dev["halos"],
                fista=fista,
            )
            prev_last_old = dev["prev_last_old"]
            if si + 1 < len(bounds):
                # enqueue the next slab's transfers while this one computes
                dev = load_slab(si + 1, fista, prev_last_old)
            if pending is not None:
                write_back(*pending)
            pending = (slice(a0, a1), out)
        write_back(*pending)
        # all-zero input: match the in-core 0/0 -> NaN instead of raising
        delta_tot = dnum_tot / dden_tot if dden_tot else float("nan")
        return bnorm_tot, delta_tot, sse_tot

    def maybe_save(done: bool):
        # periodic saves record early_stopped=False — only the terminal
        # save may mark a run resumable-as-finished (a phase-1 stop with
        # a pending unaccelerated phase is NOT terminal)
        if not checkpoint_path:
            return
        if done or (checkpoint_every > 0
                    and it_run % checkpoint_every == 0):
            _ckpt_save(checkpoint_path, ck_meta, it_run, recon, accs,
                       ds if n_f else None, b_norm, delta, mse,
                       done and stopped)

    if not (resumed_stop or start >= n_total):
        for i in range(start, n_f):
            b_norm[i], delta[i], sse_i = iteration(
                True, float(tk_ratios[i]))
            it_run = i + 1
            if with_mse:
                mse[i + 1] = sse_i
            if stopping is not None and delta[i] < stopping:
                stopped = True
                break
            maybe_save(False)
        if n_u:
            stopped = False  # second phase runs regardless (reference)
        for j in range(max(start - n_f, 0), n_u):
            i = j + n_f
            b_norm[i], delta[i], sse_i = iteration(False, 0.0)
            it_run = i + 1
            if with_mse:
                mse[i + 1] = sse_i
            if stopping is not None and delta[i] < stopping:
                stopped = True
                break
            maybe_save(False)
        maybe_save(True)

    out = {
        "recon": recon,
        "b_norm": b_norm,
        "delta": delta,
        "iterations_run": np.int32(it_run),
        "early_stopped": np.bool_(stopped),
    }
    if with_mse:
        out["mse"] = mse
    return out


def solve_outofcore_temporal(
    orig: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    temporal_k: int,
    reference: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> Dict[str, np.ndarray]:
    """Out-of-core solve with temporal blocking: ``temporal_k`` iterations
    per slab residency.

    Each slab is loaded with a ``K``-row margin on every interior side and
    iterated K times on device before its core is written back — host ↔
    device traffic per iteration drops K× (this is what makes out-of-core
    *compute*-bound on a real PCIe host: a 64 GiB-state sweep moves once
    per K iterations). Core results are bit-identical to the serial sweep
    (the boundary light cone is ±1 row/iteration; the margins absorb it).

    Semantics deviations vs ``solve_outofcore`` (documented, opt-in):
    ``b_norm``/``delta`` traces carry true values only at sweep-final
    iterations (zeros between), and early stopping is evaluated at sweep
    granularity — a run that would stop mid-sweep runs to the sweep end.
    Per-iteration MSE (``reference``) follows the same cadence: SSE is
    recorded at sweep-final iterations only (intermediate states are
    never materialized host-side). Sweeps never cross the
    FISTA→unaccelerated phase boundary.
    """
    import jax

    if temporal_k <= 1:
        return solve_outofcore(orig, lambda_inv, lam_mu, opts, n_slabs,
                               reference=reference,
                               checkpoint_path=checkpoint_path,
                               checkpoint_every=checkpoint_every,
                               resume=resume)
    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    orig = np.ascontiguousarray(orig)
    if orig.dtype != np.float32:
        raise ValueError("out-of-core mode requires float32 data")
    ndim = opts.ndim
    n0 = orig.shape[0]
    K = int(temporal_k)
    bounds = _slab_bounds(n0, n_slabs)
    min_core = min(b - a for a, b in bounds)
    if K > min_core:
        # a margin deeper than one neighbor slab would read rows the
        # pipelined write-back has already advanced past iteration T
        raise ValueError(
            f"temporal_k={K} exceeds the smallest slab core ({min_core} "
            f"rows); use fewer slabs or a smaller temporal_k"
        )
    ext = [(max(a - K, 0), min(b + K, n0), a, b) for a, b in bounds]
    for lo, hi, _, _ in ext:
        if hi - lo < 2:
            raise ValueError(
                f"extended slab shape {(hi - lo,) + orig.shape[1:]} "
                "needs at least 2 rows"
            )

    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    stopping = opts.stopping_relative_change
    tk_all = fista_tk_ratios(n_f).astype(np.float32)

    recon = orig.copy()
    accs = [np.zeros_like(orig) for _ in range(ndim)]
    d_dt = _d_store_dtype(opts, n_f)
    ds = [np.zeros(orig.shape, d_dt) for _ in range(ndim)] if n_f else None
    b_norm = np.zeros(n_total, np.float32)
    delta = np.zeros(n_total, np.float32)
    with_mse = opts.calculate_mse and reference is not None
    mse = np.zeros(n_total + 1, np.float32) if with_mse else None
    if with_mse:
        mse[0] = _host_sse(orig, reference)

    ck_meta = _ckpt_meta(opts, orig.shape, f"temporal{K}") \
        if checkpoint_path else None
    start = 0
    resumed_stop = False
    if checkpoint_path:
        st = _ckpt_resume(checkpoint_path, resume, ck_meta, orig.shape)
        if st is not None:
            start, resumed_stop = _restore_state(
                st, slice(None), recon, accs, ds if n_f else (),
                b_norm, delta, mse)

    import jax.numpy as jnp

    li = jnp.asarray(lambda_inv.astype(np.float32))
    lm = jnp.asarray(lam_mu.astype(np.float32))
    chunk = _make_temporal_chunk(opts)
    put = jax.device_put

    @functools.partial(jax.jit, static_argnames=("off", "clen"))
    def core_stats(r, a_list, r_prev, off, clen):
        bn = jnp.zeros((), jnp.float32)
        for a_k in a_list:
            bn = bn + jnp.sum(jnp.abs(a_k[off:off + clen]))
        rc, rp = r[off:off + clen], r_prev[off:off + clen]
        return bn, jnp.sum(jnp.abs(rc - rp)), jnp.sum(jnp.abs(rp))

    def load_ext(si, fista):
        lo, hi, _, _ = ext[si]
        sl = slice(lo, hi)
        return {
            "orig": put(orig[sl]),
            "recon": put(recon[sl]),
            "accs": tuple(put(a[sl]) for a in accs),
            "ds": tuple(put(d[sl]) for d in ds) if fista else (),
        }

    def sweep(fista: bool, tks: np.ndarray):
        """Run len(tks) iterations over all slabs; returns the final
        iteration's (bnorm, delta) over the global domain."""
        tks_d = jnp.asarray(tks)
        bn_t = dn_t = dd_t = 0.0
        dev = load_ext(0, fista)
        pending = None
        for si in range(len(bounds)):
            out = chunk(dev["orig"], dev["recon"], dev["accs"], dev["ds"],
                        tks_d, li, lm,
                        fista=fista)
            if si + 1 < len(bounds):
                dev = load_ext(si + 1, fista)
            if pending is not None:
                bn_t, dn_t, dd_t = _writeback(*pending, bn_t, dn_t, dd_t,
                                              fista)
            pending = (si, out)
        bn_t, dn_t, dd_t = _writeback(*pending, bn_t, dn_t, dd_t, fista)
        return bn_t, (dn_t / dd_t if dd_t else float("nan"))

    def _writeback(si, out, bn_t, dn_t, dd_t, fista):
        lo, hi, a0, a1 = ext[si]
        off, clen = a0 - lo, a1 - a0
        r, a_out, d_out, r_prev = out
        bn, dn, dd = core_stats(r, list(a_out), r_prev, off=off, clen=clen)
        sl = slice(a0, a1)
        recon[sl] = np.asarray(r[off:off + clen])
        for k in range(ndim):
            accs[k][sl] = np.asarray(a_out[k][off:off + clen])
            if fista:
                ds[k][sl] = np.asarray(d_out[k][off:off + clen])
        return bn_t + float(bn), dn_t + float(dn), dd_t + float(dd)

    it_run = start
    stopped = resumed_stop
    next_save = ((start // checkpoint_every + 1) * checkpoint_every
                 if checkpoint_path and checkpoint_every > 0 else None)
    # absolute iteration positions per phase: the unaccelerated phase's
    # trace slots start at n_f regardless of a phase-1 early stop
    # (reference cyTVDN.py:205 `i = j + iterations_FISTA`; the streaming
    # mode and the in-core engine index the same way)
    for fista, count, base_t, tks_phase in (
        (True, n_f, 0, tk_all),
        (False, n_u, n_f, np.zeros(n_u, np.float32)),
    ):
        if resumed_stop or start >= n_total:
            break
        if not count:
            continue
        if not fista:
            stopped = False  # second phase runs regardless (reference)
        t = min(max(start - base_t, 0), count)
        while t < count and not stopped:
            k_t = min(K, count - t)
            bn, dl = sweep(fista, tks_phase[t:t + k_t])
            t += k_t
            it_run = base_t + t
            b_norm[it_run - 1] = bn
            delta[it_run - 1] = dl
            if with_mse:
                mse[it_run] = _host_sse(recon, reference)
            if stopping is not None and dl < stopping:
                stopped = True
            elif next_save is not None and it_run >= next_save:
                _ckpt_save(checkpoint_path, ck_meta, it_run, recon, accs,
                           ds if n_f else None, b_norm, delta, mse,
                           False)
                next_save = (it_run // checkpoint_every + 1) \
                    * checkpoint_every
    if checkpoint_path and not (resumed_stop or start >= n_total):
        _ckpt_save(checkpoint_path, ck_meta, it_run, recon, accs,
                   ds if n_f else None, b_norm, delta, mse, stopped)

    out = {
        "recon": recon,
        "b_norm": b_norm,
        "delta": delta,
        "iterations_run": np.int32(it_run),
        "early_stopped": np.bool_(stopped),
    }
    if with_mse:
        out["mse"] = mse
    return out


def solve_outofcore_sharded_temporal(
    orig: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    temporal_k: int,
    shard_w: int = 0,
    devices=None,
    reference: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> Dict[str, np.ndarray]:
    """Out-of-core solve with each resident slab SHARDED over the local
    devices: the BASELINE config-5 deployment shape (512²×256²: ~640 GiB
    of FISTA state admits no in-core decomposition, so every host streams
    slabs from RAM while its cards split each slab on axis 1 with halo
    exchange).

    Mechanics: the host state is swept in axis-0 slabs with
    ``temporal_k``-row margins exactly like
    :func:`solve_outofcore_temporal`; each extended slab is committed
    under a ``(1, shard_w, …)`` NamedSharding and advanced K iterations
    through the SAME ``run_sharded`` engine path (dynamic ``i_stop``
    caps — one compilation for every slab and sweep), so cross-chip
    axis-1 seams are the engine's exact operand halos and results are
    bit-identical to the serial sweep up to the sharded paths' seam-
    recompute ulps. The K-1st recon is taken from a split-cap call
    (K-1 then 1) so the sweep-final delta is the true core-region
    statistic.

    Per-chip transient memory is ~2× the donated single-device mode
    (``run_sharded`` does not donate its inputs); size ``n_slabs``
    accordingly. ``shard_w = 0`` uses all local devices.
    """
    import jax
    import jax.numpy as jnp

    from cytvdn_tpu.parallel.sharded import run_sharded

    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    orig = np.ascontiguousarray(orig)
    if orig.dtype != np.float32:
        raise ValueError("out-of-core mode requires float32 data")
    devices = tuple(devices if devices is not None else jax.devices())
    if shard_w <= 0:
        shard_w = len(devices)
    if orig.shape[1] % shard_w:
        raise ValueError(
            f"axis-1 extent {orig.shape[1]} not divisible by {shard_w} "
            f"devices")
    ndim = opts.ndim
    n0 = orig.shape[0]
    K = int(temporal_k)
    bounds = _slab_bounds(n0, n_slabs)
    min_core = min(b - a for a, b in bounds)
    if K > min_core:
        raise ValueError(
            f"temporal_k={K} exceeds the smallest slab core ({min_core} "
            f"rows); use fewer slabs or a smaller temporal_k")
    ext = [(max(a - K, 0), min(b + K, n0), a, b) for a, b in bounds]

    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    stopping = opts.stopping_relative_change
    # the engine runs the slab iterations; stopping is evaluated here at
    # sweep granularity on the true core statistics
    import dataclasses

    opts_run = dataclasses.replace(opts, stopping_relative_change=None,
                                   calculate_mse=False)
    shard_t = (1, shard_w) + (1,) * (ndim - 2)

    recon = orig.copy()
    accs = [np.zeros_like(orig) for _ in range(ndim)]
    d_dt = _d_store_dtype(opts, n_f)
    ds = [np.zeros(orig.shape, d_dt) for _ in range(ndim)] if n_f else None
    b_norm = np.zeros(n_total, np.float32)
    delta = np.zeros(n_total, np.float32)
    zeros_tr = np.zeros(n_total, np.float32)
    with_mse = opts.calculate_mse and reference is not None
    mse = np.zeros(n_total + 1, np.float32) if with_mse else None
    if with_mse:
        mse[0] = _host_sse(orig, reference)

    ck_meta = _ckpt_meta(opts, orig.shape, f"sharded_temporal{K}") \
        if checkpoint_path else None
    start = 0
    resumed_stop = False
    if checkpoint_path:
        st = _ckpt_resume(checkpoint_path, resume, ck_meta, orig.shape)
        if st is not None:
            start, resumed_stop = _restore_state(
                st, slice(None), recon, accs, ds if n_f else (),
                b_norm, delta, mse)

    @functools.partial(jax.jit, static_argnames=("off", "clen"))
    def core_stats(r, a_list, r_prev, off, clen):
        bn = jnp.zeros((), jnp.float32)
        for a_k in a_list:
            bn = bn + jnp.sum(jnp.abs(a_k[off:off + clen]))
        rc, rp = r[off:off + clen], r_prev[off:off + clen]
        return bn, jnp.sum(jnp.abs(rc - rp)), jnp.sum(jnp.abs(rp))

    has_ds = n_f > 0  # ds are carried (frozen) through the unacc phase

    def run_slab(orig_slab, state, i_stop):
        return run_sharded(
            orig_slab, lambda_inv, lam_mu, opts_run, shard=shard_t,
            devices=devices, state=state, i_stop=i_stop, keep_state=True)

    def slab_state(si, t):
        lo, hi, _, _ = ext[si]
        sl = slice(lo, hi)

        def dual_slab(a):
            v = a[sl]
            if lo > 0:
                # restore the JZ zero-slab invariant on the slab: the
                # engine's trailing-edge wrap reads local slab 0 of the
                # updated accumulator (exact globally because global
                # slab 0 is identically zero, SURVEY §8.1) — a mid-cube
                # slab's local row 0 holds a nonzero interior value, so
                # zero it. The perturbation lives in the margin row and,
                # under the slab's own JZ edge, STAYS zero through every
                # residency iteration — the wrap then reads the exact 0.
                v = v.copy()
                v[0] = 0.0
            return v

        return {
            "recon": recon[sl],
            "accs": tuple(dual_slab(a) for a in accs),
            "ds": tuple(dual_slab(d) for d in ds) if has_ds else (),
            "b_norm": zeros_tr,
            "delta": zeros_tr,
            "mse": np.zeros((0,), np.float32),
            "i": np.int32(t),
            "tk": np.float32(1.0),
        }

    def _writeback(si, out):
        lo, hi, a0, a1 = ext[si]
        off, clen = a0 - lo, a1 - a0
        sl = slice(a0, a1)
        recon[sl] = np.asarray(out["recon"][off:off + clen])
        for kx in range(ndim):
            accs[kx][sl] = np.asarray(out["accs"][kx][off:off + clen])
            if has_ds:
                ds[kx][sl] = np.asarray(out["ds"][kx][off:off + clen])

    def sweep(t: int, k_t: int):
        bn_t = dn_t = dd_t = 0.0
        # write-back is deferred one slab: slab si+1's LEFT margin rows
        # are slab si's core tail and must still hold PRE-sweep
        # (iteration-T) values when si+1's state is committed — wrong
        # margin values would contaminate the core within the K-row
        # light cone (the same ordering the single-device pipeline keeps)
        pending = None
        for si in range(len(bounds)):
            lo, hi, a0, a1 = ext[si]
            off, clen = a0 - lo, a1 - a0
            state = slab_state(si, t)
            orig_slab = orig[lo:hi]
            if k_t > 1:
                mid = run_slab(orig_slab, state, i_stop=t + k_t - 1)
                state2 = {
                    "recon": mid["recon"], "accs": mid["accs"],
                    "ds": mid["ds"], "b_norm": mid["b_norm"],
                    "delta": mid["delta"],
                    "mse": np.zeros((0,), np.float32),
                    "i": mid["i"], "tk": mid["tk"],
                }
                r_prev = mid["recon"]
            else:
                state2 = state
                r_prev = jnp.asarray(state["recon"])
            out = run_slab(orig_slab, state2, i_stop=t + k_t)
            bn, dn, dd = core_stats(out["recon"], list(out["accs"]),
                                    r_prev, off=off, clen=clen)
            # the float() fetches force the slab's program to complete,
            # so its inputs are committed before the host mutates them
            bn_t += float(bn)
            dn_t += float(dn)
            dd_t += float(dd)
            if pending is not None:
                _writeback(*pending)
            pending = (si, out)
        _writeback(*pending)
        return bn_t, (dn_t / dd_t if dd_t else float("nan"))

    it_run = start
    stopped = resumed_stop
    next_save = ((start // checkpoint_every + 1) * checkpoint_every
                 if checkpoint_path and checkpoint_every > 0 else None)
    for fista, count, base_t in ((True, n_f, 0), (False, n_u, n_f)):
        if resumed_stop or start >= n_total:
            break
        if not count:
            continue
        if not fista:
            stopped = False  # second phase runs regardless (reference)
        t = min(max(start, base_t), base_t + count)
        while t < base_t + count and not stopped:
            k_t = min(K, base_t + count - t)
            bn, dl = sweep(t, k_t)
            t += k_t
            it_run = t
            b_norm[it_run - 1] = bn
            delta[it_run - 1] = dl
            if with_mse:
                # sweep-final cadence, like the traces (the temporal-mode
                # semantics deviation documented above)
                mse[it_run] = _host_sse(recon, reference)
            if stopping is not None and dl < stopping:
                stopped = True
            elif next_save is not None and it_run >= next_save:
                _ckpt_save(checkpoint_path, ck_meta, it_run, recon, accs,
                           ds if n_f else None, b_norm, delta, mse,
                           False)
                next_save = (it_run // checkpoint_every + 1) \
                    * checkpoint_every
    if checkpoint_path and not (resumed_stop or start >= n_total):
        _ckpt_save(checkpoint_path, ck_meta, it_run, recon, accs,
                   ds if n_f else None, b_norm, delta, mse, stopped)

    out = {
        "recon": recon,
        "b_norm": b_norm,
        "delta": delta,
        "iterations_run": np.int32(it_run),
        "early_stopped": np.bool_(stopped),
    }
    if with_mse:
        out["mse"] = mse
    return out


def solve_outofcore_multihost(
    orig_local: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    temporal_k: int,
    global_rows: Tuple[int, int, int],
    shard_w: int = 0,
    devices=None,
    reference_local: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> Dict[str, np.ndarray]:
    """MULTI-HOST out-of-core solve: each process streams ITS OWN axis-0
    row range of the host-resident state, sharding each resident slab
    over its local cards — the full config-5 deployment shape across
    several hosts, each holding a slice of the ~640 GiB state in its own
    RAM (reference analog: the MPI ranks' row-range ownership,
    mpi.py:130-153).

    ``orig_local`` holds only this process's rows; ``global_rows =
    (g0, g1, n0)`` declares the owned range and the global axis-0
    extent (ranges must tile [0, n0) in process order — validated by an
    allgather).

    Mechanics: because a TV iteration reads only iteration-``t`` state
    (Jacobi-style — the serial sweep's deferred write-back preserves
    exactly this), the cross-process coupling per sweep is ONE exchange
    of the K-row pre-sweep boundary bands of every state array
    (``multihost_utils.process_allgather``). Each process keeps K ghost
    rows per interior edge, refreshed at sweep start, and sweeps its own
    slabs with K-row margins exactly like
    :func:`solve_outofcore_sharded_temporal` (the margins' boundary
    light cone never reaches the core; ghost rows are never written).
    ``b_norm``/``delta``/SSE partials are allgather-summed, so every
    process computes the identical sweep-granular stop decision (the
    multi-host control-flow invariant).

    Checkpointing saves one self-contained part per process
    (``path.ooc<p>`` — no shared filesystem needed) with a
    cross-process generation agreement check on resume: a mixed set
    (crash mid-save) is collectively discarded and the run restarts
    fresh, the same recovery utils.checkpoint uses.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from cytvdn_tpu.parallel.sharded import run_sharded

    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    orig_local = np.ascontiguousarray(orig_local)
    if orig_local.dtype != np.float32:
        raise ValueError("out-of-core mode requires float32 data")
    g0, g1, n0 = (int(v) for v in global_rows)
    m = g1 - g0
    if orig_local.shape[0] != m:
        raise ValueError(
            f"orig_local has {orig_local.shape[0]} rows; global_rows "
            f"declares {m}")
    nproc = jax.process_count()
    pid = jax.process_index()
    # every process must declare a range; together they must tile [0, n0)
    ranges = multihost_utils.process_allgather(
        np.asarray([g0, g1], np.int64))
    ranges = np.asarray(ranges).reshape(nproc, 2)
    expect = 0
    for q in range(nproc):
        if int(ranges[q, 0]) != expect:
            raise ValueError(
                f"process ranges {ranges.tolist()} do not tile [0, {n0}) "
                f"in process order")
        expect = int(ranges[q, 1])
    if expect != n0:
        raise ValueError(
            f"process ranges {ranges.tolist()} do not cover [0, {n0})")

    devices = tuple(devices if devices is not None
                    else jax.local_devices())
    if shard_w <= 0:
        shard_w = len(devices)
    if orig_local.shape[1] % shard_w:
        raise ValueError(
            f"axis-1 extent {orig_local.shape[1]} not divisible by "
            f"{shard_w} devices")
    ndim = opts.ndim
    K = int(temporal_k)
    bounds = _slab_bounds(m, n_slabs)
    min_core = min(b - a for a, b in bounds)
    if K > min_core or K > m:
        raise ValueError(
            f"temporal_k={K} exceeds the smallest local slab core "
            f"({min_core} rows of {m}); use fewer slabs or a smaller "
            f"temporal_k")
    tg = K if g0 > 0 else 0          # top ghost rows (from process pid-1)
    bg = K if g1 < n0 else 0         # bottom ghost rows (from pid+1)
    rest = orig_local.shape[1:]

    def padded():
        return np.zeros((tg + m + bg,) + rest, np.float32)

    own = slice(tg, tg + m)
    # padded row r is global row g0 - tg + r
    ext = [(max(tg + a - K, 0), min(tg + b + K, tg + m + bg), a, b)
           for a, b in bounds]

    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    stopping = opts.stopping_relative_change
    import dataclasses

    opts_run = dataclasses.replace(opts, stopping_relative_change=None,
                                   calculate_mse=False)
    shard_t = (1, shard_w) + (1,) * (ndim - 2)

    orig_p = padded()
    orig_p[own] = orig_local
    recon = padded()
    recon[own] = orig_local
    accs = [padded() for _ in range(ndim)]
    d_dt = _d_store_dtype(opts, n_f)
    ds = [padded().astype(d_dt) for _ in range(ndim)] if n_f else None
    has_ds = n_f > 0
    b_norm = np.zeros(n_total, np.float32)
    delta = np.zeros(n_total, np.float32)
    zeros_tr = np.zeros(n_total, np.float32)
    with_mse = opts.calculate_mse and reference_local is not None
    mse = np.zeros(n_total + 1, np.float32) if with_mse else None

    def gsum(*vals) -> Tuple[float, ...]:
        got = multihost_utils.process_allgather(
            np.asarray(vals, np.float64))
        return tuple(float(s) for s in np.asarray(got).sum(axis=0))

    if with_mse:
        mse[0] = gsum(_host_sse(orig_local, reference_local))[0]

    state_arrays = [recon] + accs + (ds if has_ds else [])

    def exchange(arrays):
        """Refresh ghost rows from the neighbors' pre-sweep bands:
        ONE packed neighbor-only ``ppermute`` pair over a
        process-spanning mesh (``_neighbor_band_exchange``). All arrays'
        head+tail K-row bands ride a single collective, and each
        process's bands travel only to its two axis-0 neighbors — O(1)
        network traffic per process per sweep, vs the O(nproc) an allgather
        would move (at the config-5 geometry, 2K rows of a 512²×256²
        cube are ~1.3 GB/process: neighbor-only halves the wire bytes at
        nproc=2 and wins linearly from there). Host transient is
        ~3 × n_arrays × 2K rows (send block + device shard + result) —
        independent of nproc, and small next to a slab."""
        if nproc == 1:
            return
        send = np.stack(
            [np.concatenate([x[tg:tg + K], x[tg + m - K:tg + m]])
             .astype(np.float32)  # bf16 d bands widen exactly
             for x in arrays])
        fx = _neighbor_band_exchange(nproc, len(arrays), K, rest)
        got = fx(send, pid)
        for j, x in enumerate(arrays):
            # f32 -> bf16 ghost-row narrowing is exact: the bands came
            # off the neighbor's bf16 grid
            if tg:
                x[:tg] = got[j, :K].astype(x.dtype)
            if bg:
                x[tg + m:] = got[j, K:].astype(x.dtype)
        del got

    exchange([orig_p])  # orig is constant: ghost rows fetched once

    ck_meta = None
    start = 0
    resumed_stop = False
    ck_path_p = f"{checkpoint_path}.ooc{pid}" if checkpoint_path else None
    if checkpoint_path:
        ck_meta = {**_ckpt_meta(opts, orig_local.shape,
                                f"multihost_temporal{K}"),
                   "proc": pid, "nproc": nproc,
                   "grows": [g0, g1, n0]}
        # a per-process meta mismatch must fail COLLECTIVELY: raising on
        # one process while its peers enter the allgather would hang the
        # job (the multi-host control-flow invariant, CLAUDE.md) — so
        # the local verdict (0 = no part, 1 = part found, 2 = meta
        # mismatch) rides the agreement allgather and every process
        # takes the same branch
        err: Optional[Exception] = None
        st = None
        try:
            st = _ckpt_resume(ck_path_p, resume, ck_meta,
                              orig_local.shape)
        except ValueError as e:
            err = e
        have = np.asarray([
            2 if err is not None else (1 if st is not None else 0),
            int(st["i"]) if st is not None else -1], np.int64)
        allst = np.asarray(multihost_utils.process_allgather(have))
        if int(allst[:, 0].max()) == 2:
            raise ValueError(
                "multihost out-of-core resume rejected on at least one "
                "process: " + (str(err) if err is not None
                               else "a peer's checkpoint meta does not "
                                    "match this run"))
        # all processes must hold the SAME generation; otherwise discard
        # collectively (every process sees the same allgather and takes
        # the same branch)
        if int(allst[:, 0].min()) == 1 \
                and int(allst[:, 1].min()) == int(allst[:, 1].max()):
            start, resumed_stop = _restore_state(
                st, own, recon, accs, ds if has_ds else (),
                b_norm, delta, mse)
        elif int(allst[:, 0].max()) == 1 and st is not None:
            import warnings

            warnings.warn(
                "multihost out-of-core checkpoint parts disagree or are "
                "incomplete — discarding and restarting fresh",
                stacklevel=2)

    def save(it_now, terminal_stop):
        _ckpt_save(ck_path_p, ck_meta, it_now, recon[own],
                   [a[own] for a in accs],
                   [d[own] for d in ds] if has_ds else None,
                   b_norm, delta, mse, terminal_stop)
        # no process may treat this generation as resumable until every
        # part of it exists
        multihost_utils.sync_global_devices("cytv_ooc_ckpt_saved")
        if _POST_CKPT_HOOK is not None:
            _POST_CKPT_HOOK(it_now)

    @functools.partial(jax.jit, static_argnames=("off", "clen"))
    def core_stats(r, a_list, r_prev, off, clen):
        bn = jnp.zeros((), jnp.float32)
        for a_k in a_list:
            bn = bn + jnp.sum(jnp.abs(a_k[off:off + clen]))
        rc, rp = r[off:off + clen], r_prev[off:off + clen]
        return bn, jnp.sum(jnp.abs(rc - rp)), jnp.sum(jnp.abs(rp))

    def run_slab(orig_slab, state, i_stop):
        return run_sharded(
            orig_slab, lambda_inv, lam_mu, opts_run, shard=shard_t,
            devices=devices, state=state, i_stop=i_stop, keep_state=True)

    def slab_state(si, t):
        lo, hi, _, _ = ext[si]
        sl = slice(lo, hi)

        def dual_slab(a):
            v = a[sl]
            if g0 - tg + lo > 0:
                # JZ zero-slab restoration keyed on the GLOBAL position
                # (solve_outofcore_sharded_temporal's scheme): a slab
                # whose first padded row is global row 0 keeps the true
                # zero slab; any other zeroes its local row 0 so the
                # engine's trailing-edge wrap reads an exact 0
                v = v.copy()
                v[0] = 0.0
            return v

        return {
            "recon": recon[sl],
            "accs": tuple(dual_slab(a) for a in accs),
            "ds": tuple(dual_slab(d) for d in ds) if has_ds else (),
            "b_norm": zeros_tr,
            "delta": zeros_tr,
            "mse": np.zeros((0,), np.float32),
            "i": np.int32(t),
            "tk": np.float32(1.0),
        }

    def _writeback(si, out):
        lo, hi, a0, a1 = ext[si]
        off, clen = (tg + a0) - lo, a1 - a0
        sl = slice(tg + a0, tg + a1)
        recon[sl] = np.asarray(out["recon"][off:off + clen])
        for kx in range(ndim):
            accs[kx][sl] = np.asarray(out["accs"][kx][off:off + clen])
            if has_ds:
                ds[kx][sl] = np.asarray(out["ds"][kx][off:off + clen])

    def sweep(t: int, k_t: int):
        exchange(state_arrays)  # pre-sweep bands into the ghost rows
        bn_t = dn_t = dd_t = 0.0
        pending = None  # deferred write-back, same discipline as 1-proc
        for si in range(len(bounds)):
            lo, hi, a0, a1 = ext[si]
            off, clen = (tg + a0) - lo, a1 - a0
            state = slab_state(si, t)
            orig_slab = orig_p[lo:hi]
            if k_t > 1:
                mid = run_slab(orig_slab, state, i_stop=t + k_t - 1)
                state2 = {
                    "recon": mid["recon"], "accs": mid["accs"],
                    "ds": mid["ds"], "b_norm": mid["b_norm"],
                    "delta": mid["delta"],
                    "mse": np.zeros((0,), np.float32),
                    "i": mid["i"], "tk": mid["tk"],
                }
                r_prev = mid["recon"]
            else:
                state2 = state
                r_prev = jnp.asarray(state["recon"])
            out = run_slab(orig_slab, state2, i_stop=t + k_t)
            bn, dn, dd = core_stats(out["recon"], list(out["accs"]),
                                    r_prev, off=off, clen=clen)
            bn_t += float(bn)
            dn_t += float(dn)
            dd_t += float(dd)
            if pending is not None:
                _writeback(*pending)
            pending = (si, out)
        _writeback(*pending)
        bn_g, dn_g, dd_g = gsum(bn_t, dn_t, dd_t)
        return bn_g, (dn_g / dd_g if dd_g else float("nan"))

    it_run = start
    stopped = resumed_stop
    next_save = ((start // checkpoint_every + 1) * checkpoint_every
                 if checkpoint_path and checkpoint_every > 0 else None)
    for fista, count, base_t in ((True, n_f, 0), (False, n_u, n_f)):
        if resumed_stop or start >= n_total:
            break
        if not count:
            continue
        if not fista:
            stopped = False  # second phase runs regardless (reference)
        t = min(max(start, base_t), base_t + count)
        while t < base_t + count and not stopped:
            k_t = min(K, base_t + count - t)
            bn, dl = sweep(t, k_t)
            t += k_t
            it_run = t
            b_norm[it_run - 1] = bn
            delta[it_run - 1] = dl
            if with_mse:
                mse[it_run] = gsum(
                    _host_sse(recon[own], reference_local))[0]
            if stopping is not None and dl < stopping:
                stopped = True
            elif next_save is not None and it_run >= next_save:
                save(it_run, False)
                next_save = (it_run // checkpoint_every + 1) \
                    * checkpoint_every
    if checkpoint_path and not (resumed_stop or start >= n_total):
        save(it_run, stopped)

    out = {
        "recon": np.ascontiguousarray(recon[own]),
        "b_norm": b_norm,
        "delta": delta,
        "iterations_run": np.int32(it_run),
        "early_stopped": np.bool_(stopped),
        "global_rows": np.asarray([g0, g1, n0], np.int64),
    }
    if with_mse:
        out["mse"] = mse
    return out


def denoise_outofcore(
    datacube: np.ndarray,
    mu,
    lam=None,
    iterations=10,
    FISTA: bool = True,
    stopping_relative_change: Optional[float] = None,
    n_slabs: int = 4,
    quiet: bool = True,
    temporal_k: int = 1,
    shard_w: int = 1,
    devices=None,
    reference_data: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    lossy_duals: bool = False,
):
    """User-level out-of-core denoising (float32, Jia-Zhao, anisotropic).

    ``temporal_k > 1`` enables temporal blocking: K iterations per slab
    residency, cutting host↔device traffic per iteration K× (see
    :func:`solve_outofcore_temporal` for the trace/early-stop semantics).

    ``shard_w > 1`` additionally shards each resident slab over that many
    local devices on axis 1 with halo exchange — the BASELINE config-5
    deployment shape (a host streams slabs from RAM while its cards split
    each slab); ``shard_w=0`` uses all local devices. See :func:`solve_outofcore_sharded_temporal`.

    Returns ``(recon, b_norm, delta)`` like :func:`cytvdn_tpu.denoise`,
    plus the ``mse`` trace when ``reference_data`` is given (per
    iteration in the streaming mode; sweep-final cadence under temporal
    blocking, like the traces).
    """
    from cytvdn_tpu.api import _validate_and_derive

    ndim = np.asarray(datacube).ndim
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
    )
    if not quiet:
        n_state = 2 + 2 * ndim if FISTA else 2 + ndim
        per_slab = datacube.nbytes * n_state / n_slabs / 2**30
        print(f"out-of-core: {n_slabs} slabs, ~{per_slab:.2f} GiB of device "
              f"memory per slab (host holds the full "
              f"{datacube.nbytes * n_state / 2**30:.1f} GiB state)")
    n_f, n_u = normalize_iterations(iterations, FISTA)
    with_mse = reference_data is not None
    if with_mse:
        reference_data = np.ascontiguousarray(reference_data,
                                              dtype=np.float32)
        if reference_data.shape != datacube.shape:
            raise ValueError("reference_data shape mismatch")
    opts = SolverOptions(
        ndim=ndim,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        stopping_relative_change=stopping_relative_change,
        calculate_mse=with_mse,
        lossy_duals=lossy_duals,
    )
    ck = dict(checkpoint_path=checkpoint_path,
              checkpoint_every=checkpoint_every, resume=resume)
    if shard_w != 1:
        out = solve_outofcore_sharded_temporal(
            datacube, lambda_inv, lam_mu, opts, n_slabs,
            max(temporal_k, 1), shard_w=shard_w, devices=devices,
            reference=reference_data, **ck)
    elif temporal_k > 1:
        out = solve_outofcore_temporal(datacube, lambda_inv, lam_mu, opts,
                                       n_slabs, temporal_k,
                                       reference=reference_data, **ck)
    else:
        out = solve_outofcore(datacube, lambda_inv, lam_mu, opts, n_slabs,
                              reference=reference_data, **ck)
    if with_mse:
        return out["recon"], out["b_norm"], out["delta"], out["mse"]
    return out["recon"], out["b_norm"], out["delta"]
