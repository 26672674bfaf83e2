"""The TV iteration as two in-place GPU passes (Pallas, Triton route).

XLA compiles the ops path (``ops/stencil.py``) into many fusions per
iteration: each shifted operand is materialized by its own concatenate,
and the while loop copies carried buffers. This step moves the minimum a
two-pass iteration can:

1. :func:`accumulator_pass` — every per-axis dual update. Reads ``recon``
   (its backward neighbours come from L1/L2 or, along axis 0, from a
   register carry), reads and rewrites each ``b_k`` [and ``d_k``] in place.
2. :func:`recon_pass` — the reconstruction update. Reads ``orig``,
   ``recon`` and each *updated* ``b_k`` (forward neighbours from L1/L2, or
   along axis 0 from a carry), rewrites ``recon`` in place.

That is 4n+1 plus n+3 traversals of a cube-size array: 5n+4 for FISTA
(24 in 4D) and 3n+4 without it (``utils/perf.py``). Neither pass reads a
cell another program writes, so both run in place at the 2n+2-array
memory floor of the ops path.

Layout: arrays are viewed flat. A program owns ``block`` consecutive
elements of one axis-0 slab's flat index (axes 1..n-1) and walks
``chunk`` consecutive axis-0 slabs in order (fewer on small cubes, so the
launch still fills the card), so the axis-0 neighbour is
the previous (pass 1) or next (pass 2) loop step's operand. Each program
writes one partial sum per statistic; they are summed outside.

Covered configuration (:func:`covers`): float32, Jia-Zhao boundaries,
anisotropic, exact duals, a single device, at most :data:`MAX_SIZE`
elements (the kernels index the flat arrays in int32). Everything else runs the ops
path. The arithmetic is the ops path's, operation for operation; the
states need not match bitwise (the GPU compiler may contract
``d + t·(d - d_old)`` into an FMA where XLA does not), and the statistics
are summed in another order.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cytvdn_tpu.config import BCMode, SolverOptions

Array = jax.Array

#: elements of a slab's flat index per program (a power of two, as
#: Triton's block shapes must be)
BLOCK = 1024
#: most axis-0 slabs a program walks
CHUNK = 32
#: fewest programs a launch should have: several per SM of a 132-SM H100,
#: so small cubes split axis 0 finer rather than leave SMs idle
MIN_PROGRAMS = 1024
NUM_WARPS = 4
#: most elements a cube may have: the kernels compute flat offsets in
#: int32, up to ``size + BLOCK - 1`` on the masked tail of the last slab
MAX_SIZE = 2**31 - BLOCK


def covers(opts: SolverOptions, dtype, size: int) -> bool:
    """Whether the GPU step implements this configuration for a cube of
    ``size`` elements (the caller checks the device and that the run is on
    one device)."""
    return (jnp.dtype(dtype) == jnp.float32
            and size <= MAX_SIZE
            and opts.bc_mode == BCMode.JIA_ZHAO
            and not opts.isotropic_R and not opts.isotropic_Q
            and not opts.lossy_duals)


def _geometry(shape: Sequence[int], block: int, chunk: Optional[int]):
    """``(inner, chunk, grid)``: the slab size, the axis-0 slabs per
    program (``chunk``, or the most up to :data:`CHUNK` that still gives
    :data:`MIN_PROGRAMS` programs) and the launch grid."""
    inner = 1
    for n in shape[1:]:
        inner *= n
    n_blocks = pl.cdiv(inner, block)
    if chunk is None:
        chunk = max(1, min(CHUNK, n_blocks * shape[0] // MIN_PROGRAMS))
    return inner, chunk, (n_blocks, pl.cdiv(shape[0], chunk))


def _lanes(shape, inner, block):
    """This program's flat slab indices, their mask, and per axis k ≥ 1
    the coordinate along k and the stride of k."""
    j = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    m = j < inner
    axes = []
    stride = inner
    for n_k in shape[1:]:
        stride //= n_k
        axes.append((lax.rem(lax.div(j, jnp.int32(stride)),
                             jnp.int32(n_k)), stride, n_k))
    return j, m, axes


def _slabs(n0: int, chunk: int):
    lo = pl.program_id(1) * chunk
    return lo, jnp.minimum(lo + chunk, n0)


def _part_index():
    return pl.program_id(0) * pl.num_programs(1) + pl.program_id(1)


def _accumulator_kernel(li_ref, tk_ref, a_ref, *refs, shape, block, chunk,
                        fista):
    n = len(shape)
    n_in = 2 * n if fista else n
    b_in, d_in = refs[:n], refs[n:n_in]
    b_out, d_out = refs[n_in:n_in + n], refs[n_in + n:2 * n_in]
    part_ref = refs[2 * n_in]
    inner = 1
    for s in shape[1:]:
        inner *= s
    j, m, axes = _lanes(shape, inner, block)
    lo, hi = _slabs(shape[0], chunk)
    clips = [li_ref[k] for k in range(n)]
    t = tk_ref[0] if fista else None
    # backward neighbour along axis k ≥ 1 (Jia-Zhao: none at coordinate 0)
    prev = []
    for coord, stride, _ in axes:
        ok = jnp.logical_and(m, coord > 0)
        prev.append((ok, jnp.where(ok, j - stride, 0)))

    def load(ref, off, mask=m):
        return plgpu.load(ref.at[off], mask=mask, other=0.0)

    # axis 0: the slab before ``lo`` (itself at slab 0, where the
    # difference vanishes: a_0 - a_0 = 0, as the ops path computes it)
    a0 = load(a_ref, jnp.maximum(lo - 1, 0) * inner + j)

    def body(i0, carry):
        a_prev, acc = carry
        base = i0 * inner
        a = load(a_ref, base + j)
        for k in range(n):
            if k == 0:
                diff = a - a_prev
            else:
                ok, off = prev[k - 1]
                diff = jnp.where(ok, a - load(a_ref, base + off, ok), 0.0)
            b = load(b_in[k], base + j)
            d_new = jnp.minimum(jnp.maximum(diff + b, -clips[k]), clips[k])
            if fista:
                d_old = load(d_in[k], base + j)
                b_new = d_new + t * (d_new - d_old)
                plgpu.store(d_out[k].at[base + j], d_new, mask=m)
            else:
                b_new = d_new
            plgpu.store(b_out[k].at[base + j], b_new, mask=m)
            acc = acc + jnp.where(m, jnp.abs(b_new), 0.0)
        return a, acc

    _, acc = lax.fori_loop(lo, hi, body,
                           (a0, jnp.zeros((block,), jnp.float32)))
    part_ref[_part_index()] = jnp.sum(acc)


def _recon_kernel(lm_ref, orig_ref, r_ref, *refs, shape, block, chunk):
    n = len(shape)
    b_ref = refs[:n]
    r_out, delta_ref, norm_ref = refs[n:]
    inner = 1
    for s in shape[1:]:
        inner *= s
    j, m, axes = _lanes(shape, inner, block)
    lo, hi = _slabs(shape[0], chunk)
    weights = [lm_ref[k] for k in range(n)]
    # forward neighbour along axis k ≥ 1; past the last coordinate it is
    # coordinate 0 (Jia-Zhao and periodic read the same slab)
    nxt = [jnp.where(coord == n_k - 1, j - (n_k - 1) * stride, j + stride)
           for coord, stride, n_k in axes]

    def load(ref, off):
        return plgpu.load(ref.at[off], mask=m, other=0.0)

    def body(i0, carry):
        b0, acc_delta, acc_norm = carry
        base = i0 * inner
        o = load(orig_ref, base + j)
        r = load(r_ref, base + j)
        b0_next = load(b_ref[0], jnp.where(i0 + 1 < shape[0], i0 + 1, 0)
                       * inner + j)
        div = weights[0] * (b0 - b0_next)
        for k in range(1, n):
            div = div + weights[k] * (load(b_ref[k], base + j)
                                      - load(b_ref[k], base + nxt[k - 1]))
        r_new = o - div
        plgpu.store(r_out.at[base + j], r_new, mask=m)
        acc_delta = acc_delta + jnp.where(m, jnp.abs(r_new - r), 0.0)
        acc_norm = acc_norm + jnp.where(m, jnp.abs(r), 0.0)
        return b0_next, acc_delta, acc_norm

    zeros = jnp.zeros((block,), jnp.float32)
    b0 = load(b_ref[0], lo * inner + j)
    _, acc_delta, acc_norm = lax.fori_loop(lo, hi, body, (b0, zeros, zeros))
    delta_ref[_part_index()] = jnp.sum(acc_delta)
    norm_ref[_part_index()] = jnp.sum(acc_norm)


def _call(kernel, name, n_out_arrays, flat_size, grid, parts, aliases,
          interpret, *args):
    out_shape = ([jax.ShapeDtypeStruct((flat_size,), jnp.float32)]
                 * n_out_arrays
                 + [jax.ShapeDtypeStruct((grid[0] * grid[1],), jnp.float32)]
                 * parts)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=grid,
        input_output_aliases=aliases,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        backend="triton",
        interpret=interpret,
        name=name,
    )(*args)


def accumulator_pass(recon: Array, accs: Tuple[Array, ...],
                     ds: Optional[Tuple[Array, ...]], tk_ratio,
                     lambda_inv: Array, *, block: int = BLOCK,
                     chunk: Optional[int] = None, interpret: bool = False):
    """All per-axis dual updates (``ops.accumulator_update[_fista]`` on
    every axis, Jia-Zhao). Returns ``(accs_new, ds_new, bnorm)``; ``ds_new``
    is None without FISTA."""
    shape = recon.shape
    n = len(shape)
    fista = ds is not None
    inner, chunk, grid = _geometry(shape, block, chunk)
    size = recon.size
    flat = [x.reshape(size) for x in (*accs, *(ds or ()))]
    tk = (jnp.zeros((1,), jnp.float32) if tk_ratio is None
          else jnp.reshape(tk_ratio, (1,)).astype(jnp.float32))
    kernel = functools.partial(_accumulator_kernel, shape=shape, block=block,
                               chunk=chunk, fista=fista)
    outs = _call(kernel, "tv_accumulators", len(flat), size, grid, 1,
                 {3 + i: i for i in range(len(flat))}, interpret,
                 lambda_inv.astype(jnp.float32), tk, recon.reshape(size),
                 *flat)
    accs_new = tuple(x.reshape(shape) for x in outs[:n])
    ds_new = tuple(x.reshape(shape) for x in outs[n:2 * n]) if fista \
        else None
    return accs_new, ds_new, jnp.sum(outs[-1])


def recon_pass(orig: Array, recon: Array, accs: Tuple[Array, ...],
               lam_mu: Array, *, block: int = BLOCK,
               chunk: Optional[int] = None, interpret: bool = False):
    """``ops.datacube_update`` (Jia-Zhao). Returns
    ``(recon_new, delta_num, recon_norm)``."""
    shape = recon.shape
    inner, chunk, grid = _geometry(shape, block, chunk)
    size = recon.size
    kernel = functools.partial(_recon_kernel, shape=shape, block=block,
                               chunk=chunk)
    r_new, delta, norm = _call(
        kernel, "tv_recon", 1, size, grid, 2, {2: 0}, interpret,
        lam_mu.astype(jnp.float32), orig.reshape(size), recon.reshape(size),
        *(b.reshape(size) for b in accs))
    return r_new.reshape(shape), jnp.sum(delta), jnp.sum(norm)


def gpu_step(orig, recon, accs, ds, tk_ratio, lambda_inv, lam_mu, *,
             block: int = BLOCK, chunk: Optional[int] = None,
             interpret: bool = False):
    """One full iteration, the engine's ``step_partials`` contract on one
    device: ``(recon_new, accs_new, ds_new, bnorm, delta_num, recon_norm)``."""
    accs_new, ds_new, bnorm = accumulator_pass(
        recon, accs, ds, tk_ratio, lambda_inv, block=block, chunk=chunk,
        interpret=interpret)
    recon_new, delta_num, recon_norm = recon_pass(
        orig, recon, accs_new, lam_mu, block=block, chunk=chunk,
        interpret=interpret)
    return recon_new, accs_new, ds_new, bnorm, delta_num, recon_norm
