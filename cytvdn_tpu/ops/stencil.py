"""Pure-JAX stencil ops — the executable spec of the TV iteration.

These are rank-generic (3D/4D/any-D), functional re-designs of the
reference's in-place Cython/OpenMP kernels:

- :func:`accumulator_update`        ⇔ ``accumulator_update_{3D,4D}``
  (reference cyTVDN/anisotropic.pyx:17-84, 169-237)
- :func:`accumulator_update_fista`  ⇔ ``accumulator_update_{3D,4D}_FISTA``
  (reference cyTVDN/anisotropic.pyx:89-164, 243-317)
- :func:`iso_accumulator_update`    ⇔ ``iso_accumulator_update_4D``
  (reference cyTVDN/halfisotropic.pyx:17-97)
- :func:`iso_accumulator_update_fista` ⇔ ``iso_accumulator_update_4D_FISTA``
  (reference cyTVDN/halfisotropic.pyx:102-188)
- :func:`datacube_update`           ⇔ ``datacube_update_{3D,4D}``
  (reference cyTVDN/utils.pyx:54-125, 131-199)
- :func:`sum_square_error`          ⇔ ``sum_square_error_{3D,4D}``
  (reference cyTVDN/utils.pyx:14-49)

Design notes:

- Everything is functional: updated arrays are returned, never mutated.
  Under ``jit`` with buffer donation XLA performs the updates in place.
- Every op optionally accepts *operand halos* — one-slab neighbor arrays for
  the boundary of each difference operator. This is how the sharded solver
  (``cytvdn_tpu.parallel``) reuses the exact same code: halos arrive via
  ``lax.ppermute`` and are passed here, so the distributed iteration is
  structurally incapable of the reference's seam bug (the reference reuses
  state slots for halo storage; see SURVEY.md §8.3).
- Reductions (``norm``, ``delta`` numerator/denominator) use XLA tree sums:
  deterministic, unlike the reference's OpenMP-reduction ordering
  (reference cyTVDN/anisotropic.pyx:53).
- The mirror boundary condition of the reconstruction update is implemented
  *correctly* (forward-difference zero at the trailing edge); the reference's
  mirror branch is buggy (reference cyTVDN/utils.pyx:117-120, 192-197).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from cytvdn_tpu.config import BCMode

Array = jax.Array


def _slab(a: Array, ax: int, idx: int) -> Array:
    """One-thick slab ``a[..., idx:idx+1, ...]`` along axis ``ax``."""
    if idx < 0:
        idx += a.shape[ax]
    return lax.slice_in_dim(a, idx, idx + 1, axis=ax)


def shift_backward(
    a: Array,
    ax: int,
    bc: BCMode,
    halo_prev: Optional[Array] = None,
) -> Array:
    """Return ``s`` with ``s_i = a_{i-1}`` along ``ax``.

    The boundary slab ``s_0`` is, in order of precedence:

    - ``halo_prev`` (the neighbor shard's last slab) when given — used by the
      sharded solver so that ``a_i - s_i`` is the true global backward
      difference at a shard seam;
    - ``a_{N-1}`` for periodic (reference anisotropic.pyx:67-68),
    - ``a_1`` for mirror (reference anisotropic.pyx:69-70),
    - ``a_0`` for Jia-Zhao, making the boundary difference vanish
      (reference anisotropic.pyx:71-73).
    """
    body = lax.slice_in_dim(a, 0, a.shape[ax] - 1, axis=ax)
    if halo_prev is not None:
        first = halo_prev
    elif bc == BCMode.PERIODIC:
        first = _slab(a, ax, -1)
    elif bc == BCMode.MIRROR:
        first = _slab(a, ax, 1)
    else:  # JIA_ZHAO
        first = _slab(a, ax, 0)
    return lax.concatenate([first, body], dimension=ax)


def shift_forward(
    b: Array,
    ax: int,
    bc: BCMode,
    halo_next: Optional[Array] = None,
) -> Array:
    """Return ``s`` with ``s_i = b_{i+1}`` along ``ax``.

    The trailing slab ``s_{N-1}`` is:

    - ``halo_next`` (the neighbor shard's first slab of the *updated*
      accumulator) when given;
    - ``b_0`` for periodic *and* Jia-Zhao — identical by the JZ zero-slab
      invariant (reference cyTVDN/utils.pyx:63-65, 98-101);
    - ``b_{N-1}`` for mirror (zero trailing difference; this is the corrected
      behavior, cf. the reference defect at utils.pyx:117-120).
    """
    body = lax.slice_in_dim(b, 1, b.shape[ax], axis=ax)
    if halo_next is not None:
        last = halo_next
    elif bc in (BCMode.PERIODIC, BCMode.JIA_ZHAO):
        last = _slab(b, ax, 0)
    else:  # MIRROR (corrected)
        last = _slab(b, ax, -1)
    return lax.concatenate([body, last], dimension=ax)


def _clip(x: Array, clip: Array) -> Array:
    """``min(max(x, -clip), clip)`` (reference anisotropic.pyx:11-12)."""
    return jnp.clip(x, -clip, clip)


def accumulator_update(
    a: Array,
    b: Array,
    ax: int,
    clip: Array,
    bc: BCMode = BCMode.JIA_ZHAO,
    halo_prev: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Unaccelerated dual-accumulator update along one axis.

    ``b_new = clip(a - shift_backward(a) + b)``; returns ``(b_new, ||b_new||_1)``
    (reference cyTVDN/anisotropic.pyx:17-84: docstring line 19, norm at 53,81).
    """
    diff = a - shift_backward(a, ax, bc, halo_prev)
    b_new = _clip(diff + b, clip)
    return b_new, jnp.sum(jnp.abs(b_new))


def accumulator_update_fista(
    a: Array,
    b: Array,
    d: Array,
    tk_ratio: Array,
    ax: int,
    clip: Array,
    bc: BCMode = BCMode.JIA_ZHAO,
    halo_prev: Optional[Array] = None,
) -> Tuple[Array, Array, Array]:
    """FISTA-accelerated dual update along one axis.

    ``d_new = clip(a - shift_backward(a) + b)``;
    ``b_new = d_new + tk_ratio * (d_new - d)`` — only ``d`` is projected, the
    extrapolated ``b`` may leave the clip ball
    (reference cyTVDN/anisotropic.pyx:127-132). Norm is of the extrapolated
    ``b_new`` (line 131). Returns ``(b_new, d_new, ||b_new||_1)``.
    """
    diff = a - shift_backward(a, ax, bc, halo_prev)
    d_new = _clip(diff + b, clip)
    b_new = d_new + tk_ratio * (d_new - d)
    return b_new, d_new, jnp.sum(jnp.abs(b_new))


def _iso_project(
    delta1: Array, delta2: Array, clip: Array
) -> Tuple[Array, Array]:
    """Joint projection of the 2-vector onto the L2 ball of radius ``clip``.

    ``if hypot(d1,d2) > clip: d /= (mag/clip)``
    (reference cyTVDN/halfisotropic.pyx:84-95). Division guarded for mag=0.
    """
    mag = jnp.hypot(delta1, delta2)
    scale = jnp.where(mag > clip, clip / jnp.where(mag > 0, mag, 1.0), 1.0)
    return delta1 * scale, delta2 * scale


def iso_accumulator_update(
    a: Array,
    b1: Array,
    b2: Array,
    ax1: int,
    ax2: int,
    clip: Array,
    halo_prev1: Optional[Array] = None,
    halo_prev2: Optional[Array] = None,
) -> Tuple[Array, Array, Array]:
    """Half-isotropic paired-axis update (Jia-Zhao BCs only, as in reference).

    Backward differences along ``ax1``/``ax2`` are jointly projected onto the
    L2 ball of radius ``clip`` (the driver passes one shared clip for the
    pair, reference cyTVDN/cyTVDN.py:160-162); norm is ``Σ|b1|+|b2|``
    (reference cyTVDN/halfisotropic.pyx:93).

    NOTE: the reference README flags this scheme as possibly erroneous
    (reference README.md:9); the capability is reproduced for parity but
    should be treated as experimental.
    """
    bc = BCMode.JIA_ZHAO
    delta1 = a - shift_backward(a, ax1, bc, halo_prev1) + b1
    delta2 = a - shift_backward(a, ax2, bc, halo_prev2) + b2
    b1_new, b2_new = _iso_project(delta1, delta2, clip)
    norm = jnp.sum(jnp.abs(b1_new)) + jnp.sum(jnp.abs(b2_new))
    return b1_new, b2_new, norm


def iso_accumulator_update_fista(
    a: Array,
    b1: Array,
    b2: Array,
    d1: Array,
    d2: Array,
    tk_ratio: Array,
    ax1: int,
    ax2: int,
    clip: Array,
    halo_prev1: Optional[Array] = None,
    halo_prev2: Optional[Array] = None,
) -> Tuple[Array, Array, Array, Array, Array]:
    """FISTA variant of the half-isotropic update
    (reference cyTVDN/halfisotropic.pyx:102-188): per-component momentum on
    the jointly-projected pair; norm of the extrapolated values (line 183).

    Returns ``(b1_new, b2_new, d1_new, d2_new, norm)``.
    """
    bc = BCMode.JIA_ZHAO
    delta1 = a - shift_backward(a, ax1, bc, halo_prev1) + b1
    delta2 = a - shift_backward(a, ax2, bc, halo_prev2) + b2
    d1_new, d2_new = _iso_project(delta1, delta2, clip)
    b1_new = d1_new + tk_ratio * (d1_new - d1)
    b2_new = d2_new + tk_ratio * (d2_new - d2)
    norm = jnp.sum(jnp.abs(b1_new)) + jnp.sum(jnp.abs(b2_new))
    return b1_new, b2_new, d1_new, d2_new, norm


def datacube_update(
    orig: Array,
    recon: Array,
    bs: Sequence[Array],
    lam_mu: Array,
    bc: BCMode = BCMode.JIA_ZHAO,
    halos_next: Optional[Sequence[Optional[Array]]] = None,
) -> Tuple[Array, Array, Array]:
    """Reconstruction update: ``recon_new = orig - Σ_k λμ_k (b_k - S_k⁺ b_k)``
    (reference cyTVDN/utils.pyx:96-102).

    Returns ``(recon_new, delta_num, recon_norm)`` where
    ``delta_num = Σ|recon_new - recon|`` and ``recon_norm = Σ|recon|``; the
    convergence statistic is ``delta_num / recon_norm``
    (reference cyTVDN/utils.pyx:103-104,125). The two reduction terms are
    returned separately so the sharded solver can ``psum`` them before
    dividing.
    """
    if halos_next is None:
        halos_next = [None] * len(bs)
    div = jnp.zeros_like(orig)
    for k, (b_k, halo) in enumerate(zip(bs, halos_next)):
        div = div + lam_mu[k] * (b_k - shift_forward(b_k, k, bc, halo))
    recon_new = orig - div
    delta_num = jnp.sum(jnp.abs(recon_new - recon))
    recon_norm = jnp.sum(jnp.abs(recon))
    return recon_new, delta_num, recon_norm


def sum_square_error(a: Array, b: Array) -> Array:
    """Sum of squared differences — *not* divided by N, despite the MSE
    naming in the reference driver (reference cyTVDN/utils.pyx:14-49,
    cyTVDN.py:124-125)."""
    diff = a - b
    return jnp.sum(diff * diff)


def tv_energy(
    u: Array,
    f: Array,
    lam: Array,
    mu: Array,
    bc: BCMode = BCMode.JIA_ZHAO,
) -> Array:
    """The anisotropic ROF objective the Jia-Zhao iteration minimizes:

        E(u) = Σ_k λ_k ‖D_k⁻ u‖₁ + (μ̄/2) ‖u − f‖²   (μ̄ = mean of μ_k)

    A diagnostic the reference never exposes — useful for verifying
    monotone descent and for parameter studies (the reference's planned
    parameter-selection paper was never written, reference README.md:78).
    """
    e = 0.5 * jnp.mean(mu) * jnp.sum((u - f) ** 2)
    for ax in range(u.ndim):
        diff = u - shift_backward(u, ax, bc)
        e = e + lam[ax] * jnp.sum(jnp.abs(diff))
    return e
