"""Halo exchange over the device mesh — the replacement for the reference's
MPI ``Isend/Irecv`` face exchange (reference cyTVDN/mpi.py:322-434). The
halos are ``lax.ppermute`` collectives, which XLA hands to NCCL on GPUs.

This implements the *corrected* seam scheme verified in SURVEY.md §8.3:

- Halos are **kernel operands**, never stored into state slots. The
  reference writes received faces into ``acc[0]`` / ``recon[-1]``
  (mpi.py:374-383, 425-430), which (a) is off-by-one in its geometry and
  (b) destroys the Jia-Zhao zero-slab invariant on edge tiles. Passing the
  neighbor slab as a separate operand to the difference operator removes
  that bug class structurally.
- Each backward difference at a shard seam consumes the -1 neighbor's last
  slab of ``recon`` (``prev_halo``); each forward difference consumes the
  +1 neighbor's first slab of the *updated* accumulator (``next_halo``).
- Global domain edges apply the true boundary condition by masking on
  ``lax.axis_index``: JZ edge shards substitute their own edge slab (zero
  difference); mirror substitutes the adjacent interior slab; periodic uses
  a ring permutation.

With this scheme the mesh run is bitwise-deterministic and matches the
single-device run to machine epsilon (float64 max|err| ≈ 4e-16 over 50
iterations in the SURVEY verification; the equality test lives in
tests/test_sharded.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax

from cytvdn_tpu.config import BCMode

Array = jax.Array


from cytvdn_tpu.ops.stencil import _slab  # one-thick slab along an axis


class MeshComm:
    """Communication strategy used inside ``shard_map``.

    ``axis_names`` maps data axes to mesh axis names (only split axes appear,
    e.g. ``{0: "x", 1: "y"}``). The engine calls :meth:`prev_halo` /
    :meth:`next_halo` per data axis and :meth:`allsum` for scalars.
    """

    def __init__(self, axis_names: Dict[int, str], bc: BCMode):
        self.axis_names = dict(axis_names)
        self.bc = bc
        self.split_axes = tuple(sorted(self.axis_names))

    def _mesh_info(self, ax: int):
        name = self.axis_names.get(ax)
        if name is None:
            return None, 1
        return name, lax.axis_size(name)

    def prev_halo(self, a: Array, ax: int) -> Optional[Array]:
        """-1 neighbor's last slab of ``a`` along ``ax`` (backward-diff
        operand); BC-correct at the global leading edge."""
        name, n = self._mesh_info(ax)
        if name is None or n == 1:
            return None  # unsplit (or trivially split): BC path handles it
        my_last = _slab(a, ax, -1)
        if self.bc == BCMode.PERIODIC:
            perm = [(i, (i + 1) % n) for i in range(n)]
            return lax.ppermute(my_last, name, perm)
        perm = [(i, i + 1) for i in range(n - 1)]
        received = lax.ppermute(my_last, name, perm)
        idx = lax.axis_index(name)
        if self.bc == BCMode.MIRROR:
            edge = _slab(a, ax, 1)  # global a[1] lives on shard 0
        else:  # JIA_ZHAO: zero difference at the global edge
            edge = _slab(a, ax, 0)
        return jnp.where(idx == 0, edge, received)

    def next_halo(self, b: Array, ax: int) -> Optional[Array]:
        """+1 neighbor's first slab of the *updated* ``b`` along ``ax``
        (forward-diff operand); BC-correct at the global trailing edge."""
        name, n = self._mesh_info(ax)
        if name is None or n == 1:
            return None
        my_first = _slab(b, ax, 0)
        if self.bc in (BCMode.PERIODIC, BCMode.JIA_ZHAO):
            # Ring permute: the trailing shard receives the global leading
            # slab — exactly the single-device wraparound read
            # (reference utils.pyx:98-101; under JZ that slab is identically
            # zero by the invariant, SURVEY.md §8.1).
            perm = [(i, (i - 1) % n) for i in range(n)]
            return lax.ppermute(my_first, name, perm)
        perm = [(i, i - 1) for i in range(1, n)]
        received = lax.ppermute(my_first, name, perm)
        idx = lax.axis_index(name)
        edge = _slab(b, ax, -1)  # mirror: zero trailing difference (corrected)
        return jnp.where(idx == n - 1, edge, received)

    def allsum(self, x: Array) -> Array:
        return lax.psum(x, tuple(self.axis_names.values()))
