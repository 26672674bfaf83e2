"""Mesh-shape chooser: pick the device-grid factorization that minimizes
total halo-exchange traffic.

The reference's work-partitioner enumerates factorizations ``wx·wy = N`` and
scores each by total tile edge length (reference cyTVDN/mpi.py:130-153).
Here the cost model is the actual number of elements crossing seams per
iteration: each split axis ``a`` with ``w_a`` tiles contributes
``(w_a - 1) · (domain_size / extent_a)`` halo elements per exchanged array —
minimizing this minimizes the bytes ``ppermute`` moves between devices.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def _factorizations(n: int, k: int):
    """All ordered k-tuples of positive ints with product n."""
    if k == 1:
        yield (n,)
        return
    for f in range(1, n + 1):
        if n % f == 0:
            for rest in _factorizations(n // f, k - 1):
                yield (f,) + rest


def choose_grid(
    n_devices: int,
    extents: Sequence[int],
    require_divisible: bool = True,
) -> Tuple[int, ...]:
    """Choose tile counts per axis (one entry per splittable axis).

    ``extents``: the data extents of the axes available for splitting (the
    reference always uses the two scan axes, mpi.py:130-153; we allow any).
    Returns a tuple ``(w_0, ..., w_{k-1})`` with ``prod(w) == n_devices``
    minimizing seam-crossing elements; ties broken toward splitting the
    leading axes (cheaper index math, contiguous slabs).
    """
    extents = tuple(int(e) for e in extents)
    k = len(extents)
    domain = math.prod(extents)
    best, best_cost = None, None
    for ws in _factorizations(n_devices, k):
        if any(w > e for w, e in zip(ws, extents)):
            continue
        if require_divisible and any(e % w for w, e in zip(ws, extents)):
            continue
        cost = sum((w - 1) * (domain // e) for w, e in zip(ws, extents))
        if best_cost is None or cost < best_cost:
            best, best_cost = ws, cost
    if best is None:
        raise ValueError(
            f"No valid tiling of extents {extents} over {n_devices} devices"
            + (" with divisibility" if require_divisible else "")
        )
    return best
