"""Roofline accounting for the TV iteration.

The workload is memory-bandwidth-bound (O(1) flops/voxel/pass — the
reference author's own characterization, reference README.md:114), so
throughput is bytes-touched per iteration vs device-memory bandwidth. This
module encodes the per-path traffic models used to judge how close a
measured run is to speed-of-light.
"""

from __future__ import annotations

from typing import Tuple

#: published peak device-memory bandwidth (bytes/s), keyed by
#: ``jax.Device.device_kind``. Source: NVIDIA H100 Tensor Core GPU
#: datasheet, SXM form factor (80 GB HBM3 at 3.35 TB/s).
PEAK_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bandwidth(device_kind: str) -> float:
    """Published peak bandwidth of ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return PEAK_BW[device_kind]
    except KeyError:
        raise KeyError(
            f"no published bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(PEAK_BW)}") from None


def traversals_per_iteration(ndim: int, fista: bool, model: str) -> float:
    """Cube-size array read+write traversals per full TV iteration.

    - ``one_pass`` (the floor): reads orig, recon, n accs [, n ds]; writes
      recon, n accs [, n ds]  →  4n+3 (FISTA) / 2n+3 (plain).
    - ``two_pass`` (the GPU step, ``kernels/step.py``): the accumulator
      pass reads recon and rewrites the duals (4n+1 / 2n+1), the
      reconstruction pass reads orig, recon and the n accumulators and
      writes recon (n+3)  →  5n+4 / 3n+4.
    - ``reference``: per-kernel traversals of the Cython loops
      (SURVEY.md §3.1): 22 for 4D FISTA.
    """
    n = ndim
    if model == "one_pass":
        return (4 * n + 3) if fista else (2 * n + 3)
    if model == "two_pass":
        return (5 * n + 4) if fista else (3 * n + 4)
    if model == "reference":
        return (5 * n + 2) if fista else (3 * n + 2)
    raise ValueError(model)


def speed_of_light(
    shape: Tuple[int, ...],
    device_kind: str,
    fista: bool = True,
    model: str = "one_pass",
    itemsize: int = 4,
) -> float:
    """Upper-bound voxel-updates/sec for a traffic model on a device."""
    trav = traversals_per_iteration(len(shape), fista, model)
    return peak_bandwidth(device_kind) / (trav * itemsize)


def efficiency(measured_vox_per_sec: float, shape, device_kind: str,
               fista=True, model="one_pass") -> float:
    """Fraction of the traffic-model speed-of-light achieved."""
    return measured_vox_per_sec / speed_of_light(
        tuple(shape), device_kind, fista, model)
