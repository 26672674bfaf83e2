"""Device-memory/RAM-aware memory advisor — the reference's ``check_memory`` rebuilt
honestly (reference cyTVDN/cyTVDN.py:438-467).

The reference's multipliers (13×/11× FISTA) disagree with its own driver
prints (9×/7×); the true live-array counts are (SURVEY.md §2.7):

- 4D FISTA: 10 cube-size arrays (orig, recon, 4 accs, 4 shadow duals)
- 4D unaccelerated: 6; 3D FISTA: 8; 3D unaccelerated: 5

This version reports those true counts against both the accelerator's
memory (per device, when an accelerator is present) and host RAM.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _live_arrays(ndim: int, fista: bool) -> int:
    return 2 + (2 * ndim if fista else ndim)


def _fmt(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(nbytes) < 1024.0:
            return f"{nbytes:.1f} {unit}"
        nbytes /= 1024.0
    return f"{nbytes:.1f} PiB"


def _device_memory() -> Optional[int]:
    """Per-device accelerator memory JAX may use (``bytes_limit``), or
    None where the backend reports no memory statistics (the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return None


def _host_memory() -> Optional[int]:
    try:
        import psutil

        return int(psutil.virtual_memory().available)
    except Exception:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable"):
                        return int(line.split()[1]) * 1024
        except Exception:
            return None
    return None


def check_memory(datacube: np.ndarray, n_devices: int = 1) -> List[List[str]]:
    """Tabulate memory needed per algorithm vs device memory and host RAM.

    ``n_devices``: number of mesh devices the cube would be sharded over
    (per-device requirement scales as 1/n, plus negligible halo slabs).
    Returns the table rows (also printed), so callers/tests can inspect.
    """
    ndim = datacube.ndim
    if ndim not in (3, 4):
        raise ValueError("datacube must be 3D or 4D")
    dcsize = datacube.nbytes
    hbm = _device_memory()
    ram = _host_memory()

    def ok(total: int) -> str:
        per_dev = total / max(n_devices, 1)
        marks = []
        if hbm is not None:
            marks.append("device:" + ("✅" if per_dev < hbm else "❌"))
        if ram is not None:
            marks.append("RAM:" + ("✅" if total < ram else "❌"))
        return " ".join(marks) if marks else "?"

    rows = []
    for name, fista in (
        ("Anisotropic Unaccelerated", False),
        ("Anisotropic FISTA", True),
        ("(Half-)Isotropic Unaccelerated", False),
        ("(Half-)Isotropic FISTA", True),
    ):
        if "Isotropic" in name and ndim == 3:
            continue  # iso is 4D-only (reference README.md:15-16)
        total = dcsize * _live_arrays(ndim, fista)
        rows.append([name, _fmt(total), ok(total)])

    header = f"Datacube size is {_fmt(dcsize)} with dtype {datacube.dtype}"
    lines = [header]
    if hbm is not None:
        lines.append(
            f"Accelerator memory per device: {_fmt(hbm)} × {n_devices} "
            f"device(s)"
        )
    if ram is not None:
        lines.append(f"Available host RAM: {_fmt(ram)}")
    width = max(len(r[0]) for r in rows)
    for r in rows:
        lines.append(f"{r[0]:<{width}}  {r[1]:>10}  {r[2]}")
    print("\n".join(lines))
    return rows
