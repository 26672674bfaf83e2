"""cytvdn_tpu — total-variation denoising for 3D/4D microscopy data on JAX.

A JAX/XLA/shard_map framework with the capabilities of the
cyTVDN reference (proximal anisotropic / half-isotropic TV denoising of 3D
hyperspectral EELS cubes and 4D-STEM datacubes via the Jia-Zhao
dual-accumulator algorithm with optional FISTA acceleration).

Public API (mirrors the reference's ``cyTVDN/__init__.py`` exports, cf.
reference cyTVDN/cyTVDN.py:19,250,438):

- :func:`denoise3D`  — 3D anisotropic TV denoising
- :func:`denoise4D`  — 4D anisotropic / half-isotropic TV denoising
- :func:`check_memory` — memory-requirement advisor (device memory + host
  RAM aware)
- :class:`BCMode` — boundary-condition enum (periodic / mirror / Jia-Zhao)
"""

from cytvdn_tpu.config import BCMode, SolverOptions
from cytvdn_tpu.api import denoise3D, denoise4D, denoise
from cytvdn_tpu.utils.memory import check_memory

__version__ = "0.1.0"

__all__ = [
    "BCMode",
    "SolverOptions",
    "denoise3D",
    "denoise4D",
    "denoise",
    "check_memory",
]
