"""Configuration types for the TV-denoising solver.

The reference threads an int ``BC_mode`` {0,1,2} through every kernel
(reference cyTVDN/anisotropic.pyx:20-23, cyTVDN/cyTVDN.py:49-52); here it is a
proper IntEnum so that the integer API is preserved while names are available.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class BCMode(enum.IntEnum):
    """Boundary conditions for the difference operators.

    Values match the reference's integer convention
    (reference cyTVDN/anisotropic.pyx:20-23):

    - ``PERIODIC`` (0): index wraparound on both difference operators.
    - ``MIRROR`` (1): the boundary difference reads the adjacent interior
      element. NOTE: the reference's mirror implementation of the
      reconstruction update is buggy (``max`` clamp instead of ``min``,
      reference cyTVDN/utils.pyx:117-120 and 192-197); this package
      implements mirror *correctly*: the forward difference at the last
      index is zero (neighbor ``min(i+1, N-1)``).
    - ``JIA_ZHAO`` (2, default): the difference at the domain edge is zero
      (Jia & Zhao, Adv Comp Math 2010 33:231-241). Under this mode the dual
      accumulator slab at index 0 along its axis is identically zero for all
      iterations (the "JZ zero-slab invariant", see SURVEY.md §8.1).
    """

    PERIODIC = 0
    MIRROR = 1
    JIA_ZHAO = 2


class Backend(enum.Enum):
    """Compute backend for the iteration body.

    - ``AUTO``: on an NVIDIA GPU, the hand-written two-pass step
      (``kernels/step.py``, Pallas on the Triton route) where it covers the
      run — float32, Jia-Zhao, anisotropic, exact duals, one device — and
      the XLA ops path (``ops/stencil.py``) otherwise; on the CPU, the ops
      path.
    - ``JAX``: the XLA ops path on whatever device JAX runs on.
    - ``PALLAS``: the GPU step, demanded; raises without a GPU or for a
      configuration it does not cover.
    - ``CPP``: native C++/OpenMP host kernels (CPU hosts only, via ctypes).
    """

    AUTO = "auto"
    JAX = "jax"
    PALLAS = "pallas"
    CPP = "cpp"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration (hashable: used as a jit static arg).

    Mirrors the reference driver's keyword surface
    (reference cyTVDN/cyTVDN.py:19-31, 250-260) plus the mesh and lossy
    options.
    """

    ndim: int
    iterations_fista: int
    iterations_unacc: int
    bc_mode: BCMode = BCMode.JIA_ZHAO
    stopping_relative_change: Optional[float] = None
    isotropic_R: bool = False  # pair axes (0,1), 4D only
    isotropic_Q: bool = False  # pair axes (2,3), 4D only
    calculate_mse: bool = False
    backend: Backend = Backend.AUTO
    # Adaptive FISTA restart (opt-in, beyond the reference): reset the
    # momentum whenever the relative change increases — the classic
    # function-value restart heuristic (O'Donoghue & Candès; cf. the
    # "Improving FISTA" literature). Off by default to preserve exact
    # reference parity of the momentum schedule.
    fista_restart: bool = False
    # Data axes split across the device mesh, e.g. (0, 1). Empty = single
    # device. The reference's MPI runtime always splits axes (0, 1)
    # (reference cyTVDN/mpi.py:130-214); we additionally allow splitting the
    # Q/spectral axes (SURVEY.md §2 parallelism inventory).
    mesh_axes: Tuple[int, ...] = ()
    # LOSSY opt-in (beyond the reference): store the FISTA shadow duals
    # (``d``) in bfloat16, compute in float32. Halves the d arrays' bytes
    # in device memory, host RAM and transfers. NOT bit-exact vs an exact
    # run: the recon drifts by far more than the 1e-5 reference-parity
    # budget, which is why this can never be a default. Covers float32
    # Jia-Zhao anisotropic FISTA runs: single-device, sharded meshes
    # (lossy mesh ≡ lossy single device bitwise), out-of-core and
    # multihost.
    lossy_duals: bool = False

    def __post_init__(self):
        # coerce string spellings ("jax", 2) to the enums: a bare string
        # would never compare equal to Backend.JAX in the engine gates
        # and the option would silently fall through to AUTO behavior
        if not isinstance(self.backend, Backend):
            object.__setattr__(self, "backend", Backend(self.backend))
        if not isinstance(self.bc_mode, BCMode):
            object.__setattr__(self, "bc_mode", BCMode(self.bc_mode))
        if self.ndim not in (3, 4):
            raise ValueError(f"ndim must be 3 or 4, got {self.ndim}")
        if self.ndim == 3 and (self.isotropic_R or self.isotropic_Q):
            raise ValueError("half-isotropic mode is 4D-only (as in reference)")
        if self.lossy_duals:
            if self.isotropic_R or self.isotropic_Q:
                raise ValueError(
                    "lossy_duals does not cover half-isotropic runs")
            if self.bc_mode != BCMode.JIA_ZHAO:
                raise ValueError(
                    "lossy_duals covers Jia-Zhao anisotropic runs only")

    @property
    def fista(self) -> bool:
        return self.iterations_fista > 0

    @property
    def total_iterations(self) -> int:
        return self.iterations_fista + self.iterations_unacc


def normalize_iterations(iterations, fista: bool) -> Tuple[int, int]:
    """Resolve the reference's ``iterations`` convention.

    An int runs ``iterations`` of whichever phase ``FISTA`` selects; a
    2-sequence ``(n_fista, n_unacc)`` runs a hybrid schedule, overriding the
    FISTA flag (reference cyTVDN/cyTVDN.py:100-108).
    """
    if isinstance(iterations, (list, tuple)):
        if len(iterations) != 2:
            raise ValueError(
                "iterations must be an int or a 2-sequence (n_fista, n_unacc)"
            )
        return int(iterations[0]), int(iterations[1])
    n = int(iterations)
    return (n, 0) if fista else (0, n)
