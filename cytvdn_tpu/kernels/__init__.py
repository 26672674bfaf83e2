"""Hand-written GPU kernels (Pallas on the Triton route)."""

from cytvdn_tpu.kernels.step import covers, gpu_step

__all__ = ["covers", "gpu_step"]
