"""The port's hand-written CUDA kernels and their plain versions."""
from repro_torch.kernels.launches import LAUNCHES, reset

__all__ = ["LAUNCHES", "reset"]
