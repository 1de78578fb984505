"""MonaVec on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Imports torch and numpy only.  The scan and the Hadamard rotation run as
hand-written CUDA kernels (``csrc/``) built with nvcc at first use; on the
CPU the same functions run as plain PyTorch.  See ``core.api.MonaVec``.
"""

from .core.api import MonaVec

__all__ = ["MonaVec"]
