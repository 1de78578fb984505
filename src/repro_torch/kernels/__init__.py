"""The port's kernels: CUDA sources in ``csrc/``, ctypes wrappers and plain versions."""
