"""Hand-written CUDA kernels, their plain PyTorch versions and wrappers.

Importing this package never builds or loads a kernel: the CPU tests
import every module without ``nvcc``.  A wrapper builds the kernels at
its first call on a CUDA tensor and uses the plain version only for a
tensor that lies on the CPU.
"""
