"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper module holds, beside the wrapper, the plain PyTorch version of
the same function.  A wrapper takes the plain version only for tensors on
the CPU; on a CUDA tensor it launches its kernel or raises.  Each wrapper
counts its kernel launches in an integer attribute, ``<wrapper>.launches``.
"""
