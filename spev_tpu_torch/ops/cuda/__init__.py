"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper module holds, beside the wrapper, the plain PyTorch version of
the same function.  A wrapper takes the plain version only for tensors on
the CPU; on a CUDA tensor it launches its kernel or raises.  Each wrapper
counts its kernel launches in an integer attribute, ``<wrapper>.launches``.
"""


def kernel_launches() -> dict:
    """Launch counts of the port's CUDA kernel wrappers in this process."""
    from spev_tpu_torch.ops.cuda.kernels import fused_log_mel, overlap_add
    from spev_tpu_torch.ops.cuda.length_regulator_kernel import lr_fused, lr_fused_bwd

    return {f.__name__: f.launches for f in (lr_fused, lr_fused_bwd, fused_log_mel, overlap_add)}
