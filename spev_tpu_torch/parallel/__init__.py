"""Device meshes and the process group: data parallelism for the trainers
(gradients all-reduced over a ``torch.distributed`` group), Megatron tensor
parallelism of the FFT blocks over a 'model' axis, and in-process batch
splitting for serving.  Counterpart of ``spev_tpu.parallel``."""

from spev_tpu_torch.parallel.mesh import Mesh, make_mesh, rows_of

__all__ = ["Mesh", "make_mesh", "rows_of"]
