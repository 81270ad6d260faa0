"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter (``<module>.launches``), and each a
``torch.library`` custom op (``torch.ops.yolact_tpu_torch.*``), registered
when this package is imported; and deformable PSRoI pooling, plain PyTorch
(``psroi.py``)."""

from yolact_tpu_torch.kernels import dcn, mask_assembly, nms, stem  # noqa: F401
from yolact_tpu_torch.kernels.psroi import DeformRoIPooling, deform_psroi_pool
