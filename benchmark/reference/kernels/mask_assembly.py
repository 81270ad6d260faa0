"""Frozen plain PyTorch copy of the port's mask assembly
(``yolact_tpu_torch/kernels/mask_assembly.py``): the plain version alone,
under the kernel's name, so the reference's model runs it wherever the port
would launch the kernel."""

from __future__ import annotations

import torch

from benchmark.reference.ops.boxes import crop
from benchmark.reference.precision import operands


def assemble_masks_plain(proto: torch.Tensor, coeffs: torch.Tensor,
                         boxes: torch.Tensor, padding: int = 1
                         ) -> torch.Tensor:
    """proto [B, Hp, Wp, Md]; coeffs [B, D, Md]; boxes [B, D, 4] relative
    point form -> masks [B, D, Hp, Wp], all float32."""
    m = torch.sigmoid(torch.einsum('bhwc,bdc->bhwd',
                                   *operands(proto.float(), coeffs.float())))
    m = torch.stack([crop(mi, bi, padding=padding)
                     for mi, bi in zip(m, boxes.float())])
    return m.permute(0, 3, 1, 2)


assemble_masks = assemble_masks_plain
