"""Fused prototype mask assembly: CUDA kernel and its plain PyTorch version.

``sigmoid(coeffs @ protoᵀ)`` times the box crop, per image.  Replaces the
Pallas TPU kernel ``yolact_tpu/kernels/mask_assembly.py:_kernel``
(``assemble_masks_batched_pallas``, reached through
``assemble_masks_mapped`` from ``detect/postprocess.py``).

On the card the kernel (``csrc/mask_assembly.cu``) is bound by its output
write, 7.6 MB per frame at yolact_base against 2.4 MB of prototypes read.
A persistent grid walks tiles of (image, 128 pixels, all detections): each
prototype row is read once (16-byte async copies, double-buffered), the
products run on the tensor cores in split TF32, and each warp's output
rows leave shared memory in 16-byte stores.  The masks agree with the
plain version within 1e-5 (~7e-7 at yolact_base), not bit for bit; the
crop, and so the zero pattern, is exact.  The plain version writes and
rereads the products.

:func:`assemble_masks` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from yolact_tpu_torch.kernels import _build
from yolact_tpu_torch.ops.boxes import crop

launches = 0        # kernel launches by assemble_masks since import / reset

MAX_MD = 64
# shared memory a block may use on the card (H100: 227 KB)
MAX_SMEM = 232448


def smem_bytes(d: int, md: int) -> int:
    """Shared memory of one kernel block (csrc/mask_assembly.cu:layout):
    two prototype tiles of 128 rows and the image's split coefficients,
    rows padded to Md rounded up to 8 plus 4 floats; the crop bounds and
    each of the 8 warps' 16 x 40 staging tile.  At yolact_base (D = 100,
    Md = 32) 91,392 B: two blocks per SM."""
    ks = (md + 7) // 8 * 8 + 4
    dpad = (d + 15) // 16 * 16
    return 4 * (2 * 128 * ks + 2 * dpad * ks + 4 * dpad + 8 * 16 * 40)


def assemble_masks_plain(proto: torch.Tensor, coeffs: torch.Tensor,
                         boxes: torch.Tensor, padding: int = 1
                         ) -> torch.Tensor:
    """proto [B, Hp, Wp, Md]; coeffs [B, D, Md]; boxes [B, D, 4] relative
    point form -> masks [B, D, Hp, Wp], all float32."""
    m = torch.sigmoid(torch.einsum('bhwc,bdc->bhwd', proto.float(),
                                   coeffs.float()))
    m = torch.stack([crop(mi, bi, padding=padding)
                     for mi, bi in zip(m, boxes.float())])
    return m.permute(0, 3, 1, 2)


def assemble_masks(proto: torch.Tensor, coeffs: torch.Tensor,
                   boxes: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Same contract as :func:`assemble_masks_plain`; the CUDA kernel for
    CUDA tensors."""
    if proto.device.type == 'cpu':
        return assemble_masks_plain(proto, coeffs, boxes, padding)
    if proto.device.type != 'cuda':
        raise ValueError(f'assemble_masks: unsupported device {proto.device}')
    b, hp, wp, md = proto.shape
    if coeffs.dim() != 3 or coeffs.shape[0] != b or coeffs.shape[2] != md:
        raise ValueError(f'assemble_masks: coeffs {tuple(coeffs.shape)} does '
                         f'not match proto {tuple(proto.shape)}')
    d = coeffs.shape[1]
    if tuple(boxes.shape) != (b, d, 4):
        raise ValueError(f'assemble_masks: boxes must be [{b}, {d}, 4], got '
                         f'{tuple(boxes.shape)}')
    if md > MAX_MD:
        raise ValueError(f'assemble_masks: Md={md} exceeds {MAX_MD}')
    if smem_bytes(d, md) > MAX_SMEM:
        raise ValueError(f'assemble_masks: D={d}, Md={md} need '
                         f'{smem_bytes(d, md)} B of shared memory, more '
                         f'than {MAX_SMEM}')
    if not (coeffs.device == boxes.device == proto.device):
        raise ValueError('assemble_masks: inputs on different devices')
    proto = proto.to(torch.float32).contiguous()
    coeffs = coeffs.to(torch.float32).contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((b, d, hp, wp), dtype=torch.float32, device=proto.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    global launches
    _build.check(lib.yolact_mask_assembly(
        proto.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(),
        out.data_ptr(), b, d, hp, wp, md, float(padding),
        _build.stream_ptr(proto.device)), 'yolact_mask_assembly')
    launches += 1
    return out
