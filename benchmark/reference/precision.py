"""The precision the reference computes its products in.

By default the reference computes every convolution and matrix product in
the dtype its model runs in (float32, with TF32 off, for the reference).
The correctness check's control runs the same reference one precision
below each part's configured precision: under :func:`fp8_operands` the
operands of every bfloat16 convolution and DCN product are rounded to
float8 (e4m3, one scale a tensor, from its largest magnitude) before a
bfloat16 product with float32 sums, which is what an fp8 GEMM computes,
and those of every float32 product (the mask scorer, the mask assembly)
to bfloat16 before a float32 product, a bfloat16 GEMM's.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_FP8 = contextvars.ContextVar('fp8_operands', default=False)
E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 at one scale, held in bfloat16; the
    gradient passes the rounding unchanged (straight through)."""
    with torch.no_grad():
        amax = t.abs().amax().float().clamp_min(1e-30)
        scale = amax / E4M3_MAX
        q = ((t.float() / scale).to(torch.float8_e4m3fn).float()
             * scale).to(torch.bfloat16)
    return q + (t - t.detach()).to(torch.bfloat16)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bfloat16, held in float32 (straight through)."""
    return t + (t.detach().bfloat16().float() - t.detach())


def operands(x: torch.Tensor, w: torch.Tensor):
    """(x, w) as the product sees them: unchanged, or under
    :func:`fp8_operands` one precision down: bfloat16 operands rounded to
    float8 (held in bfloat16), float32 ones to bfloat16 (held in
    float32)."""
    if not _FP8.get():
        return x, w
    if x.dtype == torch.bfloat16:
        return _fp8(x), _fp8(w)
    if x.dtype == torch.float32:
        return _bf16(x), _bf16(w)
    return x, w


@contextlib.contextmanager
def fp8_operands():
    token = _FP8.set(True)
    try:
        yield
    finally:
        _FP8.reset(token)
