"""Frozen copy of the port's ``models/layers.py``; every product's operands
pass :func:`benchmark.reference.precision.operands`.

Building blocks shared by the backbone and heads, NCHW.

Port of ``yolact_tpu/models/layers.py``.  Convolutions are plain
``nn.Conv2d`` with torch integer padding (the reference's own layer), and
parameter names follow the reference's ``state_dict``.

The space-to-depth ("s2d") stem helpers are ported with JAX's channel
contract: a 2x2 space-to-depth input has channel ``(p*2+q)*3 + c`` for the
pixel at row offset ``p`` and column offset ``q`` of each 2x2 cell, ``c``
in raw BGR order, and the 7x7/s2/p3 stem conv becomes a 4x4/s1 conv with
padding (2, 1) over it (:func:`s2d_stem_kernel`, ``kernels/stem.py``).  The
rearrangement is a reshape and permute; JAX's one-hot stride-2 conv, which
makes the TPU's matrix unit do the shuffle, is not ported.  The s2d stem
runs only where a config asks for it (``cfg.stem_s2d``).

Compute dtype follows the JAX convention (flax modules with ``dtype`` over
float32 parameters): :class:`Conv2d` and :class:`Linear` compute in their
input's dtype and cast their weight and bias to it at use, so a bfloat16
activation runs a bfloat16 conv over float32 master weights, and autograd
brings float32 gradients back to them.  For inference
``Yolact.set_compute_dtype`` casts the weights once, and the cast at use is
then a no-op.  Batch norm keeps float32 statistics and parameters.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import operands


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: weight and bias are cast to it at
    use (see the module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(*operands(x, self.weight.to(x.dtype)),
                                  bias)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, as :class:`Conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*operands(x, self.weight.to(x.dtype)),
                        self.bias.to(x.dtype))


def s2d_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """A 7x7/s2/p3 stem weight ``[O, C, 7, 7]`` (RGB input order) as the
    equivalent 4x4/s1 weight ``[O, 4*C, 4, 4]`` over a 2x2 space-to-depth
    input in raw (BGR) order, channel ``(p*2+q)*C + c`` (JAX
    ``s2d_stem_kernel`` in OIHW).  Output tap ``a = 2m + p - 1`` covers the
    7 taps for ``m`` in [0, 4), ``p`` in {0, 1}; the tap at -1 is zero.
    Exact: only a flip, a zero pad and a rearrangement."""
    o, c, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise NotImplementedError('s2d stem assumes a 7x7/s2/p3 conv')
    wp = F.pad(w.flip(1), (1, 0, 1, 0))           # fold BGR->RGB; a+1 >= 0
    wp = wp.view(o, c, 4, 2, 4, 2)                # [o, c, m, p, n, q]
    return wp.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)


def s2d_input(x: torch.Tensor, from_rgb: bool = False) -> torch.Tensor:
    """``[B, C, H, W]`` -> 2x2 space-to-depth ``[B, 4*C, H/2, W/2]`` with
    channel ``(p*2+q)*C + c`` (JAX ``s2d_input`` / ``s2d_eye_kernel``).
    ``from_rgb`` reverses the channels first, so an RGB input lands in raw
    (BGR) order, the stem conv's contract."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError('s2d input needs even H and W')
    if from_rgb:
        x = x.flip(1)
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)      # [b, c, h, p, w, q]
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


class BatchNorm2d(nn.Module):
    """Batch norm (eps 1e-5) with the reference's parameter names.
    Statistics stay float32 whatever the input dtype; the output has the
    input's dtype.

    ``train=False`` normalises with the running statistics.  ``train=True``
    (JAX ``BatchNorm(train=True)``) normalises with the batch's and works
    out the next running statistics, ``0.9 * running + 0.1 * batch`` (torch
    momentum 0.1), with the BIASED batch variance as flax stores it
    (``F.batch_norm`` would store the unbiased one).  As flax returns the new
    ``batch_stats`` beside the output instead of writing them, the forward
    leaves them in ``pending``: :func:`commit_batch_stats` writes them to the
    buffers.  So a step that turns out non-finite can drop them, and a
    block replayed by activation checkpointing, which computes the same
    pending values again, does not move the running statistics twice.

    ``shared``: the layer runs more than once per forward (the prediction
    head shared by every level, which activation checkpointing never
    replays); each call then starts from the statistics the call before it
    left, as the reference's in-place update and flax's do."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.shared = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.pending = None     # (running_mean, running_var) after this batch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # momentum 1 leaves exactly the batch mean and its unbiased variance
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            start = self.pending if self.shared and self.pending else \
                (self.running_mean, self.running_var)
            self.pending = (
                torch.lerp(start[0], mean, self.momentum),
                torch.lerp(start[1], var * ((n - 1) / n), self.momentum))
        return out


def commit_batch_stats(model: nn.Module) -> int:
    """Write every batch norm's pending running statistics (left by a
    ``train=True`` forward) to its buffers and clear them; returns how many
    layers had some."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm2d) and m.pending is not None:
            m.running_mean.copy_(m.pending[0])
            m.running_var.copy_(m.pending[1])
            m.pending = None
            n += 1
    return n


def drop_batch_stats(model: nn.Module) -> None:
    """Forget the pending running statistics (a step that is skipped)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.pending = None


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """torch-style max pool (pads with -inf; floor or ceil output size,
    :func:`pool_out_size`).
    JAX's version pads the right edge for ``ceil_mode``, which keeps a last
    window starting in the right padding that torch drops; the two agree
    where ``ceil_mode`` is off or ``padding`` is 0 (every pool of the
    configs)."""
    return F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)


class InterpolateModule(nn.Module):
    """Bilinear scale-by-factor layer (half-pixel centers)."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor)
        return F.interpolate(x, size=size, mode='bilinear',
                             align_corners=False)


def make_net(in_channels: int, spec: Tuple[Tuple[Any, ...], ...],
             include_last_relu: bool = True) -> Tuple[nn.Sequential, int]:
    """Build a make_net layer spec as an ``nn.Sequential`` with a ReLU slot
    after every entry, so index ``i`` is the JAX ``layers_{i}`` and the
    reference's ``state_dict`` index.  Returns (net, out_channels).

    Entries are ``(channels, kernel, kwargs)``: a conv for kernel > 0 and a
    bilinear upsample by ``-kernel`` for channels None, the only entries
    of the benchmark's configurations."""
    layers = []
    ch = in_channels
    for entry in spec:
        num, k = entry[0], entry[1]
        kw = dict(entry[2]) if len(entry) > 2 else {}
        if isinstance(num, int) and k > 0:
            layers.append(Conv2d(ch, num, k, stride=kw.get('stride', 1),
                                 padding=kw.get('padding', 0),
                                 dilation=kw.get('dilation', 1)))
            ch = num
        elif num is None and k < 0:
            layers.append(InterpolateModule(-k))
        else:
            raise NotImplementedError(f'make_net entry {entry!r}')
        layers.append(nn.ReLU())
    if not include_last_relu and layers:
        layers = layers[:-1]
    return nn.Sequential(*layers), ch
