"""ResNet backbone (bottleneck blocks, batch norm), NCHW.

Port of ``yolact_tpu/models/resnet.py`` (``Bottleneck``, ``_stage_plan``,
``ResNetBackbone``) with the reference's parameter names
(``layers.{stage}.{block}.conv1.weight``, ``...downsample.0.weight``).
Atrous stages, SSD-style extra stages, DCNv2 blocks (YOLACT++), the
space-to-depth stem and group norm (``norm='gn'``, ResNet-GN: every
``bn*`` and ``downsample.1`` is a ``models/layers.py:GroupNorm`` under the
same name) are kept.

Each module's wiring is its ``forward_rows``, which runs on a rank's rows
of a map split by height over a spatial mesh (``parallel/mesh.py``), with
the convs and the pool of ``models/layers.py`` fetching their halos and
every norm taking the map's rows (group norm's moments span the space
ranks), or on the whole map (``rows`` None, which ``forward`` passes); a
DCN layer gathers its input's whole height and samples it for its own
output rows (``kernels/dcn.py``, ``row0``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from yolact_tpu_torch.kernels import dcn, stem
from yolact_tpu_torch.models.layers import (BatchNorm2d, Conv2d, GroupNorm,
                                            conv_rows, max_pool_rows,
                                            s2d_stem_kernel)
from yolact_tpu_torch.parallel.mesh import Rows, fetch_rows, gather_rows

EXPANSION = 4


def make_norm(norm: str, channels: int) -> nn.Module:
    """'bn' (batch norm) or 'gn' (group norm, 32 groups)."""
    if norm not in ('bn', 'gn'):
        raise ValueError(f'norm={norm!r}: expected bn or gn')
    return GroupNorm(channels) if norm == 'gn' else BatchNorm2d(channels)


class DCNLayer(nn.Module):
    """DCNv2 layer: a conv predicts per-tap offsets and modulation logits,
    then the deformable conv consumes them.  Port of JAX
    ``resnet.py:DCNLayer`` with the reference's parameter names
    (``conv_offset_mask.{weight,bias}``, ``weight``, ``bias``).  Offsets
    (the first 2*K*K channels, (dy, dx) per tap) go to float32 before
    sampling; the mask is the sigmoid of the last K*K channels.  x may be
    contiguous or channels_last; the output is channels_last (see
    ``kernels/dcn.py``)."""

    def __init__(self, inplanes: int, planes: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.conv_offset_mask = Conv2d(inplanes, 3 * k * k, k,
                                       stride=stride, padding=padding,
                                       dilation=dilation, bias=True)
        self.weight = nn.Parameter(torch.empty(planes, inplanes, k, k))
        self.bias = nn.Parameter(torch.zeros(planes))

    def forward(self, x: torch.Tensor,
                use_kernels: bool = True) -> torch.Tensor:
        return self.forward_rows(x, None, use_kernels)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     use_kernels: bool = True
                     ) -> Tuple[torch.Tensor, Optional[Rows]]:
        """:meth:`forward` on a rank's rows of `x` (`rows`; None: the whole
        map), with the output's rows: the offsets of its output rows from a
        halo conv, then the samples of the whole map (the offsets reach
        anywhere), gathered with each rank's gradient summed into the
        owner's rows, from output row ``row0``."""
        kk = self.weight.shape[-1] ** 2
        om, out = conv_rows(self.conv_offset_mask, x, rows)
        offset = om[:, :2 * kk].float().contiguous()
        mask = torch.sigmoid(om[:, 2 * kk:]).contiguous()
        row0 = 0 if out is None else out.own()[0]
        fn = dcn.deform_conv2d if use_kernels else dcn.deform_conv2d_plain
        return fn(gather_rows(x, rows, 'own'), offset, mask, self.weight,
                  self.bias, self.stride, self.padding, self.dilation,
                  row0), out


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 with identity or projection
    residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, use_dcn: bool = False,
                 has_downsample: bool = False, norm: str = 'bn'):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False,
                            dilation=dilation)
        self.bn1 = make_norm(norm, planes)
        if use_dcn:
            self.conv2 = DCNLayer(planes, planes, 3, stride=stride,
                                  padding=dilation, dilation=dilation)
        else:
            self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                                padding=dilation, dilation=dilation,
                                bias=False)
        self.bn2 = make_norm(norm, planes)
        self.conv3 = Conv2d(planes, planes * EXPANSION, 1, bias=False,
                            dilation=dilation)
        self.bn3 = make_norm(norm, planes * EXPANSION)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * EXPANSION, 1, stride=stride,
                   bias=False, dilation=dilation),
            make_norm(norm, planes * EXPANSION)) if has_downsample else None

    @property
    def use_dcn(self) -> bool:
        return isinstance(self.conv2, DCNLayer)

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                bn_train: bool = False) -> torch.Tensor:
        return self.forward_rows(x, None, use_kernels, bn_train)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     use_kernels: bool = True, bn_train: bool = False
                     ) -> Tuple[torch.Tensor, Optional[Rows]]:
        """:meth:`forward` on a rank's rows of the input map (`rows`; None:
        the whole map), with the output's rows."""
        out, r = conv_rows(self.conv1, x, rows)
        out = F.relu(self.bn1(out, bn_train, r))
        if self.use_dcn:
            out, r = self.conv2.forward_rows(out, r, use_kernels)
        else:
            out, r = conv_rows(self.conv2, out, r)
        out = F.relu(self.bn2(out, bn_train, r))
        out = self.bn3(conv_rows(self.conv3, out, r)[0], bn_train, r)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](
                conv_rows(self.downsample[0], x, rows)[0], bn_train, r)
        return F.relu(out + residual), r


def _stage_plan(layers: Sequence[int], dcn_layers: Sequence[int],
                dcn_interval: int, atrous_layers: Sequence[int],
                extra_stages: int) -> Tuple[Tuple[dict, ...], ...]:
    """Static plan of all bottleneck blocks, as the JAX package's
    ``_stage_plan`` (dilation accumulates over atrous stages)."""
    plans = []
    inplanes = 64
    dilation = 1
    all_planes = [64, 128, 256, 512] + [1024 // EXPANSION] * extra_stages
    all_blocks = list(layers) + [1] * extra_stages
    all_dcn = list(dcn_layers) + [0] * (len(all_blocks) - len(dcn_layers))

    for stage_idx, (planes, blocks) in enumerate(zip(all_planes, all_blocks)):
        stride = 1 if stage_idx == 0 else 2
        dcn_budget = all_dcn[stage_idx]
        has_ds = stride != 1 or inplanes != planes * EXPANSION
        if has_ds and stage_idx in atrous_layers:
            dilation += 1
            stride = 1
        stage = [dict(inplanes=inplanes, planes=planes, stride=stride,
                      dilation=dilation, use_dcn=dcn_budget >= blocks,
                      has_downsample=has_ds)]
        inplanes = planes * EXPANSION
        for i in range(1, blocks):
            # the reference gives the accumulated dilation ONLY to block 0;
            # blocks i > 0 use the Bottleneck default dilation=1
            stage.append(dict(
                inplanes=inplanes, planes=planes, stride=1, dilation=1,
                use_dcn=((i + dcn_budget) >= blocks) and i % dcn_interval == 0,
                has_downsample=False))
        plans.append(tuple(stage))
    return tuple(plans)


class ResNetBackbone(nn.Module):
    """Returns one feature map per stage (C2..C5 [+ extra stages]).
    ``use_kernels=False`` runs the plain PyTorch versions of the DCN
    sampling and the s2d stem conv.

    ``stem_s2d``: the input is the 2x2 space-to-depth of the raw-order
    (BGR) image, ``[B, 12, S/2, S/2]`` (``models/layers.py:s2d_input``),
    and the stem runs as the 4x4/s1 conv of ``kernels/stem.py`` with the
    weight derived from ``conv1.weight`` by ``s2d_stem_kernel``.  The
    parameter keeps its name and shape, so state dicts are unchanged.  For
    inference the derived weight is cached and rebuilt whenever
    ``conv1.weight`` changes: another storage (a dtype cast or a move to
    another device) or an in-place write (``load_state_dict``) bumps the key
    it is cached on.  Under grad mode, when ``conv1.weight`` requires grad,
    it is derived anew in every forward as part of the graph, so the stem's
    gradient reaches the parameter.

    ``bn_train`` runs the batch norms on batch statistics
    (``models/layers.py:BatchNorm2d``).  ``remat`` ('none', 'dcn', 'all': the
    JAX ``train_remat``) wraps the DCN bottlenecks, or all of them, in
    ``torch.utils.checkpoint``: their intermediates (the im2col columns most
    of all) are computed again in the backward pass instead of kept, so each
    such block's forward, the DCN sampling kernel included, runs twice per
    step.  The numbers do not change."""

    def __init__(self, layers: Sequence[int],
                 dcn_layers: Sequence[int] = (0, 0, 0, 0),
                 dcn_interval: int = 1, atrous_layers: Sequence[int] = (),
                 num_stages: Optional[int] = None, stem_s2d: bool = False,
                 norm: str = 'bn'):
        super().__init__()
        extra = max(0, (num_stages or len(layers)) - len(layers))
        plans = _stage_plan(layers, dcn_layers, dcn_interval, atrous_layers,
                            extra)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_norm(norm, 64)
        self.layers = nn.ModuleList(
            nn.Sequential(*[Bottleneck(**blk, norm=norm) for blk in stage])
            for stage in plans)
        self.stem_s2d = stem_s2d
        self._w2 = None    # (conv1.weight's storage, its version, 4x4 weight)

    def s2d_weight(self) -> torch.Tensor:
        """``conv1.weight`` as the 4x4/s1 weight ``[64, 12, 4, 4]`` of the
        s2d stem, in the weight's dtype and on its device."""
        conv = self.conv1
        if (conv.kernel_size, conv.stride, conv.padding, conv.dilation,
                conv.bias) != ((7, 7), (2, 2), (3, 3), (1, 1), None):
            raise NotImplementedError('stem_s2d supports 7x7/s2/p3')
        w = conv.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return s2d_stem_kernel(w).contiguous()
        if self._w2 is not None:
            src, version, w2 = self._w2
            # src shares w's storage while it is cached, so an equal
            # data_ptr means the same storage, not a reused address
            if (src.data_ptr() == w.data_ptr() and src.device == w.device
                    and src.dtype == w.dtype and version == w._version):
                return w2
        with torch.no_grad():
            src = w.detach()
            self._w2 = (src, w._version, s2d_stem_kernel(src).contiguous())
        return self._w2[2]

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                bn_train: bool = False,
                remat: str = 'none') -> Tuple[torch.Tensor, ...]:
        return self.forward_rows(x, None, use_kernels, bn_train, remat)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     use_kernels: bool = True, bn_train: bool = False,
                     remat: str = 'none'
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Tuple[Optional[Rows], ...]]:
        """:meth:`forward` on a rank's rows of the input (the image, or
        its s2d input; `rows`, None: the whole input), with each output's
        rows.  Split, the s2d stem runs its kernel on the s2d rows
        ``[o0 - 2, o1 + 1)`` (zeros outside the image) and keeps output
        rows ``[2, 2 + o1 - o0)``, whose taps never reach the kernel's own
        padding: the whole image's rows.  Checkpointed blocks fetch their
        halos again in the backward, on every rank alike."""
        if remat not in ('none', 'dcn', 'all'):
            raise ValueError(f"train_remat={remat!r}: expected one of "
                             f"'none', 'dcn', 'all'")
        r = rows
        if self.stem_s2d:
            fn = stem.stem_conv_s2d if use_kernels else stem.stem_conv_s2d_plain
            w = self.s2d_weight().to(x.dtype)
            if rows is None:
                x = fn(x.contiguous(), w)
            else:
                lo, hi = rows.own()
                xw = fetch_rows(x, rows, [(o0 - 2, max(o1, o0 + 1) + 1)
                                          for o0, o1 in rows.owns()])
                x = fn(xw.contiguous(), w)[:, :, 2:2 + hi - lo]
        else:
            x, r = conv_rows(self.conv1, x, rows)
        x = F.relu(self.bn1(x, bn_train, r))
        x, r = max_pool_rows(x, r, 3, 2, 1)
        outs, heights = [], []
        for stage in self.layers:
            for block in stage:
                if (torch.is_grad_enabled()
                        and (remat == 'all'
                             or (remat == 'dcn' and block.use_dcn))):
                    x, r = checkpoint(block.forward_rows, x, r, use_kernels,
                                      bn_train, use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    x, r = block.forward_rows(x, r, use_kernels, bn_train)
            outs.append(x)
            heights.append(r)
        return tuple(outs), tuple(heights)
