"""Prototype network and prediction head, over channels_last maps.

Port of ``yolact_tpu/models/heads.py`` (``ProtoNet``, ``PredictionHead``,
``FastMaskIoUNet``).  Parameter names are the reference's
(``proto_net.{i}``, ``upfeature.{i}``, ``block``, ``conv``, ``bn``,
``bbox_layer``, ``conf_layer``, ``mask_layer``, ``gate_layer``,
``score_layer``, ``inst_layer``, ``maskiou_net.{i}``, ...).

The protonet and a head also run on a rank's rows of their input under a
spatial split (``parallel/mesh.py``; ``rows``), through the same wiring as
on whole maps; the head gathers its raw conv outputs to the whole height
(every rank then holds the same level, as the loss and the detection
consume it) before the flatten, whose order is (H, W, anchors).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.config import MaskType, YolactConfig
from yolact_tpu_torch.models.layers import (BatchNorm2d, Conv2d, conv_rows,
                                            height, make_net, run_rows)
from yolact_tpu_torch.models.resnet import Bottleneck
from yolact_tpu_torch.parallel.mesh import Rows, gather_rows


# head outputs that inference reads and no training loss does
EVAL_ONLY = ('score', 'inst')


def _activation(name: str):
    return {
        'tanh': torch.tanh,
        'sigmoid': torch.sigmoid,
        'relu': F.relu,
        'softmax': lambda x: torch.softmax(x, dim=-1),
        'none': lambda x: x,
    }[name]


def _load_grid(path: str) -> np.ndarray:
    """``mask_proto_grid_file`` as a float32 ``[g, h, w]`` array.  A relative
    path that does not exist from the working directory resolves against
    the repository root, as JAX's ``ProtoNet`` does (the reference resolves
    against the working directory only)."""
    if not os.path.isabs(path) and not os.path.exists(path):
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            path = cand
    return np.load(path).astype(np.float32)


class ProtoNet(nn.Sequential):
    """Mask prototype network.  An ``nn.Sequential`` of the make_net spec
    (so its parameters are ``proto_net.{i}``), followed by the prototype
    activation.  [B, C, H, W] in and out, channels_last.

    ``mask_proto_use_grid`` concatenates the grid file's channels to the
    input (a buffer outside the state dict, as the reference keeps it);
    ``mask_proto_bias`` appends a channel of ones after the activation."""

    def __init__(self, cfg: YolactConfig, in_channels: int):
        grid = None
        if cfg.mask_proto_use_grid:
            grid = torch.from_numpy(_load_grid(cfg.mask_proto_grid_file))
            in_channels += grid.shape[0]
        net, _ = make_net(in_channels, cfg.mask_proto_net,
                          include_last_relu=False)
        super().__init__(*net)
        self.activation = cfg.mask_proto_prototype_activation
        self.bias = cfg.mask_proto_bias
        self.grid_file = cfg.mask_proto_grid_file
        self.register_buffer('grid', grid, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_rows(x, None)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows]
                     ) -> Tuple[torch.Tensor, Optional[Rows]]:
        """:meth:`forward` on a rank's rows of the input (`rows`; None: the
        whole map), with the output's rows.  The grid is the whole map's:
        a rank joins its own rows of it."""
        if self.grid is not None:
            hw = (height(x, rows), x.shape[3])
            if tuple(self.grid.shape[1:]) != hw:
                raise ValueError(
                    f'mask_proto_grid_file {self.grid_file!r} has spatial '
                    f'shape {tuple(self.grid.shape[1:])} but the proto-net '
                    f'input convout is {hw}; regenerate with '
                    f'scripts/make_grid.py --size {hw[0]},{hw[1]}')
            grid = self.grid.to(x.dtype)
            if rows is not None:
                grid = rows.take(grid, dim=1)
            grid = grid.expand(x.shape[0], -1, -1, -1)
            # a cat of mixed layouts comes out NCHW
            x = torch.cat([x, grid.contiguous(
                memory_format=torch.channels_last)], dim=1)
        x, rows = run_rows(self, x, rows)
        x = _activation(self.activation)(x)
        if self.bias:
            x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        return x, rows


def _flatten(y: torch.Tensor, last: int) -> torch.Tensor:
    """[B, A*last, H, W] conv output -> [B, H*W*A, last], the JAX NHWC
    flatten order (a view of a channels_last output)."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, last)


class PredictionHead(nn.Module):
    """Head producing (loc, conf, mask) per anchor, plus ``score``
    (``use_mask_scoring``) and ``inst`` (``use_instance_coeff``).

    ``use_prediction_module`` is DSSD's module (c): a bottleneck
    (``block``) plus a 1x1 conv and batch norm (``conv``, ``bn``), summed
    after a ReLU of the second, with batch statistics in training.
    ``use_yolo_regressors`` squashes the box centre to (-0.5, 0.5) of a
    cell and divides by the conv grid.  The mask output is the sigmoid of
    ``mask_size^2`` values for direct masks; for lincomb the coefficient
    activation, times the sigmoid of ``gate_layer`` with
    ``mask_proto_coeff_gate``.  With ``mask_proto_split_prototypes_by_head``
    head ``head_index`` predicts ``mask_dim / num_heads`` coefficients and
    pads them into its slice of the full ``mask_dim``."""

    def __init__(self, cfg: YolactConfig, in_channels: int, num_priors: int):
        super().__init__()
        self.cfg = cfg
        self.split = (cfg.mask_proto_split_prototypes_by_head
                      and cfg.mask_type == MaskType.LINCOMB)
        self.mask_dim = cfg.mask_dim // cfg.num_heads if self.split \
            else cfg.mask_dim

        ch = in_channels
        self.upfeature = None
        if cfg.extra_head_net is not None:
            self.upfeature, ch = make_net(ch, cfg.extra_head_net,
                                          include_last_relu=True)
        if cfg.use_prediction_module:
            self.block = Bottleneck(ch, ch // 4)
            self.conv = Conv2d(ch, ch, 1)
            self.bn = BatchNorm2d(ch)
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.shared = cfg.share_prediction_module

        def extra(n_layers):
            mods = []
            for _ in range(n_layers):
                mods += [Conv2d(ch, ch, 3, padding=1), nn.ReLU()]
            return nn.Sequential(*mods)

        self.bbox_extra, self.conf_extra, self.mask_extra = (
            extra(n) for n in cfg.extra_layers)

        hp = cfg.head_layer_params_dict
        k, p = hp.get('kernel_size', 3), hp.get('padding', 0)
        self.bbox_layer = Conv2d(ch, num_priors * 4, k, padding=p)
        self.conf_layer = Conv2d(ch, num_priors * cfg.num_classes, k,
                                 padding=p)
        if cfg.eval_mask_branch:
            self.mask_layer = Conv2d(ch, num_priors * self.mask_dim, k,
                                     padding=p)
            if cfg.mask_proto_coeff_gate and \
                    cfg.mask_type == MaskType.LINCOMB:
                self.gate_layer = Conv2d(ch, num_priors * self.mask_dim, 3,
                                         padding=1)
        if cfg.use_mask_scoring:
            self.score_layer = Conv2d(ch, num_priors, k, padding=p)
        if cfg.use_instance_coeff:
            self.inst_layer = Conv2d(ch, num_priors * cfg.num_instance_coeffs,
                                     k, padding=p)

    def forward(self, x: torch.Tensor, head_index: int = 0,
                bn_train: bool = False,
                rows: Optional[Rows] = None) -> Dict[str, torch.Tensor]:
        """The level's outputs.  `rows`: `x` is a rank's rows of the level
        under a spatial split; the raw conv outputs are then gathered to
        the level's whole height, with each rank keeping its own rows'
        gradient (every rank consumes them alike), so every rank returns
        the whole level's outputs."""
        if self.upfeature is not None:
            x, rows = run_rows(self.upfeature, x, rows)
        if self.cfg.use_prediction_module:
            a = self.block.forward_rows(x, rows, bn_train=bn_train)[0]
            x = a + F.relu(self.bn(conv_rows(self.conv, x, rows)[0],
                                   bn_train))
        got = {}

        def run(net, t):
            y, r = (run_rows(net, t, rows) if isinstance(net, nn.Sequential)
                    else conv_rows(net, t, rows))
            got[id(y)] = r
            return y

        maps = self._maps(x, run)
        if rows is not None:
            # one gather per output height (one for the configs' 'same'
            # convs), the outputs no loss reads apart: in training their
            # gather's backward then runs on no rank, and their layers get
            # no gradient (and no weight decay), as in one process
            full = {}
            for group in dict.fromkeys((got[id(m)], k in EVAL_ONLY)
                                       for k, m in maps.items()):
                names = [k for k, m in maps.items()
                         if (got[id(m)], k in EVAL_ONLY) == group]
                whole = gather_rows(torch.cat([maps[k] for k in names], 1),
                                    group[0], 'shared')
                full.update(zip(names, whole.split(
                    [maps[k].shape[1] for k in names], 1)))
            maps = full
        return self._outputs(maps, head_index, (height(x, rows), x.shape[3]))

    def _maps(self, x: torch.Tensor, run) -> Dict[str, torch.Tensor]:
        """The raw conv outputs [B, A * n, H, W] by output name (and the
        coefficient gate's), `run(net, x)` running a layer or a net."""
        cfg = self.cfg
        maps = {'loc': run(self.bbox_layer, run(self.bbox_extra, x)),
                'conf': run(self.conf_layer, run(self.conf_extra, x))}
        if cfg.eval_mask_branch:
            maps['mask'] = run(self.mask_layer, run(self.mask_extra, x))
            if cfg.mask_type == MaskType.LINCOMB and \
                    cfg.mask_proto_coeff_gate:
                maps['gate'] = run(self.gate_layer, x)
        if cfg.use_mask_scoring:
            maps['score'] = run(self.score_layer, x)
        if cfg.use_instance_coeff:
            maps['inst'] = run(self.inst_layer, x)
        return maps

    def _outputs(self, maps: Dict[str, torch.Tensor], head_index: int,
                 hw) -> Dict[str, torch.Tensor]:
        """The head's outputs from its raw conv outputs; `hw`: the conv
        grid's (H, W)."""
        cfg = self.cfg
        bbox = _flatten(maps['loc'], 4)
        if cfg.use_yolo_regressors:
            grid = torch.tensor([hw[1], hw[0]], dtype=bbox.dtype,
                                device=bbox.device)
            xy = (torch.sigmoid(bbox[..., :2]) - 0.5) / grid
            bbox = torch.cat([xy, bbox[..., 2:]], dim=-1)
        conf = _flatten(maps['conf'], cfg.num_classes)
        if cfg.eval_mask_branch:
            mask = _flatten(maps['mask'], self.mask_dim)
            if cfg.mask_type == MaskType.DIRECT:
                mask = torch.sigmoid(mask)
            else:
                mask = _activation(cfg.mask_proto_coeff_activation)(mask)
                if cfg.mask_proto_coeff_gate:
                    mask = mask * torch.sigmoid(
                        _flatten(maps['gate'], self.mask_dim))
        else:
            # box-only mode: zero coefficients keep the output shapes
            mask = bbox.new_zeros((bbox.shape[0], bbox.shape[1],
                                   self.mask_dim))
        if self.split:
            pad = (head_index * self.mask_dim,
                   (cfg.num_heads - head_index - 1) * self.mask_dim)
            mask = F.pad(mask, pad)
        out = {'loc': bbox, 'conf': conf, 'mask': mask}
        if cfg.use_mask_scoring:
            out['score'] = _flatten(maps['score'], 1)
        if cfg.use_instance_coeff:
            out['inst'] = _flatten(maps['inst'], cfg.num_instance_coeffs)
        return out


class FastMaskIoUNet(nn.Module):
    """YOLACT++ mask scorer: a small convnet over assembled masks, then a
    global max.  Input [N, 1, H, W], output [N, num_classes - 1].  Its
    parameters are ``maskiou_net.{i}``."""

    def __init__(self, cfg: YolactConfig):
        super().__init__()
        spec = tuple(cfg.maskiou_net) + ((cfg.num_classes - 1, 1, ()),)
        self.maskiou_net, _ = make_net(1, spec, include_last_relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maskiou_net(x).amax(dim=(2, 3))
