"""Static anchor (prior) generation, in numpy.

Port of ``yolact_tpu/ops/anchors.py``: the full ``[num_priors, 4]``
center-size prior tensor is computed once on the host per config and input
size, in the iteration order the heads' conv outputs flatten to
(row-major pixels, then aspect-ratio group, scale, ratio), including the
reference's ``use_square_anchors`` bug-compat flag.  The result equals the
JAX package's bit for bit, for every backbone family (ResNet, ResNet-GN,
DarkNet, VGG).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from yolact_tpu_torch.config import YolactConfig


def _conv_out(size: int, k: int, s: int, p: int, d: int = 1,
              ceil_mode: bool = False) -> int:
    num = size + 2 * p - (d * (k - 1) + 1)
    if ceil_mode:
        return -(-num // s) + 1
    return num // s + 1


def _resnet_sizes(img: int, num_layers: int, atrous_layers=()) -> List[int]:
    """Feature sizes after each ResNet stage (stem conv, max pool, then a
    stride-2 3x3 conv opening every stage but the first and atrous ones)."""
    s = _conv_out(img, 7, 2, 3)   # conv1
    s = _conv_out(s, 3, 2, 1)     # maxpool
    sizes = []
    for i in range(num_layers):
        if i != 0 and i not in atrous_layers:
            s = _conv_out(s, 3, 2, 1)
        sizes.append(s)
    return sizes


def _darknet_sizes(img: int, num_layers: int) -> List[int]:
    """Each DarkNet stage opens with a stride-2 3x3 conv (the preconv is
    stride 1)."""
    s = img
    sizes = []
    for _ in range(num_layers):
        s = _conv_out(s, 3, 2, 1)
        sizes.append(s)
    return sizes


def _vgg_sizes(img: int, arch, extra_args, num_layers: int) -> List[int]:
    """VGG group sizes with the pools' own parameters, then the SSD extra
    stages (``models/vgg.py``)."""
    s = img
    sizes = []
    for group in arch:
        for v in group:
            kw = {}
            if isinstance(v, tuple):
                kw = dict(v[1])
                v = v[0]
            if v == 'M':
                s = _conv_out(s, kw.get('kernel_size', 2),
                              kw.get('stride', 2), kw.get('padding', 0),
                              ceil_mode=kw.get('ceil_mode', False))
            else:
                # the 3x3/p1 default holds only for an entry without kwargs
                if not kw:
                    kw = {'kernel_size': 3, 'padding': 1}
                s = _conv_out(s, kw.get('kernel_size', 3),
                              kw.get('stride', 1), kw.get('padding', 0),
                              kw.get('dilation', 1))
        sizes.append(s)
    extras = list(extra_args)
    while len(sizes) < num_layers and extras:
        _, downsample = extras.pop(0)
        s = _conv_out(s, 1, 1, 0)
        s = _conv_out(s, 3, downsample, 1 if downsample > 1 else 0)
        sizes.append(s)
    return sizes


def _feature_sizes_1d(cfg: YolactConfig, img: int) -> List[int]:
    bb = cfg.backbone
    n_backbone = max(bb.selected_layers) + 1
    if bb.type in ('resnet', 'resnet_gn'):
        atrous = bb.args[3] if len(bb.args) > 3 else ()
        sizes = _resnet_sizes(img, max(n_backbone, len(bb.args[0])), atrous)
    elif bb.type == 'darknet':
        sizes = _darknet_sizes(img, max(n_backbone, len(bb.args[0])))
    elif bb.type == 'vgg':
        arch, extra_args, _ = bb.args
        sizes = _vgg_sizes(img, arch, extra_args, n_backbone)
    else:
        raise ValueError(f'unknown backbone type {bb.type!r}')
    selected = [sizes[i] for i in bb.selected_layers]
    if cfg.fpn is not None:
        for _ in range(cfg.fpn.num_downsample):
            if cfg.fpn.use_conv_downsample:
                selected.append(_conv_out(selected[-1], 3, 2, 1))
            else:
                selected.append((selected[-1] - 1) // 2 + 1)
    return selected


def feature_map_sizes(cfg: YolactConfig, img_size=None
                      ) -> Tuple[Tuple[int, int], ...]:
    """(h, w) of each prediction feature map, in head order.  `img_size`
    is an int (square) or an (h, w) tuple."""
    img = img_size or cfg.max_size
    if isinstance(img, tuple):
        return tuple(zip(_feature_sizes_1d(cfg, img[0]),
                         _feature_sizes_1d(cfg, img[1])))
    return tuple((s, s) for s in _feature_sizes_1d(cfg, img))


def _level_priors(conv_h: int, conv_w: int, aspect_ratios, scales,
                  cfg: YolactConfig) -> np.ndarray:
    """Priors of one feature level, vectorised over pixels."""
    bb = cfg.backbone
    whs = []
    for ars in aspect_ratios:
        for scale in scales:
            for ar in ars:
                a = ar if bb.preapply_sqrt else math.sqrt(ar)
                if bb.use_pixel_scales:
                    w = scale * a / cfg.max_size
                    h = scale / a / cfg.max_size
                else:
                    w = scale * a / conv_w
                    h = scale / a / conv_h
                if bb.use_square_anchors:
                    h = w
                whs.append((w, h))
    whs = np.array(whs, dtype=np.float32)              # [k, 2]
    xs = (np.arange(conv_w, dtype=np.float32) + 0.5) / conv_w
    ys = (np.arange(conv_h, dtype=np.float32) + 0.5) / conv_h
    xy = np.stack(np.meshgrid(xs, ys), axis=-1)        # [h, w, 2] (x, y)
    xy = np.broadcast_to(xy[:, :, None, :], (conv_h, conv_w, len(whs), 2))
    wh = np.broadcast_to(whs[None, None, :, :], xy.shape)
    return np.concatenate([xy, wh], axis=-1).reshape(-1, 4).astype(np.float32)


@lru_cache(maxsize=32)
def _generate_priors_cached(cfg: YolactConfig, img_size) -> np.ndarray:
    levels = [
        _level_priors(h, w, cfg.backbone.pred_aspect_ratios[i],
                      cfg.backbone.pred_scales[i], cfg)
        for i, (h, w) in enumerate(feature_map_sizes(cfg, img_size))]
    out = np.concatenate(levels, axis=0)
    out.setflags(write=False)        # shared by every caller of the cache
    return out


def generate_priors(cfg: YolactConfig, img_size=None) -> np.ndarray:
    """All priors [num_priors, 4] in center-size form (read-only, cached
    per config).  `img_size` is an int or an (h, w) tuple."""
    return _generate_priors_cached(cfg, img_size or cfg.max_size)


def spec_out_hw(spec, h: int, w: int) -> Tuple[int, int]:
    """Static (h, w) through a make_net layer spec (the entries
    ``models.layers.make_net`` builds)."""
    for entry in spec:
        num, k = entry[0], entry[1]
        kw = dict(entry[2]) if len(entry) > 2 else {}
        if isinstance(num, str):        # 'cat': the branches' sizes agree
            h, w = spec_out_hw(k[0], h, w)
        elif k > 0:                     # conv
            s, p, d = kw.get('stride', 1), kw.get('padding', 0), \
                kw.get('dilation', 1)
            h, w = _conv_out(h, k, s, p, d), _conv_out(w, k, s, p, d)
        elif num is None:               # bilinear upsample by -k
            h, w = h * -k, w * -k
        else:                           # transposed conv, torch's size
            s, p = kw.get('stride', 1), kw.get('padding', 0)
            h, w = (h - 1) * s - 2 * p - k, (w - 1) * s - 2 * p - k
    return h, w


def proto_size(cfg: YolactConfig, img_size=None) -> Tuple[int, int]:
    """(h, w) of the protonet output."""
    img = img_size or cfg.max_size
    if cfg.mask_proto_src is None:
        h, w = img if isinstance(img, tuple) else (img, img)
    else:
        h, w = feature_map_sizes(cfg, img_size)[cfg.mask_proto_src]
    return spec_out_hw(cfg.mask_proto_net, h, w)


def seg_size(cfg: YolactConfig, img_size=None) -> Tuple[int, int]:
    """(h, w) of the semantic-seg aux head (1x1 conv on outs[0] —
    models/yolact.py), the gt downsample target of
    semantic_segmentation_loss (multibox_loss.py:225-228)."""
    return feature_map_sizes(cfg, img_size)[0]
