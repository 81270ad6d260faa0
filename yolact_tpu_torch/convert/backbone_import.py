"""Backbone-only pretrained weights and the focal-loss bias init of a fresh
training run.

Port of ``yolact_tpu/convert/backbone_import.py`` for all four backbone
families, replacing the reference's per-backbone ``init_backbone`` remaps:

* ResNet (``backbone.py:141-154``): a torchvision ``state_dict``
  (``resnet101_reducedfc.pth``), whose ``layerN.`` keys become
  ``layers.{N-1}.`` and whose ``fc.`` classifier is dropped;
* ResNet-GN (``backbone.py:168-214``): a Detectron pickle of numpy blobs
  (``R-101-GN.pkl``, read with ``pickle``, ``encoding='latin1'``);
* DarkNet (``backbone.py:315-318``): ``darknet53.pth`` already in the
  reference's layout;
* VGG (``backbone.py:415-426``): torchvision's flat ``features`` keys
  (``0.weight``, ``2.weight``, ...) become ``layers.{g}.{i}``.

The port's parameter names are the reference's, so the keys need no further
conversion: they are prefixed with ``backbone.`` and merged into the
model's state dict.

:func:`focal_bias_init` is the reference's focal-loss initialisation of the
class-confidence biases (``yolact.py:529-545``), with its quirk.
"""

from __future__ import annotations

import math
import pickle
from typing import Any, Dict, Sequence

import numpy as np
import torch

from yolact_tpu_torch.config import YolactConfig


def resnet_backbone_sd(sd: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """torchvision resnet keys -> reference layout (layerN -> layers.N-1)."""
    out = {}
    for k, v in sd.items():
        if k.startswith('layer') and not k.startswith('layers'):
            idx = int(k[5])
            k = f'layers.{idx - 1}' + k[6:]
        if k.startswith('fc.'):
            continue
        out[k] = v
    return out


def vgg_backbone_sd(arch: Sequence[Any], sd: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """torchvision-flat VGG keys ('0.weight', '2.weight', ...) ->
    'layers.g.l' layout, mirroring the reference's state_dict_lookup
    bookkeeping (backbone.py:343-346,369-380)."""
    lookup = {}
    total = 0
    for g, group in enumerate(arch):
        in_group = 0
        for v in group:
            if isinstance(v, tuple):
                v = v[0]
            if v == 'M':
                in_group += 1
            else:
                lookup[total + in_group] = (g, in_group)
                in_group += 2  # conv + relu
        total += in_group
    out = {}
    for k, v in sd.items():
        parts = k.split('.')
        if not parts[0].isdigit():
            continue
        flat = int(parts[0])
        if flat not in lookup:
            continue
        g, l = lookup[flat]
        out[f'layers.{g}.{l}.{parts[1]}'] = v
    return out


def gn_backbone_sd(num_layers: Sequence[int], blob: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """Detectron GN blob dict -> reference-style keys (backbone.py:168-214).

    Detectron names: conv1_w, conv1_gn_s/gn_b, res{2..5}_{i}_branch2{a,b,c}_w
    (+_gn_s/_gn_b), res{N}_{i}_branch1_w (+gn) for the projection shortcut.
    """
    out = {}
    out['conv1.weight'] = blob['conv1_w']
    out['bn1.weight'] = blob['conv1_gn_s']
    out['bn1.bias'] = blob['conv1_gn_b']
    branch = {'conv1': 'branch2a', 'conv2': 'branch2b', 'conv3': 'branch2c'}
    for si, blocks in enumerate(num_layers):
        res = f'res{si + 2}'
        for bi in range(blocks):
            for ours, theirs in branch.items():
                out[f'layers.{si}.{bi}.{ours}.weight'] = \
                    blob[f'{res}_{bi}_{theirs}_w']
                out[f'layers.{si}.{bi}.bn{ours[-1]}.weight'] = \
                    blob[f'{res}_{bi}_{theirs}_gn_s']
                out[f'layers.{si}.{bi}.bn{ours[-1]}.bias'] = \
                    blob[f'{res}_{bi}_{theirs}_gn_b']
            b1 = f'{res}_{bi}_branch1_w'
            if b1 in blob:
                out[f'layers.{si}.{bi}.downsample.0.weight'] = blob[b1]
                out[f'layers.{si}.{bi}.downsample.1.weight'] = \
                    blob[f'{res}_{bi}_branch1_gn_s']
                out[f'layers.{si}.{bi}.downsample.1.bias'] = \
                    blob[f'{res}_{bi}_branch1_gn_b']
    return out


def load_backbone_weights(cfg: YolactConfig, path: str
                          ) -> Dict[str, torch.Tensor]:
    """A backbone pretraining checkpoint -> ``backbone.*`` float32 tensors
    under the port's state-dict keys (batch norm's
    ``num_batches_tracked`` dropped)."""
    bb = cfg.backbone
    if bb.type == 'resnet_gn':
        with open(path, 'rb') as f:
            blob = pickle.load(f, encoding='latin1')
        if 'blobs' in blob:
            blob = blob['blobs']
        sd = gn_backbone_sd(bb.args[0], blob)
    else:
        sd = torch.load(path, map_location='cpu', weights_only=False)
        if isinstance(sd, dict) and 'state_dict' in sd:
            sd = sd['state_dict']
        if bb.type == 'resnet':
            sd = resnet_backbone_sd(sd)
        elif bb.type == 'vgg' and any(k.split('.')[0].isdigit() for k in sd):
            sd = vgg_backbone_sd(bb.args[0], sd)
    return {f'backbone.{k}': (v if isinstance(v, torch.Tensor)
                              else torch.from_numpy(np.asarray(v))).float()
            for k, v in sd.items()
            if not k.endswith('num_batches_tracked')}


def backbone_keys_not_in_files(cfg: YolactConfig) -> Sequence[str]:
    """Prefixes of the model's backbone keys that a pretraining file lacks
    by design: VGG's ``norms`` and its SSD extra stages, which the
    reference adds to torchvision's ``features`` and leaves at their init
    (its ``init_backbone`` loads with ``strict=False``)."""
    bb = cfg.backbone
    if bb.type != 'vgg':
        return ()
    n_arch = len(bb.args[0])
    n_stages = max(max(bb.selected_layers) + 1, n_arch)
    return ('backbone.norms.',) + tuple(f'backbone.layers.{g}.'
                                        for g in range(n_arch, n_stages))


def merge_backbone(state_dict: Dict[str, torch.Tensor],
                   backbone: Dict[str, torch.Tensor], cfg: YolactConfig
                   ) -> Dict[str, torch.Tensor]:
    """Overlay the backbone weights onto a fresh model's state dict (the
    other weights keep their init).  Raises unless every ``backbone.`` key
    of the model (but those that ``cfg``'s pretraining files lack by
    design, :func:`backbone_keys_not_in_files`) is matched by a weight of
    the same shape and every backbone weight has a key in the model: a
    partial merge would start a run "from pretrained weights" that are
    partly random."""
    if not backbone:
        raise ValueError('merge_backbone merged zero parameters')
    model_keys = {k for k in state_dict if k.startswith('backbone.')}
    unknown = sorted(set(backbone) - model_keys)
    may_lack = tuple(backbone_keys_not_in_files(cfg))
    missing = sorted(k for k in model_keys - set(backbone)
                     if not k.startswith(may_lack))
    if unknown or missing:
        raise ValueError(
            f'merge_backbone: {len(unknown)} backbone weights the model '
            f'lacks, e.g. {unknown[:5]}; {len(missing)} backbone keys of '
            f'the model unmatched, e.g. {missing[:5]}')
    bad = sorted(k for k, v in backbone.items()
                 if tuple(v.shape) != tuple(state_dict[k].shape))
    if bad:
        raise ValueError(f'merge_backbone: shapes differ for {bad[:5]}')
    return dict(state_dict, **backbone)


def focal_bias_init(cfg: YolactConfig, state_dict: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """conf_layer bias init for focal loss (yolact.py:529-545)."""
    if not cfg.use_focal_loss:
        return state_dict
    out = dict(state_dict)
    pi = cfg.focal_loss_init_pi
    for key, bias in state_dict.items():
        if not (key.startswith('prediction_layers.')
                and key.endswith('.conf_layer.bias')):
            continue
        bias = bias.clone()
        # exact reference quirk: only element 0 is treated as "background";
        # the rest of the whole (num_priors*num_classes) bias vector gets
        # the foreground value (yolact.py:540-546)
        if not cfg.use_sigmoid_focal_loss:
            bias[0] = math.log((1 - pi) / pi)
            bias[1:] = -math.log(len(bias) - 1)
        else:
            bias[0] = -math.log(pi / (1 - pi))
            bias[1:] = -math.log((1 - pi) / pi)
        out[key] = bias
    return out
