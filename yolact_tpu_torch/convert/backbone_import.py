"""Backbone-only pretrained weights and the focal-loss bias init of a fresh
training run.

Port of ``yolact_tpu/convert/backbone_import.py`` for the ResNet family
(yolact_base, yolact_plus_base and their ResNet-50 variants): the
reference's ``init_backbone`` (``backbone.py:141-154``) reads a torchvision
ResNet ``state_dict`` (``resnet101_reducedfc.pth``), whose ``layerN.`` keys
become the port's ``layers.{N-1}.`` and whose ``fc.`` classifier is
dropped.  The port's parameter names are the reference's, so the keys need
no further conversion: they are prefixed with ``backbone.`` and merged into
the model's state dict.  The other backbone families (DarkNet, VGG and
ResNet-GN's Detectron blobs) come with their models (ROADMAP A8).

:func:`focal_bias_init` is the reference's focal-loss initialisation of the
class-confidence biases (``yolact.py:529-545``), with its quirk.
"""

from __future__ import annotations

import math
from typing import Dict

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


def load_backbone_weights(cfg: YolactConfig, path: str
                          ) -> Dict[str, torch.Tensor]:
    """A backbone pretraining checkpoint -> ``backbone.*`` float32 tensors
    under the port's state-dict keys (batch norm's
    ``num_batches_tracked`` dropped)."""
    if cfg.backbone.type != 'resnet':
        raise NotImplementedError(
            f'backbone weights of type {cfg.backbone.type!r} are not ported '
            f'(ROADMAP A8)')
    sd = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return {f'backbone.{k}': torch.as_tensor(v).float()
            for k, v in resnet_backbone_sd(sd).items()
            if not k.endswith('num_batches_tracked')}


def merge_backbone(state_dict: Dict[str, torch.Tensor],
                   backbone: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Overlay the backbone weights onto a fresh model's state dict (the
    other weights keep their init).  Raises unless every ``backbone.`` key
    of the model is matched by a weight of the same shape and every
    backbone weight has a key in the model: a partial merge would start a
    run "from pretrained weights" that are partly random."""
    if not backbone:
        raise ValueError('merge_backbone merged zero parameters')
    model_keys = {k for k in state_dict if k.startswith('backbone.')}
    unknown = sorted(set(backbone) - model_keys)
    missing = sorted(model_keys - set(backbone))
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
