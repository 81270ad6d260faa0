"""Inference weights for the port.

Port of the ``.pth`` branch of ``yolact_tpu/train/checkpoint.py:load_weights``.
A reference ``.pth`` holds the torch ``state_dict`` whose key names the
port's modules already have, so it loads with no converter: the file is
read with ``torch.load``, unwrapped from a ``'state_dict'`` entry, cleaned
by the reference's compatibility surgery (``yolact.py:477-490``, encoded in
``yolact_tpu/convert/torch_import.py:convert_state_dict``) and returned for
a strict ``load_state_dict`` (``infer.load_model``).  The JAX package's own
``.ckpt`` files (flax msgpack) are not read: saving and resuming port
checkpoints is ROADMAP A4.
"""

from __future__ import annotations

from typing import Dict

import torch

from yolact_tpu.config import YolactConfig


def clean_state_dict(cfg: YolactConfig, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Drop what the port's eval model does not hold: the legacy
    ``backbone.layer*`` keys, FPN downsample layers beyond
    ``cfg.fpn.num_downsample`` and batch norm's ``num_batches_tracked``."""
    out = {}
    for key, value in sd.items():
        if key.startswith('backbone.layer') and \
                not key.startswith('backbone.layers'):
            continue
        if key.startswith('fpn.downsample_layers.') and cfg.fpn is not None \
                and int(key.split('.')[2]) >= cfg.fpn.num_downsample:
            continue
        if key.endswith('num_batches_tracked'):
            continue
        out[key] = value
    return out


def load_weights(cfg: YolactConfig, path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` file -> the port's float32 CPU state dict."""
    if not path.endswith('.pth'):
        raise NotImplementedError(
            f'{path}: the port loads reference .pth state dicts only; JAX '
            f'.ckpt weights (flax msgpack) are not readable here yet '
            f'(ROADMAP A4)')
    sd = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return {k: torch.as_tensor(v).float()
            for k, v in clean_state_dict(cfg, sd).items()}
