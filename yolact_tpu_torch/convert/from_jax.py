"""JAX variables -> the port's state dict.

The inverse of ``yolact_tpu/convert/torch_import.py:convert_state_dict``
for the modules the port has: flax paths become the reference's torch
``state_dict`` keys, conv kernels go HWIO -> OIHW, and batch norm ``scale`` / ``bias`` /
``mean`` / ``var`` become ``weight`` / ``bias`` / ``running_mean`` /
``running_var``.  Inputs are nested dicts of numpy arrays, so this module
needs no JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from yolact_tpu.config import YolactConfig

_LEAF = {'kernel': 'weight', 'weight': 'weight', 'bias': 'bias',
         'scale': 'weight', 'mean': 'running_mean', 'var': 'running_var'}
# flax wrapper modules that the torch layers do not have
_WRAPPERS = {'conv', 'bn'}


def _walk(tree, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_name(part: str) -> str:
    """One flax module name -> its dotted torch path."""
    if part == 'downsample_conv':
        return 'downsample.0'
    if part == 'downsample_bn':
        return 'downsample.1'
    m = re.fullmatch(r'layers_(\d+)_(\d+)', part)    # backbone stage/block
    if m:
        return f'layers.{m.group(1)}.{m.group(2)}'
    m = re.fullmatch(r'layers_(\d+)', part)          # make_net index
    if m:
        return m.group(1)
    if '_cat_' in part:
        raise NotImplementedError(f'make_net parallel branch {part!r}')
    m = re.fullmatch(r'(\w+?)_(\d+)', part)          # lat_layers_0, ...
    if m:
        return f'{m.group(1)}.{m.group(2)}'
    return part


def _torch_key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    if mods and mods[0] == 'proto':       # ProtoNet is the torch proto_net
        mods = mods[1:]
    names = [_module_name(p) for p in mods if p not in _WRAPPERS]
    return '.'.join(names + [_LEAF[leaf]])


def _to_torch(path: Tuple[str, ...], value) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if path[-1] in ('kernel', 'weight') and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    elif path[-1] == 'kernel' and a.ndim == 2:
        a = a.T                           # Dense IO -> OI
    return torch.tensor(a)               # a contiguous, writable copy


def jax_variables_to_state_dict(cfg: YolactConfig, variables: Dict
                                ) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of ``yolact_tpu`` Yolact(cfg)
    -> the port's ``state_dict`` (float32 CPU tensors)."""
    del cfg  # names and shapes follow from the tree itself
    sd = {}
    for coll in ('params', 'batch_stats'):
        for path, value in _walk(variables.get(coll, {})):
            sd[_torch_key(path)] = _to_torch(path, value)
    return sd
