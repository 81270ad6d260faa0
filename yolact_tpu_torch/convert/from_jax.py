"""JAX variables -> the port's state dict, and a JAX config -> the port's.

:func:`jax_variables_to_state_dict` is the inverse of
``yolact_tpu/convert/torch_import.py:convert_state_dict`` for the modules
the port has: flax paths become the reference's torch
``state_dict`` keys, conv kernels (and a DCN layer's 4-D ``weight``) go
HWIO -> OIHW, and batch norm ``scale`` / ``bias`` / ``mean`` / ``var``
become ``weight`` / ``bias`` / ``running_mean`` / ``running_var`` (group
norm's ``scale`` / ``bias`` under its flax wrapper ``gn`` likewise).  The
flax wrappers ``conv`` / ``bn`` / ``gn`` that the torch layers lack are
dropped, except in DarkNet, whose torch layers are ``Sequential``s (conv,
batch norm): there a ``DarkConv``'s ``conv`` and ``bn`` (each wrapping a
flax module of the same name) are its indices ``0`` and ``1``, and
``preconv`` is ``_preconv``.  The
YOLACT++ mask scorer, a separate ``MaskIoUHead`` tree in JAX
(``{'params': {'maskiou': {'maskiou_net': ...}}}``), is read from the
``'maskiou'`` entry, where ``convert_state_dict`` puts it, and becomes
``maskiou_net.maskiou_net.{i}``.  A make_net ``'cat'`` branch
``layers_{i}_cat_{j}`` is the reference's ``Concat`` child ``{i}.nets.{j}``;
a transposed conv's flax kernel (HWOI with ``transpose_kernel``) goes to
torch's IOHW by the same axis permutation as a conv's; the prediction
head's DSSD module keeps ``block`` and takes the reference's ``conv`` and
``bn`` for flax's ``pm_conv`` and ``pm_bn`` (JAX's own importer maps no
names for it); ``gate_layer``, ``score_layer`` and ``inst_layer`` keep
their names.  The training-only heads convert like the
rest: flax ``semantic_seg_conv`` (a conv) and ``class_existence_fc`` (a
Dense, kernel transposed) become the reference's keys of the same names.
:func:`psroi_variables_to_state_dict` carries the deformable PSRoI pooling
module's three Dense layers the same way.
Inputs are nested dicts of numpy arrays, so this module needs no JAX.

For the train step, :func:`train_state_to_state_dict` takes the ``params``
and ``batch_stats`` of a JAX ``TrainState`` (``{'model': ..., 'maskiou':
...}``, as numpy) to the port's state dict, and
:func:`state_dict_to_train_state` takes a state dict (or per-parameter
gradients or momentum buffers under the same keys) back into trees of the
same structure, so both packages can start a step from the same weights
and their updated weights can be compared leaf by leaf.

:func:`jax_checkpoint_to_port` takes a JAX ``.ckpt`` blob, as
``convert/msgpack.py`` reads it, to the port's checkpoint dict
(``train/checkpoint.py``): a ``save_checkpoint`` train state gives the
step, the weights (``params.model``, ``params.maskiou``, ``batch_stats``),
the SGD momentum by parameter name and ``conf_state``; a
``save_weights_only`` blob the weights alone.  The JAX optimizer is
``optax.chain(add_decayed_weights, trace, scale(-1))`` with the learning
rate applied outside it (``yolact_tpu/train/step.py:38-51``), so element
1's ``trace`` is ``torch.optim.SGD``'s ``momentum_buffer`` as it stands.

:func:`config_from_jax` rebuilds the port's config dataclasses field by
field from a ``yolact_tpu.config`` object (the port keeps its own copy of
that module, so the two packages' classes differ); it reads the object's
dataclass fields and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from yolact_tpu_torch import config as port_config
from yolact_tpu_torch.config import YolactConfig
from yolact_tpu_torch.models.yolact import init_train_heads

_LEAF = {'kernel': 'weight', 'weight': 'weight', 'bias': 'bias',
         'scale': 'weight', 'mean': 'running_mean', 'var': 'running_var'}
# flax wrapper modules that the torch layers do not have
_WRAPPERS = {'conv', 'bn', 'gn'}
# a DarkConv's children, which the torch Sequential indexes
_SEQUENTIAL = {'conv': '0', 'bn': '1'}
# the DSSD prediction module's 1x1 branch: flax pm_conv / pm_bn, the
# reference's PredictionModule.conv / .bn (yolact.py:97-100 of the
# reference; its bottleneck is `block` in both)
_PREDICTION_MODULE = {'pm_conv': 'conv', 'pm_bn': 'bn'}


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
    if part == 'preconv':                            # DarkNet's first conv
        return '_preconv'
    if part in _PREDICTION_MODULE:
        return _PREDICTION_MODULE[part]
    m = re.fullmatch(r'layers_(\d+)_cat_(\d+)', part)  # make_net 'cat'
    if m:
        return f'{m.group(1)}.nets.{m.group(2)}'
    m = re.fullmatch(r'layers_(\d+)_(\d+)', part)    # backbone stage/block
    if m:
        return f'layers.{m.group(1)}.{m.group(2)}'
    m = re.fullmatch(r'layers_(\d+)', part)          # make_net index
    if m:
        return m.group(1)
    m = re.fullmatch(r'(\w+?)_(\d+)', part)          # lat_layers_0, ...
    if m:
        return f'{m.group(1)}.{m.group(2)}'
    return part


def _torch_key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    if mods and mods[0] == 'proto':       # ProtoNet is the torch proto_net
        mods = mods[1:]
    elif mods and mods[0] == 'maskiou':   # MaskIoUHead's FastMaskIoUNet
        mods = ['maskiou_net'] + mods[1:]
    names = []
    for i, part in enumerate(mods):
        if part in _WRAPPERS:
            # a wrapper around a wrapper of the same name: a DarkConv child
            if i + 1 < len(mods) and mods[i + 1] == part:
                names.append(_SEQUENTIAL[part])
            continue
        names.append(_module_name(part))
    return '.'.join(names + [_LEAF[leaf]])


def _to_torch(path: Tuple[str, ...], value) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if path[-1] in ('kernel', 'weight') and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)       # HWIO -> OIHW (HWOI -> IOHW)
    elif path[-1] == 'kernel' and a.ndim == 2:
        a = a.T                           # Dense IO -> OI
    return torch.tensor(a)               # a contiguous, writable copy


def _state_dict(trees) -> Dict[str, torch.Tensor]:
    return {_torch_key(path): _to_torch(path, value)
            for tree in trees for path, value in _walk(tree)}


def jax_variables_to_state_dict(cfg: YolactConfig, variables: Dict
                                ) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of ``yolact_tpu`` Yolact(cfg),
    plus for YOLACT++ ``'maskiou'``: the ``MaskIoUHead(cfg)`` variables
    -> the port's ``state_dict`` (float32 CPU tensors).  flax creates the
    training-only heads only when the model is initialised with
    ``train=True``; where ``params`` come without them they get
    ``init_train_heads``'s seeded initial values, so the result loads
    strictly."""
    trees = [variables.get('params', {}), variables.get('batch_stats', {}),
             variables.get('maskiou', {}).get('params', {})]
    sd = _state_dict(trees)
    if 'params' in variables:
        heads = init_train_heads(cfg, torch.Generator().manual_seed(0))
        sd.update({k: t for k, t in heads.items() if k not in sd})
    return sd


def psroi_variables_to_state_dict(variables: Dict
                                  ) -> Dict[str, torch.Tensor]:
    """``yolact_tpu/kernels/psroi.py:DeformRoIPooling``'s flax variables ->
    the state dict of the port's ``kernels/psroi.py:DeformRoIPooling``:
    each Dense ``offset_mask_fc_{i}`` (kernel [in, out]) becomes the
    reference's ``offset_mask_fc.{i}`` Linear (weight [out, in])."""
    return _state_dict([variables.get('params', {})])


def _from_torch(path: Tuple[str, ...], value) -> np.ndarray:
    """The inverse of :func:`_to_torch`."""
    a = np.asarray(value, dtype=np.float32)
    if path[-1] in ('kernel', 'weight') and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)       # OIHW -> HWIO (IOHW -> HWOI)
    elif path[-1] == 'kernel' and a.ndim == 2:
        a = a.T
    return np.ascontiguousarray(a)


def _train_variables(params: Dict, batch_stats: Dict) -> Dict:
    variables = {'params': params['model'], 'batch_stats': batch_stats}
    if 'maskiou' in params:
        variables['maskiou'] = {'params': params['maskiou']}
    return variables


def train_state_to_state_dict(cfg: YolactConfig, params: Dict,
                              batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """A JAX ``TrainState``'s ``params`` (``{'model': ..., 'maskiou': ...}``)
    and ``batch_stats`` as numpy trees -> the port's state dict."""
    return jax_variables_to_state_dict(
        cfg, _train_variables(params, batch_stats))


def state_dict_to_train_state(sd: Dict[str, Any], params: Dict,
                              batch_stats: Dict) -> Tuple[Dict, Dict]:
    """Tensors (or arrays) under the port's state-dict keys -> (params,
    batch_stats) trees shaped like the given ones, in JAX's layouts.  Keys
    missing from `sd` (batch-norm buffers when `sd` holds gradients, say)
    come back as None leaves."""
    def fill(tree, prefix, key_prefix):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value, prefix + (key,), key_prefix)
            else:
                path = prefix + (key,)
                t = sd.get(_torch_key(key_prefix + path))
                if t is not None and isinstance(t, torch.Tensor):
                    t = t.detach().cpu().numpy()
                out[key] = None if t is None else _from_torch(path, t)
        return out

    new_params = {'model': fill(params['model'], (), ())}
    if 'maskiou' in params:
        new_params['maskiou'] = fill(params['maskiou'], (), ())
    return new_params, fill(batch_stats, (), ())


def jax_checkpoint_to_port(cfg: YolactConfig, blob: Dict) -> Dict[str, Any]:
    """A JAX checkpoint tree -> ``{'model': state dict}`` for weights, plus
    ``'step'``, ``'momentum'`` ({parameter name: buffer}) and, where saved,
    ``'conf_state'`` for a train state (see the module docstring)."""
    if 'opt_state' not in blob and 'step' not in blob:
        return {'model': jax_variables_to_state_dict(cfg, blob)}
    params = blob['params']
    out = {'step': int(np.asarray(blob['step'])),
           'model': train_state_to_state_dict(cfg, params,
                                              blob.get('batch_stats', {}))}
    trace = blob['opt_state']['1']['trace']
    out['momentum'] = _state_dict([trace['model'], trace.get('maskiou', {})])
    if blob.get('conf_state') is not None:
        out['conf_state'] = {k: torch.tensor(np.asarray(v, np.float32))
                             for k, v in blob['conf_state'].items()}
    return out


def _rebuild(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = getattr(port_config, type(value).__name__)
        return cls(**{f.name: _rebuild(getattr(value, f.name))
                      for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(_rebuild(v) for v in value)
    return value


def config_from_jax(cfg: Any) -> YolactConfig:
    """The port's :class:`YolactConfig` equal to a JAX ``YolactConfig``:
    every nested config dataclass becomes the port's class of the same
    name, field by field; other values (numbers, strings, tuples, the
    ``MaskType`` integers) are kept."""
    out = _rebuild(cfg)
    if not isinstance(out, YolactConfig):
        raise TypeError(f'config_from_jax: not a YolactConfig: '
                        f'{type(cfg).__name__}')
    return out
