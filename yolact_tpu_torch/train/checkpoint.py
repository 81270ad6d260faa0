"""Checkpoints of the port: save and resume a train state, and load weights.

Port of ``yolact_tpu/train/checkpoint.py``.  Reference semantics
(``yolact.py:473-490``, ``train.py:200-213,356-383``):
``weights/<config>_<epoch>_<iter>.pth`` naming, ``--resume
[path|interrupt|latest]``, Ctrl-C interrupt checkpoints, ``--keep_latest``
retention.  As in the JAX package the optimizer state (the SGD momentum) is
saved too, which the reference drops on resume.

A port checkpoint is one ``torch.save`` of ``{'step', 'state_dict': the
model's state dict, 'optimizer': optimizer.state_dict(), 'param_names':
the names of the optimizer's parameters in its order, 'conf_state'}``,
written to ``<path>.tmp`` and renamed over `path`, so a crash mid-write
leaves the previous file whole.  The weights sit under ``'state_dict'``,
the key the reference's loader and the JAX package's ``load_pth`` unwrap,
so either reads the file as weights; checkpoints written before that
(the weights under ``'model'``) still resume.  The momentum is restored by parameter name, so a run
may resume with another ``freeze_bn`` (which changes the optimizer's
parameter list) and the current config's momentum and weight decay.

Three kinds of file load (:func:`read_checkpoint`):

* a port checkpoint (``.pth``);
* a reference ``.pth``: a torch ``state_dict``, or one wrapped in
  ``'state_dict'``, cleaned by the reference's compatibility surgery
  (``yolact.py:477-490``, encoded in
  ``yolact_tpu/convert/torch_import.py:convert_state_dict``).  It holds
  weights only: ``cli/train.py`` resumes from it with a fresh optimizer, as
  the JAX trainer does;
* a JAX ``.ckpt`` (flax msgpack, read by ``convert/msgpack.py`` and
  converted by ``convert/from_jax.py:jax_checkpoint_to_port``): a train
  state resumes with its step, momentum and ``conf_state``, so a run
  started on the TPU carries on in the port; a weights-only blob gives
  weights.

:func:`load_weights` gives the weights of any of them, so
``cli/eval --trained_model=<trained>.pth`` works on what ``cli/train``
writes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from yolact_tpu_torch.config import YolactConfig
from yolact_tpu_torch.utils.functions import SavePath


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


def read_checkpoint(cfg: YolactConfig, path: str) -> Dict[str, Any]:
    """Any checkpoint or weights file -> ``{'model': float32 CPU state
    dict}``, plus for a train state ``'step'``, the momentum
    (``'optimizer'`` and ``'param_names'`` from the port, ``'momentum'`` by
    name from JAX) and ``'conf_state'`` where saved."""
    if path.endswith('.ckpt'):
        from yolact_tpu_torch.convert import msgpack
        from yolact_tpu_torch.convert.from_jax import jax_checkpoint_to_port
        return jax_checkpoint_to_port(cfg, msgpack.read(path))
    if not path.endswith('.pth'):
        raise ValueError(f'{path}: expected a .pth or a JAX .ckpt file')
    blob = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(blob, dict) and 'step' in blob and (
            'state_dict' in blob or 'model' in blob):
        ckpt = dict(blob)                   # a port train state
        if 'state_dict' in ckpt:
            ckpt['model'] = ckpt.pop('state_dict')
    elif isinstance(blob, dict) and 'state_dict' in blob:
        ckpt = {'model': blob['state_dict']}
    else:
        ckpt = {'model': blob}
    ckpt['model'] = {k: torch.as_tensor(v).float()
                     for k, v in clean_state_dict(cfg, ckpt['model']).items()}
    return ckpt


def load_weights(cfg: YolactConfig, path: str) -> Dict[str, torch.Tensor]:
    """The weights of a port checkpoint, a reference ``.pth`` or a JAX
    ``.ckpt`` -> the port's float32 CPU state dict."""
    return read_checkpoint(cfg, path)['model']


def _momentum_by_name(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    if 'momentum' in ckpt:
        return ckpt['momentum']
    saved = ckpt['optimizer']['state']
    return {name: saved[i]['momentum_buffer']
            for i, name in enumerate(ckpt['param_names'])
            if i in saved and 'momentum_buffer' in saved[i]}


def save_checkpoint(state, path: str) -> None:
    """The train state (``train/step.py:TrainState``) to `path`."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    names = {p: n for n, p in state.model.named_parameters()}
    blob = {'step': int(state.step),
            'state_dict': state.model.state_dict(),
            'optimizer': state.optimizer.state_dict(),
            'param_names': [names[p] for group in state.optimizer.param_groups
                            for p in group['params']],
            'conf_state': state.conf_state}
    tmp = path + '.tmp'
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state):
    """Restore `state` in place from a port or JAX train-state checkpoint
    file (:func:`restore_checkpoint`).  Returns `state`."""
    return restore_checkpoint(state, read_checkpoint(state.cfg, path))


def restore_checkpoint(state, ckpt: Dict[str, Any]):
    """Restore `state` in place from a train state that
    :func:`read_checkpoint` read: weights and batch-norm statistics, the
    momentum of every parameter the optimizer trains, the step and
    ``conf_state`` (a checkpoint saved without ``conf_state`` keeps the
    fresh counts).  Returns `state`.  Weights alone raise: load them with
    ``model.load_state_dict`` and keep the fresh optimizer, as
    ``cli/train.py`` does."""
    if 'step' not in ckpt:
        raise ValueError(
            'the file holds weights only; load them with load_weights(cfg, '
            'path) and a fresh optimizer, as cli/train.py does')
    model, optimizer = state.model, state.optimizer
    model.load_state_dict(ckpt['model'], strict=True)
    momentum = _momentum_by_name(ckpt)
    optimizer.state.clear()
    trained = {p for group in optimizer.param_groups for p in group['params']}
    for name, p in model.named_parameters():
        if p in trained and name in momentum:
            optimizer.state[p]['momentum_buffer'] = momentum[name].to(
                device=p.device, dtype=p.dtype, copy=True)
    state.step = int(ckpt['step'])
    conf = ckpt.get('conf_state')
    if conf is not None and state.conf_state is not None:
        state.conf_state = {k: torch.as_tensor(v).to(state.device).float()
                            for k, v in conf.items()}
    return state


def resolve_resume(resume: str, save_folder: str, config_name: str
                   ) -> Optional[str]:
    """'interrupt' | 'latest' | path (train.py:200-213)."""
    if resume == 'interrupt':
        return SavePath.get_interrupt(save_folder)
    if resume == 'latest':
        return SavePath.get_latest(save_folder, config_name)
    return resume


def iteration_from_path(path: str) -> int:
    return SavePath.from_str(path).iteration


def prune_previous_checkpoint(latest: Optional[str], iteration: int,
                              save_interval: int,
                              keep_latest_interval: int = 0) -> None:
    """--keep_latest retention (train.py:356-366): after the new save,
    delete ONLY the previously-latest checkpoint — never pre-existing
    files from other runs — unless it sits on a keep interval (the
    reference keeps it when ``iteration % keep_latest_interval ==
    save_interval``, i.e. the previous save fell on an interval
    multiple).  ``latest`` must be recorded BEFORE saving the new one."""
    if latest is None or not os.path.exists(latest):
        return
    if os.path.splitext(latest)[0].endswith('_interrupt'):
        # --resume=interrupt state is never auto-pruned (the reference's
        # retention only ever sees periodic saves)
        return
    if keep_latest_interval <= 0 or \
            iteration % keep_latest_interval != save_interval:
        os.unlink(latest)
