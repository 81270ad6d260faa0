"""A plain single-device training step, the reference for the train cells.

It follows the port's ``train/step.py:train_step`` on one device, written
out without its mesh branches: the draws from the step's generator in
the port's order (the device augmentation's, then the loss's
priorities), the batch's masks and image as the loader ships them, the
device augmentation, the forward in train mode (batch statistics), every
loss letter, the backward, the finite guard, ``torch.optim.SGD`` with
momentum and weight decay at the schedule's learning rate and the batch
norms' new statistics.  The model, loss, matcher, augmentation and
schedule are the frozen copies beside this file; the precision is the
model's (float32 with TF32 off, the reference; bfloat16 for the
control).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.data.device_augment import (device_augment,
                                                     draw_augment)
from benchmark.reference.models.layers import (BatchNorm2d,
                                               commit_batch_stats,
                                               drop_batch_stats)
from benchmark.reference.models.yolact import Yolact
from benchmark.reference.train.loss import multibox_loss
from benchmark.reference.train.schedule import learning_rate


@dataclasses.dataclass
class State:
    cfg: object
    model: Yolact
    optimizer: torch.optim.SGD
    step: int = 0
    conf_state: Optional[Dict[str, torch.Tensor]] = None


def create_state(cfg, state_dict, device, compute_dtype: str) -> State:
    with torch.device(device):
        model = Yolact(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.set_compute_dtype(getattr(torch, compute_dtype),
                            cast_weights=False)
    if cfg.freeze_bn:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.requires_grad_(False)
                m.bias.requires_grad_(False)
    optimizer = torch.optim.SGD(
        [p for p in model.parameters() if p.requires_grad],
        lr=learning_rate(cfg, 0), momentum=cfg.momentum,
        weight_decay=cfg.decay)
    conf_state = None
    if cfg.use_class_balanced_conf:
        conf_state = {'class_counts': torch.zeros(cfg.num_classes,
                                                  device=device),
                      'total': torch.zeros((), device=device)}
    return State(cfg, model, optimizer, 0, conf_state)


def draw_priorities(cfg, batch_size: int, num_priors: int,
                    generator: torch.Generator, device):
    def draw(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device)
    return (draw(batch_size, num_priors),
            draw(batch_size * cfg.masks_to_train))


def train_step(state: State, batch: Dict[str, np.ndarray],
               generator: torch.Generator, keep_grads: bool = False):
    """One step in place on `state` from a host batch of
    ``data/batch.py:raw_batch``.  Returns (the losses by letter and
    ``total`` as floats, ``finite``, and with `keep_grads` the gradients
    as the optimizer gets them, by parameter name)."""
    cfg, model = state.cfg, state.model
    device = next(model.parameters()).device
    image = batch['image']
    n = image.shape[0]
    priors = model.priors(image.shape[1], image.shape[2], device)
    draws = draw_augment(cfg, n, generator, device)
    mask_priorities, maskiou_priorities = draw_priorities(
        cfg, n, priors.shape[0], generator, device)
    tensors = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    tensors = device_augment(cfg, tensors, draws)
    state.optimizer.zero_grad(set_to_none=True)
    x = tensors['image'].float().permute(0, 3, 1, 2)
    preds = model(x, use_kernels=False, train=True)
    losses, _ = multibox_loss(
        cfg, preds, tensors, mask_priorities, maskiou_priorities,
        maskiou_net=model.maskiou_net, conf_state=state.conf_state,
        num_gts=np.asarray(batch['num_gts']))
    state.conf_state = losses.pop('_conf_state', state.conf_state)
    total = sum(losses.values())
    total.backward()
    params = [p for g in state.optimizer.param_groups for p in g['params']]
    grads = [p.grad for p in params if p.grad is not None]
    finite = bool(total.isfinite() & torch.nn.utils.get_total_norm(
        grads, float('inf')).isfinite())
    kept = None
    if keep_grads:
        kept = {name: p.grad.detach().clone()
                for name, p in model.named_parameters()
                if p.grad is not None}
    lr = learning_rate(cfg, state.step)
    if finite:
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.step()
        commit_batch_stats(model)
    else:
        drop_batch_stats(model)
    state.step += 1
    out = {k: float(v.detach()) for k, v in losses.items()}
    out['total'] = float(total.detach())
    return out, finite, kept
