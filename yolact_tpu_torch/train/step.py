"""The training step.  Port of ``yolact_tpu/train/step.py``.

SGD with momentum and weight decay is ``torch.optim.SGD`` (the rule the JAX
package's optax chain reproduces), with the learning rate set from
``learning_rate(cfg, state.step)`` before every step, so a resumed step
count lands on the right lr.  As in JAX:

* a step whose loss or gradients are not finite leaves the parameters, the
  momentum and the batch-norm running statistics untouched and still
  advances ``step`` (``use_class_balanced_conf`` counts move on, as JAX's
  do).  Batch norm leaves its new statistics pending during the forward
  (``models/layers.py``), so nothing has to be rolled back.  The decision is
  one host read of one device flag per step;
* ``cfg.freeze_bn`` keeps batch norm on its running statistics, and its
  scale and bias get no update at all, weight decay included: they are
  frozen (``requires_grad=False``) and never reach the optimizer;
* the loss draws its sampling priorities from the caller's
  ``torch.Generator`` (``train/loss.py``).

Data parallelism (``parallel/mesh.py``; a state built with a ``mesh`` of
more than one rank): each rank passes its rows of the global batch, and
the step is the one-device step on the global batch, as JAX's sharded step
is.  Every rank draws the priorities of the global batch from the same
seeded generator and keeps its rows; batch norm takes the global moments
(``models/layers.py``) and the loss its share of the global loss
(``train/loss.py``).  After the backward one all-reduce sums each
parameter's gradient over the ranks (the sum of the shares' gradients is
the gradient of the global loss), so every rank applies the same update
to the same weights.  That all-reduce is written out instead of wrapping
the model in ``DistributedDataParallel``: DDP averages (the loss would
have to be scaled by the world size), broadcasts buffers, and fires its
bucketed all-reduces from autograd hooks while batch norm's own
all-reduces run in the same backward and in activation checkpointing's
replays, where one explicit collective after the backward keeps the order
of collectives the same on every rank.  The finite guard's flag is agreed
over the ranks, so they skip a step together, and the returned losses are
the global batch's.

The step computes in ``cfg.compute_dtype`` over float32 master weights, as
the JAX trainer's flax modules with ``dtype`` over float32 params do:
``create_train_state`` leaves the parameters float32 and sets the model's
compute dtype without casting them (``Yolact.set_compute_dtype(...,
cast_weights=False)``), every conv casts its weight at use, batch-norm
statistics and the mask scorer stay float32, the loss widens the
predictions to float32, and the gradients and the SGD update are float32.
A model whose weights were cast in place for inference raises.  The batch
is the dict of
``data/coco.py:pad_batch``, numpy arrays or tensors, with the image
``[B, S, S, 3]`` normalized RGB (or raw uint8 values as float).

The loader's transports (``data/loader.py``) are undone on the card, as in
JAX's step: bit-packed ``gt_masks_packed`` are unpacked to the image's
width (``ops/bits.py``; packed ``multires`` targets are unpacked by the
loss), and a uint8 image is cast to float.  With ``cfg.use_device_augment``
the batch holds raw BGR [0,255] images and full-resolution masks, and
``data/device_augment.py`` augments and normalizes it on the card before
the model sees it (so the s2d stem still takes the space-to-depth of the
augmented, normalized RGB image).  Its draws come from the step's
generator before the loss's priorities (:func:`train_step`); under a mesh
every rank draws the global batch's and keeps its rows, and since the
augmentation is per image, a rank's rows of the output are those rows of
the global batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from yolact_tpu_torch.config import YolactConfig
from yolact_tpu_torch.infer import (check_device, random_state_dict,
                                    use_float32_math)
from yolact_tpu_torch.models.layers import (BatchNorm2d, commit_batch_stats,
                                            drop_batch_stats, s2d_input)
from yolact_tpu_torch.models.yolact import Yolact
from yolact_tpu_torch.ops.bits import packed_width, unpack_bits_last
from yolact_tpu_torch.parallel.mesh import Mesh, shard_batch
from yolact_tpu_torch.train.loss import multibox_loss
from yolact_tpu_torch.train.schedule import learning_rate


@dataclasses.dataclass
class TrainState:
    cfg: YolactConfig
    model: Yolact
    optimizer: torch.optim.SGD
    step: int = 0
    # running selected-example class counts for use_class_balanced_conf
    conf_state: Optional[Dict[str, torch.Tensor]] = None
    # the data-parallel group; None: one device
    mesh: Optional[Mesh] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(cfg: YolactConfig, seed: int = 0,
                       device: Union[str, torch.device, None] = None,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """The model (seeded random weights in the JAX package's init scheme,
    or `state_dict`) with float32 parameters on `device` (default: the
    mesh's device, else ``cuda:0``), computing in ``cfg.compute_dtype``
    (float32 turns TF32 off, ``infer.use_float32_math``), and its
    optimizer.  With a `mesh` of more than one rank the step is data
    parallel (module docstring); every rank must start from the same
    weights."""
    if device is None:
        device = 'cuda:0' if mesh is None else mesh.device
    device = check_device(device)
    if state_dict is None:
        state_dict = random_state_dict(
            cfg, torch.Generator().manual_seed(seed))
    model = Yolact(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.set_compute_dtype(getattr(torch, cfg.compute_dtype),
                            cast_weights=False)
    model.to(device)
    use_float32_math(cfg.compute_dtype)
    if mesh is not None and mesh.size > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.mesh = mesh
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
    return TrainState(cfg, model, optimizer, 0, conf_state, mesh)


def batch_to_device(batch: Dict[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def model_input(cfg: YolactConfig, image: torch.Tensor) -> torch.Tensor:
    """The batch's ``[B, S, S, 3]`` image as the model's NCHW float32 input:
    the 2x2 space-to-depth of the raw-order image under ``cfg.stem_s2d``
    (the loader emits RGB)."""
    x = image.float().permute(0, 3, 1, 2)
    return s2d_input(x, from_rgb=True) if cfg.stem_s2d else x


def prepare_batch(cfg: YolactConfig, tensors: Dict[str, torch.Tensor],
                  augment_draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Undo the loader's mask packing on the batch's device (to the image's
    width), then, under ``cfg.use_device_augment``, augment it with
    `augment_draws` (``data/device_augment.py:draw_augment``, the batch's
    rows)."""
    if 'gt_masks_packed' in tensors:
        tensors = dict(tensors)
        packed = tensors.pop('gt_masks_packed')
        # masks are packed along their width, the image's dim 2 (NHWC)
        W = tensors['image'].shape[2]
        assert packed.shape[-1] == packed_width(W), (
            f'packed gt-mask width {packed.shape[-1]} != packed_width({W})'
            f'={packed_width(W)}; mask canvas no longer equals image width')
        tensors['gt_masks'] = unpack_bits_last(packed, W)
    if cfg.use_device_augment:
        if augment_draws is None:
            raise ValueError('use_device_augment needs the augment draws '
                             '(data/device_augment.py:draw_augment)')
        from yolact_tpu_torch.data.device_augment import device_augment
        tensors = device_augment(cfg, tensors, augment_draws)
    return tensors


def draw_priorities(cfg: YolactConfig, batch_size: int, num_priors: int,
                    generator: torch.Generator, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss's random draws: (mask_priorities [B, P], maskiou_priorities
    [B * masks_to_train]), uniform in [0, 1), from `generator` (on its own
    device), moved to `device`."""
    def draw(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device)
    return (draw(batch_size, num_priors),
            draw(batch_size * cfg.masks_to_train))


def loss_and_grads(state: TrainState, batch: Dict[str, Any],
                   mask_priorities: torch.Tensor,
                   maskiou_priorities: torch.Tensor,
                   use_kernels: bool = True,
                   augment_draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Forward (train mode), loss and backward: fills every trained
    parameter's ``.grad`` and returns the losses by letter plus ``total``.
    Batch-norm statistics stay pending; nothing is updated.  Under a mesh
    `batch`, `mask_priorities` and `augment_draws` (device augmentation
    only) are the rank's rows and `maskiou_priorities` the global draws;
    the gradients and the returned losses are the global batch's, on every
    rank."""
    cfg, model = state.cfg, state.model
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError(
            'train_step needs float32 master weights: this model\'s were cast '
            'in place (set_compute_dtype for inference); build it with '
            'create_train_state, which computes in cfg.compute_dtype')
    num_gts = batch.get('num_gts')
    if isinstance(num_gts, torch.Tensor):
        # a count on the card would cost a sync: the matcher loops all rows
        num_gts = num_gts.numpy() if num_gts.device.type == 'cpu' else None
    tensors = prepare_batch(cfg, batch_to_device(batch, state.device),
                            augment_draws)
    state.optimizer.zero_grad(set_to_none=True)
    preds = model(model_input(cfg, tensors['image']),
                  use_kernels=use_kernels, train=True)
    losses, _ = multibox_loss(
        cfg, preds, tensors, mask_priorities, maskiou_priorities,
        maskiou_net=model.maskiou_net, conf_state=state.conf_state,
        num_gts=None if num_gts is None else np.asarray(num_gts),
        mesh=state.mesh)
    new_conf_state = losses.pop('_conf_state', state.conf_state)
    total = sum(losses.values())
    total.backward()
    state.conf_state = new_conf_state
    out = dict({k: v.detach() for k, v in losses.items()},
               total=total.detach())
    mesh = state.mesh
    if mesh is not None and mesh.size > 1:
        mesh.all_sum_grads([p for group in state.optimizer.param_groups
                            for p in group['params']])
        summed = mesh.all_sum(torch.stack(list(out.values())))
        out = dict(zip(out, summed.unbind()))
    return out


def grads_finite(state: TrainState) -> torch.Tensor:
    """A device flag: every gradient is finite (the largest absolute entry
    of all, so a large finite gradient cannot overflow the test)."""
    grads = [p.grad for group in state.optimizer.param_groups
             for p in group['params'] if p.grad is not None]
    return torch.nn.utils.get_total_norm(grads, float('inf')).isfinite()


def apply_gradients(state: TrainState, losses: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """The second half of a step, after :func:`loss_and_grads`: the finite
    guard, the SGD update at the schedule's learning rate, the batch-norm
    statistics, the step count.  Returns `losses` with ``lr`` (a float) and
    ``finite`` (whether the update was applied)."""
    # the loss can still be finite on the step where the backward pass
    # overflows, so the guard covers the gradients too
    finite = bool(losses['total'].isfinite() & grads_finite(state))
    if state.mesh is not None:        # every rank skips, or none does
        finite = state.mesh.all_true(finite)
    lr = learning_rate(state.cfg, state.step)   # resume-safe: from the count
    if finite:
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.step()
        commit_batch_stats(state.model)
    else:
        drop_batch_stats(state.model)
    # the iteration still advances on a skipped step, like the reference
    state.step += 1
    return dict(losses, lr=lr, finite=finite)


def train_step(state: TrainState, batch: Dict[str, Any],
               generator: torch.Generator,
               use_kernels: bool = True) -> Dict[str, Any]:
    """One SGD step in place on `state`.  Returns the losses by letter
    (detached device scalars) with ``total``, ``lr`` (a float) and
    ``finite`` (whether the update was applied).  Under a mesh `batch` is
    the rank's rows of the global batch, and `generator` is seeded alike
    on every rank: the draws are the global batch's."""
    image = batch['image']
    priors = state.model.priors(image.shape[1], image.shape[2], state.device)
    mesh = state.mesh
    world = 1 if mesh is None else mesh.size
    n = image.shape[0] * world
    # the draws' order: the augmentation's first (as JAX's step splits its
    # key before the loss's), then the loss's priorities
    augment_draws = None
    if state.cfg.use_device_augment:
        from yolact_tpu_torch.data.device_augment import draw_augment
        augment_draws = draw_augment(state.cfg, n, generator, state.device)
    mask_priorities, maskiou_priorities = draw_priorities(
        state.cfg, n, priors.shape[0], generator, state.device)
    if world > 1:
        mask_priorities = mask_priorities[mesh.rows(n)]
        if augment_draws is not None:
            augment_draws = shard_batch(augment_draws, mesh.rank, mesh.size)
    return apply_gradients(
        state, loss_and_grads(state, batch, mask_priorities,
                              maskiou_priorities, use_kernels=use_kernels,
                              augment_draws=augment_draws))
