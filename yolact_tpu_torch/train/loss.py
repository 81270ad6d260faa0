"""YOLACT multi-task loss.  Port of ``yolact_tpu/train/loss.py``.

Loss letters match the reference: B box, C conf, M mask, S semantic seg,
E class existence, D coeff diversity, I maskiou, P proto reg.
Normalisation: all but P/E/S divide by the total positive count; P/E/S
divide by batch size (``multibox_loss.py:196-203``).

Where JAX maps a per-image function over the batch, the batch dimension is
written out here.  JAX's hand-written pieces that are PyTorch's own are
PyTorch's: ``_resize_masks`` is ``F.interpolate`` (bilinear,
``align_corners=False``), ``_bce_with_logits`` is
``F.binary_cross_entropy_with_logits``.  :class:`_TorchBCE` stays written
out, with the arithmetic of ``F.binary_cross_entropy`` (the -100 log clamp,
the eps-clamped backward): the library call asserts that its input lies in
[0, 1], which a NaN prediction fails, on the card as a device-side assert
that ends the process, where the train step's finite guard has to see a NaN
loss and skip the step.

Randomness.  JAX draws the sampling priorities inside the loss from its
key; here they are arguments, so the caller owns the generator and a test
can feed both packages the same draws: ``mask_priorities [B, P]`` (uniform
[0, 1): which positives get a mask slot when an image has more than
``masks_to_train``) and ``maskiou_priorities [B * masks_to_train]`` (the
``maskious_to_train`` cap).  Slots are the top ``masks_to_train`` priorities
with ties to the lowest index, as ``jax.lax.top_k`` breaks them (all-zero
priorities when an image has fewer positives than slots): a stable
descending sort.

``direct_mask_loss`` takes ``mask_priorities`` the same way (JAX draws its
own per image from the key it is given, with no split for the mask-IoU
cap).

Data parallelism.  With a ``mesh`` (``parallel/mesh.py``) of more than one
rank, each rank passes its rows of the batch and of ``mask_priorities`` and
the GLOBAL ``maskiou_priorities`` [B * masks_to_train], and gets its share
of the loss of the global batch: the ranks' shares sum to the one-device
loss of the global batch, as JAX's sharded step computes it.  Whatever
reduces over the batch reduces over the ranks: the positive count that
divides B, C, M, D and I, the batch size that divides P, E and S (and P's
mean over the prototypes), OHEM's stabilising max, the class-balanced
counts (so every rank holds the same ``conf_state``) and the mask-IoU cap
(each rank sees every rank's valid slots and takes the same k-th
priority).  The matcher, the per-image mask-loss scale and the slots are
per image and need nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from yolact_tpu_torch.config import MaskType, YolactConfig
from yolact_tpu_torch.ops.bits import packed_width, unpack_bits_last
from yolact_tpu_torch.ops.boxes import (center_size, decode,
                                        elemwise_box_iou, log_sum_exp,
                                        sanitize_coordinates)
from yolact_tpu_torch.train.matcher import MatchResult, match
from yolact_tpu_torch.utils import timer


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


class _TorchBCE(torch.autograd.Function):
    """Elementwise binary cross entropy of probabilities `p` against
    targets `t` (no gradient for `t`), NaN in, NaN out."""

    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        logp = torch.log(p).clamp(min=-100.0)
        log1mp = torch.log(1.0 - p).clamp(min=-100.0)
        return -(t * logp + (1.0 - t) * log1mp)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        return g * (p - t) / (p * (1.0 - p)).clamp(min=1e-12), None


def _resize_masks(masks: torch.Tensor, size) -> torch.Tensor:
    """[B, G, S, S] float -> [B, G, h, w], bilinear without antialiasing."""
    if tuple(masks.shape[-2:]) == tuple(size):
        return masks
    return F.interpolate(masks, size=tuple(size), mode='bilinear',
                         align_corners=False)


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values [B, N, ...], index [B, M] -> values[b, index[b, m]] as
    [B, M, ...]."""
    rows = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[rows, index]


def _crop(masks: torch.Tensor, boxes: torch.Tensor,
          padding: int = 1) -> torch.Tensor:
    """``ops/boxes.py:crop`` for masks [B, M, h, w] and boxes [B, M, 4]."""
    h, w = masks.shape[-2:]
    x1, x2 = sanitize_coordinates(boxes[..., 0], boxes[..., 2], w, padding,
                                  cast=False)
    y1, y2 = sanitize_coordinates(boxes[..., 1], boxes[..., 3], h, padding,
                                  cast=False)
    xs = torch.arange(w, dtype=masks.dtype, device=masks.device)
    ys = torch.arange(h, dtype=masks.dtype, device=masks.device)[:, None]
    x1, x2, y1, y2 = (t[:, :, None, None] for t in (x1, x2, y1, y2))
    keep = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return masks * keep.to(masks.dtype)


def _mask_slots(pos: torch.Tensor, mask_priorities: torch.Tensor,
                n_slots: int) -> torch.Tensor:
    """The ``n_slots`` mask slots of each image [B, M]: positives first,
    by random priority, ties to the lowest index (``jax.lax.top_k``); the
    top M reproduce "randperm subset" when an image has more positives."""
    pri = torch.where(pos, mask_priorities + 1.0, 0.0)  # positives in (1, 2)
    return torch.sort(pri, dim=1, descending=True,
                      stable=True).indices[:, :n_slots]


def ohem_conf_loss(cfg: YolactConfig, conf_data, conf_t, pos,
                   conf_state=None, mesh=None):
    """OHEM with 3:1 hard negative mining (multibox_loss.py:242-296).

    With ``use_class_balanced_conf``, `conf_state` is a dict
    {'class_counts': [C], 'total': []} of running selected-example counts;
    the updated state is returned alongside the loss."""
    b, p, c = conf_data.shape
    batch_conf = conf_data.reshape(-1, c)
    if cfg.ohem_use_most_confident:
        loss_c = F.softmax(batch_conf, dim=-1)[:, 1:].amax(dim=-1)
    else:
        x_max = batch_conf.detach().max()
        if mesh is not None:
            x_max = mesh.all_max(x_max)
        loss_c = log_sum_exp(batch_conf, x_max) - batch_conf[:, 0]
    loss_c = loss_c.reshape(b, p)
    loss_c = torch.where(pos | (conf_t < 0), 0.0, loss_c)

    # rank of each prior when sorted by descending mining score
    order = torch.argsort(-loss_c, dim=1, stable=True)
    idx_rank = torch.argsort(order, dim=1, stable=True)
    num_pos = pos.sum(dim=1, keepdim=True)
    num_neg = (cfg.ohem_negpos_ratio * num_pos).clamp(max=p - 1)
    neg = (idx_rank < num_neg) & ~pos & (conf_t >= 0)

    selected = pos | neg
    tgt = conf_t.clamp(0, c - 1)
    ce = -torch.gather(F.log_softmax(conf_data, dim=-1), 2,
                       tgt[:, :, None])[:, :, 0]

    if cfg.use_class_balanced_conf and conf_state is not None:
        sel_f = selected.reshape(-1).float()
        counts = torch.bincount(tgt.reshape(-1), weights=sel_f, minlength=c)
        total = sel_f.sum()
        if mesh is not None:
            both = mesh.all_sum(torch.cat([counts, total[None]]))
            counts, total = both[:c], both[c]
        new_counts = conf_state['class_counts'] + counts
        new_total = conf_state['total'] + total
        weighting = 1.0 - new_counts[tgt] / new_total.clamp(min=1.0)
        weighting = weighting.clamp(min=1.0 / c)
        avg_weight = (c - 1) / c
        loss = (ce * selected * weighting).sum() / avg_weight
        return cfg.conf_alpha * loss, \
            {'class_counts': new_counts.detach(), 'total': new_total.detach()}
    return cfg.conf_alpha * (ce * selected).sum(), conf_state


def _focal_weight(cfg: YolactConfig, background: torch.Tensor):
    return (1 - cfg.focal_loss_alpha) * background + \
        cfg.focal_loss_alpha * (1 - background)


def focal_conf_loss(cfg: YolactConfig, conf_data, conf_t):
    """Softmax focal loss (multibox_loss.py:298-327)."""
    c = conf_data.shape[-1]
    conf_t = conf_t.reshape(-1)
    conf_data = conf_data.reshape(-1, c)
    keep = (conf_t >= 0).to(conf_data.dtype)
    t = conf_t.clamp(0, c - 1)
    logpt = torch.gather(F.log_softmax(conf_data, dim=-1), 1,
                         t[:, None])[:, 0]
    pt = torch.exp(logpt)
    at = _focal_weight(cfg, (t == 0).to(conf_data.dtype))
    loss = -at * (1 - pt) ** cfg.focal_loss_gamma * logpt
    return cfg.conf_alpha * (loss * keep).sum()


def focal_conf_sigmoid_loss(cfg: YolactConfig, conf_data, conf_t):
    """Sigmoid focal loss (multibox_loss.py:329-357)."""
    c = conf_data.shape[-1]
    conf_t = conf_t.reshape(-1)
    conf_data = conf_data.reshape(-1, c)
    keep = (conf_t >= 0).to(conf_data.dtype)
    one_t = F.one_hot(conf_t.clamp(0, c - 1), c).to(conf_data.dtype)
    logpt = F.logsigmoid(conf_data * (one_t * 2 - 1))
    pt = torch.exp(logpt)
    at = cfg.focal_loss_alpha * one_t + (1 - cfg.focal_loss_alpha) * (1 - one_t)
    at = torch.cat([torch.zeros_like(at[:, :1]), at[:, 1:]], dim=1)
    loss = -at * (1 - pt) ** cfg.focal_loss_gamma * logpt
    return cfg.conf_alpha * (keep * loss.sum(dim=-1)).sum()


def _positive_class_ce(conf_data, conf_t):
    """CE of the foreground logits (columns 1:) at the positives."""
    c = conf_data.shape[-1]
    t_pos = (conf_t - 1).clamp(0, c - 2)
    ce = -torch.gather(F.log_softmax(conf_data[:, 1:], dim=-1), 1,
                       t_pos[:, None])[:, 0]
    return (ce * (conf_t > 0).to(conf_data.dtype)).sum()


def focal_conf_objectness_loss(cfg: YolactConfig, conf_data, conf_t):
    """Objectness focal + positive-class CE (multibox_loss.py:359-390)."""
    c = conf_data.shape[-1]
    conf_t = conf_t.reshape(-1)
    conf_data = conf_data.reshape(-1, c)
    keep = (conf_t >= 0).to(conf_data.dtype)
    background = (conf_t.clamp(0, c - 1) == 0).to(conf_data.dtype)
    at = _focal_weight(cfg, background)
    logpt = F.logsigmoid(conf_data[:, 0]) * (1 - background) + \
        F.logsigmoid(-conf_data[:, 0]) * background
    pt = torch.exp(logpt)
    obj_loss = -at * (1 - pt) ** cfg.focal_loss_gamma * logpt
    return cfg.conf_alpha * (_positive_class_ce(conf_data, conf_t)
                             + (obj_loss * keep).sum())


def conf_objectness_loss(cfg: YolactConfig, conf_data, conf_t, loc_data,
                         loc_t, priors):
    """YOLO-style p(obj)*p(IoU) objectness (multibox_loss.py:392-428)."""
    b, p, c = conf_data.shape
    conf_tf = conf_t.reshape(-1)
    conf_df = conf_data.reshape(-1, c)
    pos_mask = (conf_tf > 0).to(conf_df.dtype)
    neg_mask = (conf_tf == 0).to(conf_df.dtype)

    obj = conf_df[:, 0]
    obj_neg_loss = -(F.logsigmoid(-obj) * neg_mask).sum()

    priors_b = priors[None].expand(b, p, 4).reshape(-1, 4)
    with torch.no_grad():
        iou = elemwise_box_iou(
            decode(loc_data.reshape(-1, 4), priors_b, cfg.use_yolo_regressors),
            decode(loc_t.reshape(-1, 4), priors_b, cfg.use_yolo_regressors))
    obj_pos = -(iou * F.logsigmoid(obj) + (1 - iou) * F.logsigmoid(-obj))
    obj_pos_loss = (obj_pos * pos_mask).sum()
    return cfg.conf_alpha * (_positive_class_ce(conf_df, conf_tf)
                             + obj_pos_loss + obj_neg_loss)


def semantic_segmentation_loss(cfg: YolactConfig, segm, gt_masks, gt_labels,
                               ds_pre=None):
    """Aux semantic-seg BCE (multibox_loss.py:218-239).  segm is
    [B, Hs, Ws, C-1]; gt_masks [B, G, S, S] float; crowds and padding are
    excluded.  ``ds_pre``: optional pre-downsampled binarized targets
    [B, G, Hs, Ws]."""
    b, hs, ws, cm1 = segm.shape
    if ds_pre is not None:
        dm = ds_pre
    else:
        if gt_masks is None:
            raise ValueError('semantic seg loss needs gt_masks or '
                             'precomputed gt_masks_seg targets')
        dm = _resize_masks(gt_masks, (hs, ws)) > 0.5
    dm = dm.to(segm.dtype) * (gt_labels >= 0)[:, :, None, None]
    # per class the union (max) of its instances' masks
    cls = gt_labels.clamp(0, cm1 - 1)[:, :, None, None].expand_as(dm)
    seg_t = torch.zeros((b, cm1, hs, ws), dtype=segm.dtype,
                        device=segm.device).scatter_reduce(
                            1, cls, dm, reduce='amax', include_self=True)
    loss = F.binary_cross_entropy_with_logits(
        segm.permute(0, 3, 1, 2), seg_t, reduction='sum')
    return loss / hs / ws * cfg.semantic_segmentation_alpha


def class_existence_loss(cfg: YolactConfig, class_data, gt_labels):
    """Aux class-existence BCE (multibox_loss.py:104-108,215); crowd and
    padding rows are left out of the target, as in the JAX package."""
    cm1 = class_data.shape[-1]
    valid = gt_labels >= 0
    onehot = F.one_hot(gt_labels.clamp(0, cm1 - 1), cm1).to(class_data.dtype)
    target = (onehot * valid[..., None]).amax(dim=1)
    return cfg.class_existence_alpha * F.binary_cross_entropy_with_logits(
        class_data, target, reduction='sum')


class MaskIoUTargets(NamedTuple):
    net_input: torch.Tensor  # [B, M, Hp, Wp] assembled (cropped) masks
    iou_t: torch.Tensor      # [B, M]
    label_t: torch.Tensor    # [B, M] int64
    valid: torch.Tensor      # [B, M] bool


def lincomb_mask_loss(cfg: YolactConfig, m: MatchResult, loc_data, mask_data,
                      priors, proto_data, gt_masks, gt_labels,
                      mask_priorities, maskiou_priorities=None, dm_pre=None,
                      mesh=None):
    """Prototype-coefficient mask loss (multibox_loss.py:499-674).

    ``mask_priorities [B, P]``, ``maskiou_priorities [B * M]``: the random
    draws (module docstring; with a `mesh`, the rank's rows and the global
    draws).  ``dm_pre``: optional pre-downsampled
    binarized gt at proto resolution [B, G, Hp, Wp]; when absent,
    ``gt_masks`` [B, G, S, S] are downsampled here."""
    pos, idx_t = m.pos, m.idx_t
    hp, wp = proto_data.shape[1], proto_data.shape[2]
    n_slots = cfg.masks_to_train
    sigmoid = cfg.mask_proto_mask_activation == 'sigmoid'

    if dm_pre is not None:
        if not cfg.mask_proto_binarize_downsampled_gt:
            raise ValueError('precomputed proto targets are binarized; this '
                             'config wants soft ones')
        dm = dm_pre.to(proto_data.dtype)               # [B, G, Hp, Wp]
    else:
        if gt_masks is None:
            raise ValueError('lincomb mask loss needs gt_masks or '
                             'precomputed gt_masks_proto targets')
        dm = _resize_masks(gt_masks, (hp, wp))
        if cfg.mask_proto_binarize_downsampled_gt:
            dm = (dm > 0.5).to(proto_data.dtype)

    if cfg.mask_proto_remove_empty_masks:
        # drop positives whose gt downsampled away (:525-531)
        nonempty = dm.sum(dim=(2, 3)) > 0.0001          # [B, G]
        pos = pos & torch.gather(nonempty, 1, idx_t)

    if cfg.mask_proto_reweight_mask_loss:
        # per-pixel fg/bg balance weights (:533-544)
        bin_gt = dm if cfg.mask_proto_binarize_downsampled_gt \
            else (dm > 0.5).to(proto_data.dtype)
        fg_norm = bin_gt / (bin_gt.sum(dim=(2, 3), keepdim=True) + 1e-4)
        bg_norm = (1 - bin_gt) / ((1 - bin_gt).sum(dim=(2, 3), keepdim=True)
                                  + 1e-4)
        reweight = (fg_norm * cfg.mask_proto_reweight_coeff + bg_norm) \
            * (hp * wp)                                 # [B, G, Hp, Wp]

    slots = _mask_slots(pos, mask_priorities, n_slots)      # [B, M]
    slot_valid = torch.gather(pos, 1, slots)
    sel_idx_t = torch.gather(idx_t, 1, slots)           # gt index per slot
    sel_coef = _take(mask_data, slots)                  # [B, M, mask_dim]
    if cfg.mask_proto_crop_with_pred_box:
        sel_box = _take(decode(loc_data, priors[None],
                               cfg.use_yolo_regressors), slots)
    else:
        sel_box = _take(m.gt_box_t, slots)              # [B, M, 4]
    mask_t = _take(dm, sel_idx_t)                       # [B, M, Hp, Wp]
    label_t = torch.gather(gt_labels, 1, sel_idx_t)

    # assemble the predicted masks (one product)
    pred = torch.einsum('bhwc,bmc->bmhw', proto_data, sel_coef)
    if sigmoid:
        pred = torch.sigmoid(pred)

    def pixel_loss(p):
        if sigmoid:
            return _TorchBCE.apply(p.clamp(0.0, 1.0), mask_t)
        return smooth_l1(p, mask_t)

    loss_double = 0.0
    if cfg.mask_proto_double_loss:
        # pre-crop loss added on top (:594-600)
        loss_double = cfg.mask_proto_double_loss_alpha * \
            (pixel_loss(pred).sum(dim=(2, 3)) * slot_valid).sum(dim=1)

    if cfg.mask_proto_crop:
        pred = _crop(pred, sel_box)
    pre_loss = pixel_loss(pred)

    if cfg.mask_proto_normalize_mask_loss_by_sqrt_area:
        gt_area = mask_t.sum(dim=(2, 3), keepdim=True)
        pre_loss = pre_loss / (torch.sqrt(gt_area) + 0.0001)
    if cfg.mask_proto_reweight_mask_loss:
        pre_loss = pre_loss * _take(reweight, sel_idx_t)

    per_slot = pre_loss.sum(dim=(2, 3))                 # [B, M]
    if cfg.mask_proto_normalize_emulate_roi_pooling:
        weight = hp * wp if cfg.mask_proto_crop else 1
        csize = center_size(sel_box)
        denom = torch.where(slot_valid, csize[..., 2] * wp * (csize[..., 3]
                                                              * hp), 1.0)
        per_slot = per_slot / denom * weight
    per_slot = per_slot * slot_valid

    # scale when we sub-sampled (multibox_loss.py:622-624)
    old_num_pos = pos.sum(dim=1)
    num_sel = slot_valid.sum(dim=1)
    scale = torch.where(old_num_pos > num_sel,
                        old_num_pos / num_sel.clamp(min=1), 1.0)
    loss_m = per_slot.sum(dim=1) * scale + loss_double  # [B]

    losses = {'M': loss_m.sum() * cfg.mask_alpha / hp / wp}

    if cfg.mask_proto_coeff_diversity_loss:
        cn = F.normalize(sel_coef, dim=2, eps=1e-12)
        cos = (cn @ cn.transpose(1, 2) + 1) / 2
        inst_eq = sel_idx_t[:, :, None] == sel_idx_t[:, None, :]
        vv = slot_valid[:, :, None] & slot_valid[:, None, :]
        d = torch.where(inst_eq, 1 - cos, cos) * vv
        losses['D'] = (cfg.mask_proto_coeff_diversity_alpha
                       * d.sum(dim=(1, 2)) / num_sel.clamp(min=1)).sum()

    miou_targets = None
    if cfg.use_maskiou:
        with torch.no_grad():
            bin_pred = (pred > 0.5).to(pred.dtype)
            inter = (bin_pred * mask_t).sum(dim=(2, 3))
            a2 = mask_t.sum(dim=(2, 3))
            union = bin_pred.sum(dim=(2, 3)) + a2 - inter
            iou_t = torch.where(union > 0,
                                inter / torch.where(union > 0, union, 1.0),
                                0.0)
            miou_valid = slot_valid
            if cfg.discard_mask_area > 0:
                miou_valid = miou_valid & (a2 > cfg.discard_mask_area)
            if cfg.maskious_to_train > 0:
                # global random subsample cap across the whole batch
                # (multibox_loss.py:663-669).  The reference checks
                # num_samples > maskious_to_train but then slices
                # perm[:cfg.masks_to_train]: a kept quirk, so the cap size
                # is masks_to_train.
                flat_ok = miou_valid.reshape(-1)        # [B * M]
                if mesh is not None:                    # every rank's slots
                    flat_ok = mesh.all_gather(flat_ok)
                cap = min(cfg.masks_to_train, flat_ok.shape[0])
                mpri = torch.where(flat_ok, maskiou_priorities, -1.0)
                kth = torch.sort(mpri).values[-cap]
                capped = flat_ok & (mpri >= kth)
                flat_ok = torch.where(
                    flat_ok.sum() > cfg.maskious_to_train, capped, flat_ok)
                if mesh is not None:
                    flat_ok = flat_ok[mesh.rows(flat_ok.shape[0])]
                miou_valid = flat_ok.reshape(miou_valid.shape)
        miou_targets = MaskIoUTargets(pred, iou_t, label_t.clamp(min=0),
                                      miou_valid)
    return losses, miou_targets


def direct_mask_loss(cfg: YolactConfig, m: MatchResult,
                     mask_data: torch.Tensor, gt_masks: torch.Tensor,
                     mask_priorities: torch.Tensor) -> torch.Tensor:
    """Direct-mask loss (``MaskType.DIRECT``; JAX ``direct_mask_loss``, the
    reference's ``multibox_loss.py:152-161`` with its gt-box crop): binary
    cross entropy between each slot's ``mask_size^2`` predictions and its
    matched gt mask, cropped by the gt box on a fixed ``mask_size`` grid
    of bilinear samples and binarised at 0.5.

    ``mask_data`` [B, P, mask_size^2] float32 sigmoid outputs, clamped to
    [0, 1] before the BCE; ``gt_masks`` [B, G, S, S] float.  As for the
    lincomb loss, ``masks_to_train`` slots per image take the positives in
    the order of ``mask_priorities`` [B, P] (JAX draws them per image from
    its key), and an image with more positives than slots has its sum
    scaled by positives / slots used, so its expectation is the uncapped
    sum."""
    b = m.pos.shape[0]
    s = gt_masks.shape[-1]
    ms = cfg.mask_size
    slots = _mask_slots(m.pos, mask_priorities, cfg.masks_to_train)
    slot_valid = torch.gather(m.pos, 1, slots)
    sel_gt = torch.gather(m.idx_t, 1, slots)
    sel_box = _take(m.gt_box_t, slots)                  # [B, M, 4]
    sel_pred = _take(mask_data, slots)                  # [B, M, ms * ms]
    gm = _take(gt_masks, sel_gt)                        # [B, M, S, S]
    n = slots.shape[1]

    # the fixed bilinear grid over each box, in pixels of the gt mask
    x1, y1, x2, y2 = (sel_box[..., i] * s for i in range(4))
    t = (torch.arange(ms, device=gm.device, dtype=gm.dtype) + 0.5) / ms
    ys = y1[..., None] + (y2 - y1)[..., None] * t - 0.5     # [B, M, ms]
    xs = x1[..., None] + (x2 - x1)[..., None] * t - 0.5
    y0 = ys.floor().long().clamp(0, s - 1)
    x0 = xs.floor().long().clamp(0, s - 1)
    y1i = (y0 + 1).clamp(0, s - 1)
    x1i = (x0 + 1).clamp(0, s - 1)
    wy = (ys - y0).clamp(0, 1)[..., :, None]
    wx = (xs - x0).clamp(0, 1)[..., None, :]

    def at(yi, xi):
        rows = torch.gather(gm, 2, yi[..., None].expand(b, n, ms, s))
        return torch.gather(rows, 3, xi[..., None, :].expand(b, n, ms, ms))

    mask_t = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
              + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    mask_t = (mask_t > 0.5).float().reshape(b, n, -1)
    bce = _TorchBCE.apply(sel_pred.clamp(0.0, 1.0), mask_t)
    per_image = (bce.sum(dim=2) * slot_valid).sum(dim=1)
    old_num_pos = m.pos.sum(dim=1)
    num_sel = slot_valid.sum(dim=1)
    scale = torch.where(old_num_pos > num_sel,
                        old_num_pos / num_sel.clamp(min=1), 1.0)
    return (per_image * scale).sum() * cfg.mask_alpha


def mask_iou_loss(cfg: YolactConfig, maskiou_net: Callable,
                  t: MaskIoUTargets):
    """Mask re-scoring training loss (multibox_loss.py:684-694).
    `maskiou_net` maps [N, 1, Hp, Wp] masks to [N, C-1] IoU predictions."""
    p = maskiou_net(t.net_input.flatten(0, 1)[:, None])    # [B*M, C-1]
    p = torch.gather(p, 1, t.label_t.reshape(-1)[:, None])[:, 0]
    loss = smooth_l1(p, t.iou_t.reshape(-1)) * t.valid.reshape(-1)
    return cfg.maskiou_alpha * loss.sum()


def multibox_loss(cfg: YolactConfig, predictions: Dict, batch: Dict,
                  mask_priorities: Optional[torch.Tensor] = None,
                  maskiou_priorities: Optional[torch.Tensor] = None,
                  maskiou_net: Optional[Callable] = None, conf_state=None,
                  num_gts=None, mesh=None
                  ) -> Tuple[Dict[str, torch.Tensor], MatchResult]:
    """Full training loss.  `batch` holds tensors in the contract of
    ``data/coco.py:pad_batch`` (gt_masks may be uint8; or the pre-downsampled
    ``gt_masks_proto`` / ``gt_masks_seg``, or those bit-packed as
    ``gt_masks_proto_packed`` / ``gt_masks_seg_packed``).  Returns
    ({letter: scalar}, match_result); with ``use_class_balanced_conf`` the
    updated conf_state rides back in ``losses['_conf_state']`` (popped by
    the train step, never summed).  `num_gts`: see ``train/matcher.py:match``.  `mesh`: the
    rank's share of the global batch's loss (module docstring)."""
    loc_data = predictions['loc'].float()
    conf_data = predictions['conf'].float()
    mask_data = predictions['mask'].float()
    priors = predictions['priors'].float()

    gt_boxes = batch['gt_boxes']
    gt_labels = batch['gt_labels'].long()
    gt_masks = batch.get('gt_masks')
    if gt_masks is not None:
        gt_masks = gt_masks.float()

    def pre_target(name, hw):
        """Pre-downsampled gt mask targets (``data/coco.py:pad_batch``
        multires, or ``data/device_augment.py``) as float, unpacked on the
        device where they come bit-packed (``name + '_packed'``): the
        target (h, w) is the prediction's."""
        if name in batch:
            return batch[name].float()
        packed = batch.get(name + '_packed')
        if packed is None:
            return None
        H, W = hw
        assert packed.shape[-2] == H and \
            packed.shape[-1] == packed_width(W), (
                f'{name}_packed shape {tuple(packed.shape[-2:])} does not '
                f'match the model target ({H}, {packed_width(W)})')
        return unpack_bits_last(packed, W).float()

    with timer.span('match'):
        m = match(cfg, gt_boxes, gt_labels, priors,
                  loc_pred=loc_data if cfg.use_prediction_matching else None,
                  num_gts=num_gts)

    losses: Dict[str, torch.Tensor] = {}
    total_num_pos = m.pos.sum()
    if mesh is not None:
        total_num_pos = mesh.all_sum(total_num_pos)
    total_num_pos = total_num_pos.clamp(min=1).float()
    world = 1 if mesh is None else mesh.size

    if cfg.train_boxes:
        l1 = smooth_l1(loc_data, m.loc_t).sum(dim=-1) * m.pos
        losses['B'] = l1.sum() * cfg.bbox_alpha

    maskiou_targets = None
    if cfg.train_masks and cfg.mask_type == MaskType.DIRECT:
        if gt_masks is None:
            raise ValueError('direct mask loss needs full-res gt_masks; '
                             'disable multires targets for DIRECT configs')
        losses['M'] = direct_mask_loss(cfg, m, mask_data, gt_masks,
                                       mask_priorities)
    if cfg.train_masks and cfg.mask_type == MaskType.LINCOMB:
        proto_data = predictions['proto'].float()
        mask_losses, maskiou_targets = lincomb_mask_loss(
            cfg, m, loc_data, mask_data, priors, proto_data, gt_masks,
            gt_labels, mask_priorities, maskiou_priorities,
            dm_pre=pre_target('gt_masks_proto', proto_data.shape[1:3]),
            mesh=mesh)
        losses.update(mask_losses)
        if cfg.mask_proto_loss == 'l1':
            # l1_expected_area / l1_alpha from multibox_loss.py:37-39
            losses['P'] = predictions['proto'].abs().mean() / world / \
                (20 * 20 / 70 / 70) * 0.1
        elif cfg.mask_proto_loss == 'disj':
            losses['P'] = -F.log_softmax(
                predictions['proto'], dim=-1).amax(dim=-1).mean() / world

    if cfg.use_focal_loss:
        if cfg.use_sigmoid_focal_loss:
            losses['C'] = focal_conf_sigmoid_loss(cfg, conf_data, m.conf_t)
        elif cfg.use_objectness_score:
            losses['C'] = focal_conf_objectness_loss(cfg, conf_data, m.conf_t)
        else:
            losses['C'] = focal_conf_loss(cfg, conf_data, m.conf_t)
    elif cfg.use_objectness_score:
        losses['C'] = conf_objectness_loss(cfg, conf_data, m.conf_t,
                                           loc_data, m.loc_t, priors)
    else:
        losses['C'], new_conf_state = ohem_conf_loss(
            cfg, conf_data, m.conf_t, m.pos, conf_state, mesh)
        if cfg.use_class_balanced_conf and new_conf_state is not None:
            losses['_conf_state'] = new_conf_state

    if cfg.use_maskiou and maskiou_targets is not None and \
            maskiou_net is not None:
        losses['I'] = mask_iou_loss(cfg, maskiou_net, maskiou_targets)

    if cfg.use_class_existence_loss:
        losses['E'] = class_existence_loss(cfg, predictions['classes'],
                                           gt_labels)
    if cfg.use_semantic_segmentation_loss:
        losses['S'] = semantic_segmentation_loss(
            cfg, predictions['segm'].float(), gt_masks, gt_labels,
            ds_pre=pre_target('gt_masks_seg',
                              predictions['segm'].shape[1:3]))

    batch_size = loc_data.shape[0] * world
    for k in losses:
        if k == '_conf_state':
            continue
        if k in ('P', 'E', 'S'):
            losses[k] = losses[k] / batch_size
        else:
            losses[k] = losses[k] / total_num_pos
    return losses, m
