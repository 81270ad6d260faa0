"""The port's losses (``yolact_tpu_torch.train.loss``) against the JAX
package's, float32 on the CPU: the same seeded predictions and batch, and
the same random draws (the JAX side draws its sampling priorities inside
the loss from its key; the test repeats those ``jax.random`` calls and
hands the numbers to the port).

Every loss letter agrees within 1e-5 relative (sums of a few thousand
float32 terms in another order), except P with ``mask_proto_loss='l1'``
within 1e-4: XLA's CPU mean of the 24,576 prototype values is 4e-5 under
the float64 mean, PyTorch's pairwise sum 3e-8 over it.  The gradient of the total with respect
to each prediction within 1e-4 of that gradient's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from yolact_tpu.models.yolact import MaskIoUHead
from yolact_tpu.ops.anchors import generate_priors
from yolact_tpu.train import loss as jax_loss
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.models.heads import FastMaskIoUNet
from yolact_tpu_torch.train import loss

torch.set_num_threads(2)

B, G, S, HP, HS = 3, 8, 128, 32, 16


def jax_draws(key, b, p, m):
    """The priorities that ``yolact_tpu.train.loss.lincomb_mask_loss`` draws
    from `key`: ([B, P] per-image uniforms, [B * M] maskiou uniforms)."""
    rng_images, rng_miou = jax.random.split(key)
    pri = jnp.stack([jax.random.uniform(k, (p,))
                     for k in jax.random.split(rng_images, b)])
    return np.asarray(pri), np.asarray(jax.random.uniform(rng_miou, (b * m,)))


def _inputs(cfg, seed=0):
    """Seeded predictions and a batch whose gts sit on anchors, so that each
    image has positives (more than a small ``masks_to_train``)."""
    rng = np.random.RandomState(seed)
    priors = generate_priors(cfg, (S, S))
    p = len(priors)
    c, md = cfg.num_classes, cfg.mask_dim
    preds = dict(
        loc=(rng.randn(B, p, 4) * 0.3).astype(np.float32),
        conf=rng.randn(B, p, c).astype(np.float32) * 2,
        mask=np.tanh(rng.randn(B, p, md)).astype(np.float32),
        priors=priors.astype(np.float32),
        proto=np.maximum(rng.randn(B, HP, HP, md), 0).astype(np.float32),
        segm=rng.randn(B, HS, HS, c - 1).astype(np.float32),
        classes=rng.randn(B, c - 1).astype(np.float32))
    pf = np.concatenate([priors[:, :2] - priors[:, 2:] / 2,
                         priors[:, :2] + priors[:, 2:] / 2], 1).clip(0, 1)
    big = np.flatnonzero((pf[:, 2] - pf[:, 0] > 0.15)
                         & (pf[:, 3] - pf[:, 1] > 0.15))
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -2, np.int32)
    masks = np.zeros((B, G, S, S), np.uint8)
    for b in range(B):
        n = 5
        boxes[b, :n] = pf[rng.choice(big, n, replace=False)]
        labels[b, :n] = rng.randint(0, c - 1, n)
        labels[b, n - 1] = -1                                # a crowd
        for g in range(n):
            x1, y1, x2, y2 = (boxes[b, g] * S).astype(int)
            masks[b, g, y1:y2, x1:x2] = 1
        masks[b, 1] = 0                  # an empty mask (remove_empty_masks)
    batch = dict(gt_boxes=boxes, gt_labels=labels, gt_masks=masks)
    return preds, batch


def _run_both(cfg, preds, batch, key, maskiou=None, conf_state=None):
    """({letter: (port, jax)}, {pred name: (port grad, jax grad)}, the two
    conf states)."""
    p = preds['priors'].shape[0]
    pri, mpri = (a.copy() for a in jax_draws(key, B, p, cfg.masks_to_train))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    head, mv = maskiou if maskiou else (None, None)
    diff = [k for k in preds if k != 'priors']

    def jax_total(d):
        apply = (lambda m: head.apply(mv, m)) if head else None
        losses, _ = jax_loss.multibox_loss(
            cfg, key, dict(d, priors=jnp.asarray(preds['priors'])), jb,
            maskiou_apply=apply, conf_state=conf_state)
        state = losses.pop('_conf_state', None)
        return sum(losses.values()), (losses, state)

    (_, (want, want_state)), want_grads = jax.jit(
        jax.value_and_grad(jax_total, has_aux=True))(
            {k: jnp.asarray(preds[k]) for k in diff})

    net = None
    if maskiou:
        net = FastMaskIoUNet(P(cfg))
        net.load_state_dict({
            k[len('maskiou_net.'):]: t for k, t in
            jax_variables_to_state_dict(P(cfg), {'maskiou': mv}).items()})
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    for k in diff:
        tp[k].requires_grad_()
    tstate = None if conf_state is None else {
        k: torch.from_numpy(np.asarray(v)) for k, v in conf_state.items()}
    got, _ = loss.multibox_loss(
        P(cfg), tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(pri), torch.from_numpy(mpri), maskiou_net=net,
        conf_state=tstate)
    got_state = got.pop('_conf_state', None)
    sum(got.values()).backward()
    assert set(got) == set(want)
    letters = {k: (float(got[k].detach()), float(want[k])) for k in want}
    grads = {k: (tp[k].grad.numpy() if tp[k].grad is not None
                 else np.zeros_like(preds[k]), np.asarray(want_grads[k]))
             for k in diff}
    return letters, grads, (got_state, want_state)


def _assert_close(letters, grads):
    for k, (g, w) in letters.items():
        assert np.isfinite(w), k
        np.testing.assert_allclose(g, w, rtol=1e-4 if k == 'P' else 1e-5,
                                   atol=1e-6, err_msg=k)
    for k, (g, w) in grads.items():
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=f'grad {k}')


CASES = {
    'base': {},
    'subsampled': {'masks_to_train': 4},
    'ohem_most_confident': {'ohem_use_most_confident': True},
    'focal': {'use_focal_loss': True},
    'focal_sigmoid': {'use_focal_loss': True, 'use_sigmoid_focal_loss': True},
    'focal_objectness': {'use_focal_loss': True,
                         'use_objectness_score': True},
    'objectness': {'use_objectness_score': True},
    'crop_with_pred_box': {'mask_proto_crop_with_pred_box': True},
    'no_crop': {'mask_proto_crop': False},
    'double_loss': {'mask_proto_double_loss': True, 'masks_to_train': 4},
    'sqrt_area': {'mask_proto_normalize_mask_loss_by_sqrt_area': True},
    'reweight': {'mask_proto_reweight_mask_loss': True},
    'reweight_soft': {'mask_proto_reweight_mask_loss': True,
                      'mask_proto_binarize_downsampled_gt': False},
    'emulate_roi_pooling_off': {
        'mask_proto_normalize_emulate_roi_pooling': False},
    'remove_empty_masks': {'mask_proto_remove_empty_masks': True},
    'soft_gt': {'mask_proto_binarize_downsampled_gt': False},
    'linear_masks': {'mask_proto_mask_activation': 'none',
                     'mask_proto_double_loss': True},
    'diversity': {'mask_proto_coeff_diversity_loss': True,
                  'masks_to_train': 6},
    'proto_l1': {'mask_proto_loss': 'l1'},
    'proto_disj': {'mask_proto_loss': 'disj'},
    'class_existence': {'use_class_existence_loss': True},
    'no_semantic': {'use_semantic_segmentation_loss': False},
    'boxes_only': {'train_masks': False},
}


@pytest.mark.parametrize('name', list(CASES))
def test_losses_match_jax(name):
    cfg = tiny_resnet_config(**CASES[name])
    preds, batch = _inputs(cfg, seed=len(name))
    if cfg.mask_proto_loss == 'l1':
        # d|x|/dx at exactly 0 is a convention (0 in PyTorch, 1 in JAX); a
        # ReLU prototype's own gradient is 0 there in both, so keep the
        # comparison off the kink
        preds['proto'] = preds['proto'] + np.float32(0.01)
    letters, grads, _ = _run_both(cfg, preds, batch, jax.random.PRNGKey(5))
    want = {'B', 'C', 'M', 'S'}
    want |= {'D'} if cfg.mask_proto_coeff_diversity_loss else set()
    want |= {'P'} if cfg.mask_proto_loss else set()
    want |= {'E'} if cfg.use_class_existence_loss else set()
    want -= set() if cfg.use_semantic_segmentation_loss else {'S'}
    want -= set() if cfg.train_masks else {'M'}
    assert set(letters) == want
    _assert_close(letters, grads)
    assert abs(grads['conf'][1]).max() > 0


def test_class_balanced_conf_matches_jax():
    cfg = tiny_resnet_config(use_class_balanced_conf=True)
    preds, batch = _inputs(cfg, seed=3)
    state = {'class_counts': jnp.asarray(np.arange(5, dtype=np.float32) * 3),
             'total': jnp.asarray(30.0)}
    letters, grads, (got, want) = _run_both(
        cfg, preds, batch, jax.random.PRNGKey(2), conf_state=state)
    _assert_close(letters, grads)
    for k in ('class_counts', 'total'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=0)
    assert float(got['total']) > 30


@pytest.mark.parametrize('overrides', [
    {}, {'maskious_to_train': 3, 'masks_to_train': 6},
    {'discard_mask_area': 150.0}], ids=['plain', 'capped', 'discard_area'])
def test_maskiou_loss_matches_jax(overrides):
    cfg = tiny_plus_config(**overrides)
    preds, batch = _inputs(cfg, seed=7)
    head = MaskIoUHead(cfg)
    mv = jax.tree_util.tree_map(np.array, dict(head.init(
        jax.random.PRNGKey(4), jnp.zeros((1, HP, HP, 1)))))
    letters, grads, _ = _run_both(cfg, preds, batch, jax.random.PRNGKey(9),
                                  maskiou=(head, mv))
    assert 'I' in letters and letters['I'][1] > 0
    _assert_close(letters, grads)


def test_precomputed_mask_targets_match_full_res(rng):
    """``gt_masks_proto`` / ``gt_masks_seg`` (what ``pad_batch(multires=)``
    gives) in place of full-resolution masks: the same losses, and the same
    bits again from the targets bit-packed (``*_packed``, unpacked by the
    loss, which checks their shape against the prediction's); direct
    masks, which need the full-resolution masks, raise as JAX's loss
    does."""
    from yolact_tpu_torch.ops.bits import pack_bits_last
    cfg = P(tiny_resnet_config())
    preds, batch = _inputs(cfg, seed=1)
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    pri = torch.from_numpy(rng.rand(B, len(preds['priors']))
                           .astype(np.float32))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = loss.multibox_loss(cfg, tp, tb, pri)
    soft = torch.from_numpy(batch['gt_masks'].astype(np.float32))
    pre = dict(tb)
    del pre['gt_masks']
    packed = dict(pre)
    for name, hw in (('gt_masks_proto', HP), ('gt_masks_seg', HS)):
        pre[name] = (loss._resize_masks(soft, (hw, hw)) > 0.5).to(torch.uint8)
        packed[name + '_packed'] = torch.from_numpy(
            pack_bits_last(pre[name].numpy()))
    got, _ = loss.multibox_loss(cfg, tp, pre, pri)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    got, _ = loss.multibox_loss(cfg, tp, packed, pri)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    with pytest.raises(AssertionError, match='gt_masks_seg_packed shape'):
        loss.multibox_loss(cfg, tp, dict(packed, gt_masks_seg_packed=packed[
            'gt_masks_proto_packed']), pri)
    # direct masks need the full-resolution gt masks (JAX's guard)
    from yolact_tpu_torch.config import MaskType
    with pytest.raises(ValueError, match='full-res gt_masks'):
        loss.multibox_loss(cfg.copy(mask_type=MaskType.DIRECT), tp, pre, pri)


def test_slot_ties_go_to_the_lowest_index():
    """An image with fewer positives than slots fills the rest with
    zero-priority priors in index order, as ``jax.lax.top_k`` does: the
    padding slots are invalid and add nothing, and the loss does not depend
    on the draws (they only reorder the slots, so the float32 sums agree
    within 1e-6 relative)."""
    cfg = P(tiny_resnet_config(masks_to_train=50))
    preds, batch = _inputs(cfg, seed=2)
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = len(preds['priors'])
    gen = torch.Generator().manual_seed(0)
    a, m = loss.multibox_loss(cfg, tp, tb, torch.rand(B, p, generator=gen))
    b, _ = loss.multibox_loss(cfg, tp, tb, torch.rand(B, p, generator=gen))
    assert 0 < int(m.pos.sum(1).max()) < 50
    assert float(a['M']) == pytest.approx(float(b['M']), rel=1e-6)


def test_bce_is_torch_bce_and_lets_nan_through():
    """The written-out BCE has ``F.binary_cross_entropy``'s values and
    gradients (subnormal probabilities and exact 0 and 1 included) and,
    unlike it, turns a NaN input into a NaN loss instead of raising."""
    import torch.nn.functional as F
    p = torch.tensor([1e-40, 2.2e-39, 1e-20, 0.3, 0.999999, 1.0, 0.0, 0.5])
    t = torch.tensor([1., 1., 1., 0., 0., 0., 1., 0.25])
    a, b = p.clone().requires_grad_(), p.clone().requires_grad_()
    got = loss._TorchBCE.apply(a, t)
    want = F.binary_cross_entropy(b, t, reduction='none')
    assert torch.equal(got, want)
    got.sum().backward()
    want.sum().backward()
    assert bool(a.grad.isfinite().all())
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6)
    bad = torch.tensor([float('nan'), 0.5])
    assert bool(loss._TorchBCE.apply(bad, t[:2]).isnan()[0])
    with pytest.raises(RuntimeError):
        F.binary_cross_entropy(bad, t[:2])
