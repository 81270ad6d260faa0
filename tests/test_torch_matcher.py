"""The port's matcher and box helpers against the JAX package's
(``yolact_tpu.train.matcher``, ``yolact_tpu.ops.boxes``) on seeded inputs,
float32 on the CPU.

The matcher's outputs must be EQUAL to JAX's: ``conf_t``, ``idx_t`` and
``pos`` exactly (they are decisions; ties go to the lowest index on both
sides), ``loc_t`` and ``gt_box_t`` within 1e-6 (``gt_box_t`` is a gather and
is exact; ``loc_t`` takes a log, whose last bit XLA and PyTorch may round
differently).  The box helpers agree within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from yolact_tpu.ops import boxes as jax_boxes
from yolact_tpu.ops.anchors import generate_priors
from yolact_tpu.train.matcher import match as jax_match
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.ops import boxes
from yolact_tpu_torch.train.matcher import match

torch.set_num_threads(2)


def _gts(rng, priors, B=3, G=9):
    """Per image: random gts, a duplicate pair, a gt equal to a prior, a
    zero-IoU sliver outside every anchor's reach, crowds at the tail and
    padding."""
    pf = np.concatenate([priors[:, :2] - priors[:, 2:] / 2,
                         priors[:, :2] + priors[:, 2:] / 2], 1)
    gt = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -2, np.int32)
    for b in range(B):
        n = 5 + b % 2
        xy = rng.rand(n, 2) * 0.6
        wh = rng.rand(n, 2) * 0.35 + 0.05
        gt[b, :n] = np.concatenate([xy, np.minimum(xy + wh, 1)], 1)
        gt[b, 1] = gt[b, 0]                                  # duplicates
        gt[b, 2] = pf[rng.randint(len(pf))]                  # IoU 1 exactly
        gt[b, 3] = [0.999, 0.999, 1.0, 1.0]                  # ~zero IoU
        labels[b, :n] = rng.randint(0, 4, n)
        labels[b, n - 1] = -1                                # a crowd
        if b == 2:
            labels[b, n - 2] = -1                            # two crowds
    return gt, labels


def _assert_match(got, want):
    for name in ('conf_t', 'idx_t', 'pos'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.gt_box_t.numpy(),
                               np.asarray(want.gt_box_t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.loc_t.numpy(), np.asarray(want.loc_t),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('overrides', [
    {}, {'use_change_matching': True}, {'use_prediction_matching': True},
    {'crowd_iou_threshold': 1.0}, {'positive_iou_threshold': 0.3,
                                   'negative_iou_threshold': 0.2},
], ids=['iou', 'change', 'prediction', 'no_crowd', 'thresholds'])
def test_match_equals_jax(overrides):
    cfg = tiny_resnet_config(**overrides)
    rng = np.random.RandomState(0)
    priors = generate_priors(cfg, (128, 128))
    gt, labels = _gts(rng, priors)
    loc = (rng.randn(len(gt), len(priors), 4) * 0.3).astype(np.float32)
    pred = cfg.use_prediction_matching
    want = jax_match(cfg, jnp.asarray(gt), jnp.asarray(labels),
                     jnp.asarray(priors),
                     loc_pred=jnp.asarray(loc) if pred else None)
    assert int(np.asarray(want.pos).sum()) > 0
    args = [torch.from_numpy(a) for a in (gt, labels, priors)]
    kw = dict(loc_pred=torch.from_numpy(loc)) if pred else {}
    _assert_match(match(P(cfg), *args, **kw), want)
    # the host's gt counts only shorten the loop
    counts = (labels != -2).sum(1)
    _assert_match(match(P(cfg), *args, num_gts=counts, **kw), want)


def test_match_all_padding_and_crowd_only():
    """An image with no gt at all and one with only a crowd: background
    everywhere (the crowd's priors neutral), no positives."""
    cfg = tiny_resnet_config()
    priors = generate_priors(cfg, (128, 128))
    gt = np.zeros((2, 4, 4), np.float32)
    labels = np.full((2, 4), -2, np.int32)
    gt[1, 0] = [0.2, 0.2, 0.7, 0.8]
    labels[1, 0] = -1
    want = jax_match(cfg, jnp.asarray(gt), jnp.asarray(labels),
                     jnp.asarray(priors))
    got = match(P(cfg), *(torch.from_numpy(a) for a in (gt, labels, priors)))
    _assert_match(got, want)
    assert not got.pos.any() and (got.conf_t[1] == -1).any()


def test_box_helpers_match_jax(rng):
    xy = rng.rand(40, 2).astype(np.float32) * 0.6
    a = np.concatenate([xy, xy + rng.rand(40, 2).astype(np.float32) * 0.4
                        + 0.01], 1)
    b = np.roll(a, 7, 0) + np.float32(0.03)
    pri = np.concatenate([rng.rand(40, 2), rng.rand(40, 2) * 0.5 + 0.05],
                         1).astype(np.float32)
    ta, tb, tp = (torch.from_numpy(t) for t in (a, b, pri))
    ja, jb, jp = (jnp.asarray(t) for t in (a, b, pri))
    x = (rng.randn(6, 11) * 5).astype(np.float32)
    pairs = [
        (boxes.center_size(ta), jax_boxes.center_size(ja)),
        (boxes.elemwise_box_iou(ta, tb), jax_boxes.elemwise_box_iou(ja, jb)),
        (boxes.change(ta[:9], tb), jax_boxes.change(ja[:9], jb)),
        (boxes.jaccard(ta, tb[:9], iscrowd=True),
         jax_boxes.jaccard(ja, jb[:9], iscrowd=True)),
        (boxes.log_sum_exp(torch.from_numpy(x)),
         jax_boxes.log_sum_exp(jnp.asarray(x))),
    ] + [(boxes.encode(ta, tp, yolo), jax_boxes.encode(ja, jp, yolo))
         for yolo in (False, True)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # encode inverts decode
    np.testing.assert_allclose(
        boxes.decode(boxes.encode(ta, tp), tp).numpy(), a, atol=1e-5)
    # a zero-size (padded) gt row encodes to a finite value
    assert bool(boxes.encode(torch.zeros(1, 4), tp[:1]).isfinite().all())
