"""The port's anchors and box ops (yolact_tpu_torch.ops) against the JAX
package's on the same seeded inputs.  Anchors must be equal exactly; box
ops within 1e-6 (the same float32 operations in the same order).  The
port gets its own config (``P`` = ``config_from_jax``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from yolact_tpu import config as C
from yolact_tpu.ops import anchors as jax_anchors
from yolact_tpu.ops import boxes as jax_boxes
from yolact_tpu.detect.detection import eval_scores as jax_eval_scores
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.detect.detection import eval_scores
from yolact_tpu_torch.ops import anchors, boxes

torch.set_num_threads(2)


@pytest.mark.parametrize('make_cfg,img_size', [
    (lambda: C.get_config('yolact_base'), None),
    (lambda: C.get_config('yolact_base'), (480, 640)),
    (lambda: C.get_config('yolact_im700'), None),
    (tiny_resnet_config, None),
])
def test_priors_equal_jax_exactly(make_cfg, img_size):
    cfg = make_cfg()
    want = jax_anchors.generate_priors(cfg, img_size)
    got = anchors.generate_priors(P(cfg), img_size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert anchors.feature_map_sizes(P(cfg), img_size) == \
        jax_anchors.feature_map_sizes(cfg, img_size)
    assert anchors.proto_size(P(cfg), img_size) == \
        jax_anchors.proto_size(cfg, img_size)


def test_yolact_plus_base_priors_equal_jax_exactly():
    """9 anchors per position (3 scales x 3 ratios) over 5 levels."""
    cfg = C.get_config('yolact_plus_base')
    got = anchors.generate_priors(P(cfg))
    np.testing.assert_array_equal(got, jax_anchors.generate_priors(cfg))
    assert got.shape == (57744, 4)
    assert anchors.proto_size(P(cfg)) == (138, 138)


def test_yolact_base_prior_count_and_square_anchors():
    cfg = C.get_config('yolact_base')
    priors = anchors.generate_priors(P(cfg))
    assert priors.shape == (19248, 4)
    # use_square_anchors bug-compat: h == w for every prior
    np.testing.assert_array_equal(priors[:, 2], priors[:, 3])
    assert anchors.proto_size(P(cfg)) == (138, 138)


def test_other_backbones_not_ported():
    with pytest.raises(NotImplementedError, match='A8'):
        anchors.generate_priors(C.get_config('yolact_darknet53'))


def _boxes(rng, *shape):
    xy1 = rng.rand(*shape, 2) * 0.7
    wh = rng.rand(*shape, 2) * 0.3
    b = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    b[..., 0, 2:] = b[..., 0, :2]        # a zero-area box
    b[..., 1, :] = b[..., 1, [2, 3, 0, 1]]   # an inverted box
    return b


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('name', ['point_form', 'area'])
def test_unary_box_ops(rng, name):
    b = _boxes(rng, 3, 20)
    _close(getattr(boxes, name)(torch.from_numpy(b)),
           getattr(jax_boxes, name)(jnp.asarray(b)))


@pytest.mark.parametrize('name', ['intersect', 'jaccard'])
def test_pairwise_box_ops(rng, name):
    a, b = _boxes(rng, 2, 20), _boxes(rng, 2, 15)
    _close(getattr(boxes, name)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jax_boxes, name)(jnp.asarray(a), jnp.asarray(b)))


def test_jaccard_crowd(rng):
    a, b = _boxes(rng, 20), _boxes(rng, 15)
    _close(boxes.jaccard(torch.from_numpy(a), torch.from_numpy(b), True),
           jax_boxes.jaccard(jnp.asarray(a), jnp.asarray(b), True))


@pytest.mark.parametrize('yolo', [False, True])
def test_decode(rng, yolo):
    loc = (rng.randn(2, 30, 4) * 0.5).astype(np.float32)
    priors = np.concatenate([rng.rand(30, 2), rng.rand(30, 2) * 0.3 + 0.02],
                            -1).astype(np.float32)
    _close(boxes.decode(torch.from_numpy(loc), torch.from_numpy(priors), yolo),
           jax_boxes.decode(jnp.asarray(loc), jnp.asarray(priors), yolo))


@pytest.mark.parametrize('cast,padding', [(False, 1), (True, 0)])
def test_sanitize_coordinates(rng, cast, padding):
    x1 = (rng.rand(40) * 1.4 - 0.2).astype(np.float32)
    x2 = (rng.rand(40) * 1.4 - 0.2).astype(np.float32)
    got = boxes.sanitize_coordinates(torch.from_numpy(x1),
                                     torch.from_numpy(x2), 138, padding, cast)
    want = jax_boxes.sanitize_coordinates(jnp.asarray(x1), jnp.asarray(x2),
                                          138, padding, cast)
    for g, w in zip(got, want):
        _close(g, w)


def test_crop(rng):
    masks = rng.rand(16, 12, 9).astype(np.float32)
    b = _boxes(rng, 9)
    b[2] = [-0.3, -0.2, 1.4, 1.1]        # out of [0, 1]
    _close(boxes.crop(torch.from_numpy(masks), torch.from_numpy(b)),
           jax_boxes.crop(jnp.asarray(masks), jnp.asarray(b)))


@pytest.mark.parametrize('overrides', [
    {},
    {'use_focal_loss': True},
    {'use_focal_loss': True, 'use_sigmoid_focal_loss': True},
    {'use_focal_loss': True, 'use_sigmoid_focal_loss': True,
     'use_mask_scoring': True},
    {'use_focal_loss': True, 'use_objectness_score': True},
    {'use_objectness_score': True},
])
def test_eval_scores_matches_jax(rng, overrides):
    cfg = C.get_config('yolact_base').copy(num_classes=6, **overrides)
    preds = {'conf': (rng.randn(2, 30, 6) * 2).astype(np.float32),
             'score': rng.randn(2, 30, 1).astype(np.float32)}
    got = eval_scores(P(cfg),
                      {k: torch.from_numpy(v) for k, v in preds.items()})
    want = jax_eval_scores(cfg, {k: jnp.asarray(v) for k, v in preds.items()})
    _close(got, want)
