"""The port's cv2-free transforms (``yolact_tpu_torch/data/augmentations.py``)
against cv2 and against the JAX package's cv2-based ones.

* The resize against ``cv2.resize`` (INTER_LINEAR, float32) bit for bit on
  cv2's generic path (the ``cv2_generic`` fixture turns Intel IPP off),
  for up- and downscales, odd sizes and the exact 2x downscale, with 3 and
  5 channels (the image and a mask stack); with IPP on, which this cv2
  takes for 1, 3 and 4 channels, within 1.6e-2 on the 0-255 scale (IPP
  rounds its own way; found 9.0e-3 here, 1.53e-2 over more shapes).
* HSV both directions against ``cv2.cvtColor`` within 1e-4 (found 3.1e-5
  in hue and in BGR, saturation and value exact).
* ``SSDAugmentation`` against JAX's with the same ``RandomState`` seed:
  boxes, labels, ``num_crowds`` and shapes exactly (every random draw is the
  same), the image within 1e-3 on the 0-255 scale (the HSV conversion's
  rounding; found 3.1e-4), the masks bit-equal (no HSV on their path, and
  the resize is cv2's), over the augment flags every registered config uses with
  each backbone transform, and with flips (and so rot90) and
  ``preserve_aspect_ratio`` on.
* ``BaseTransform`` against JAX's exactly.
"""

import itertools
import os

import numpy as np
import pytest

from _tiny import tiny_resnet_config
from test_torch_inputs import cv2_generic  # noqa: F401
from yolact_tpu import config as J
from yolact_tpu.data import augmentations as jax_aug
from yolact_tpu_torch import STD
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.data import augmentations as aug

SIZES = [((480, 640), (550, 550)), ((640, 480), (550, 550)),
         ((600, 600), (550, 550)), ((300, 200), (550, 550)),
         ((549, 551), (138, 138)), ((61, 45), (64, 64)),
         ((120, 100), (60, 50)), ((7, 9), (13, 2))]


@pytest.mark.parametrize('src,dst,channels', [
    (s, d, c) for (s, d), c in itertools.product(SIZES, (3, 5))],
    ids=lambda v: 'x'.join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_resize_matches_cv2(src, dst, channels, cv2_generic):
    cv2 = cv2_generic
    rng = np.random.RandomState(0)
    img = (rng.rand(*src, channels) * 255).astype(np.float32)
    want = cv2.resize(img, dst[::-1])
    np.testing.assert_array_equal(aug.resize_linear(img, *dst[::-1]), want)
    # the same stack as [C, H, W] masks
    masks = np.ascontiguousarray(img.transpose(2, 0, 1))
    got = aug.resize_linear(masks, *dst[::-1], axis=1)
    np.testing.assert_array_equal(got, want.transpose(2, 0, 1))


def test_resize_against_cv2_ipp():
    import cv2
    rng = np.random.RandomState(1)
    for (src, dst), c in itertools.product(SIZES[:4], (1, 3)):
        img = (rng.rand(*src, c) * 255).astype(np.float32)
        want = cv2.resize(img, dst[::-1]).reshape(dst + (c,))
        got = aug.resize_linear(img, *dst[::-1])
        assert np.abs(got - want).max() <= 1.6e-2


def test_hsv_matches_cv2():
    import cv2
    rng = np.random.RandomState(2)
    # values beyond [0, 255] as brightness and contrast leave them, grey
    # pixels (s = 0) and ties between channels
    img = (rng.rand(64, 80, 3) * 320 - 32).astype(np.float32)
    img[:4] = 100.0
    img[4:8, :, 0] = img[4:8, :, 1]
    img[8:12, :, 2] = img[8:12, :, 1]
    hsv = aug.bgr_to_hsv(img)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    np.testing.assert_allclose(hsv, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(hsv[..., 1:], want[..., 1:])
    # the augmentation's jitter: saturation scaled, hue shifted and wrapped
    want[..., 1] *= 1.4
    want[..., 0] += 17.0
    want[..., 0][want[..., 0] > 360.0] -= 360.0
    np.testing.assert_allclose(aug.hsv_to_bgr(want),
                               cv2.cvtColor(want, cv2.COLOR_HSV2BGR),
                               rtol=0, atol=1e-4)


def _sample(rng, h, w, n=4):
    """A raw BGR frame, n boxes (relative point form, the last a crowd)
    with elliptic masks inside them."""
    img = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    xy1 = rng.rand(n, 2) * 0.6
    xy2 = np.minimum(xy1 + 0.1 + rng.rand(n, 2) * 0.4, 1.0)
    boxes = np.hstack([xy1, xy2])
    yy, xx = np.mgrid[:h, :w] + 0.5
    cx, cy = (xy1 + xy2).T / 2 * [[w], [h]]
    rx, ry = (xy2 - xy1).T / 2 * [[w], [h]]
    masks = ((((xx - cx[:, None, None]) / rx[:, None, None]) ** 2
              + ((yy - cy[:, None, None]) / ry[:, None, None]) ** 2) <= 1)
    labels = np.append(rng.randint(0, 4, n - 1), -1).astype(np.float64)
    return img, masks.astype(np.float32), boxes, {'num_crowds': 1,
                                                  'labels': labels}


CONFIGS = {
    'yolact_base': dict(),
    'yolact_darknet53': dict(backbone='yolact_darknet53'),
    'yolact_vgg16': dict(backbone='yolact_vgg16'),
    'flip_rot90': dict(augment_random_flip=True),
    'preserve_aspect_ratio': dict(preserve_aspect_ratio=True),
}


@pytest.mark.parametrize('name', CONFIGS)
def test_ssd_augmentation_matches_jax(name, cv2_generic):
    kw = dict(CONFIGS[name])
    cfg = tiny_resnet_config().copy(max_size=96)
    if 'backbone' in kw:
        cfg = cfg.copy(backbone=cfg.backbone.copy(
            transform=J.get_config(kw.pop('backbone')).backbone.transform))
    cfg = cfg.copy(**kw)
    perm = ['BGR'.index(c) for c in cfg.backbone.transform.channel_order]
    std = np.float32(STD)[perm] if cfg.backbone.transform.normalize else 1.0
    data = np.random.RandomState(3)
    for seed, (h, w) in enumerate(((60, 80), (80, 60), (70, 70), (45, 90),
                                   (96, 96), (33, 47))):
        img, masks, boxes, labels = _sample(data, h, w)
        got = aug.SSDAugmentation(P(cfg), rng=np.random.RandomState(seed))(
            img.copy(), masks.copy(), boxes.copy(), dict(labels))
        want = jax_aug.SSDAugmentation(cfg, rng=np.random.RandomState(seed))(
            img.copy(), masks.copy(), boxes.copy(), dict(labels))
        assert got[0].shape == want[0].shape and got[0].dtype == np.float32
        assert np.abs((got[0] - want[0]) * std).max() <= 1e-3, (name, seed)
        assert got[1].shape == want[1].shape
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3]['labels'], want[3]['labels'])
        assert got[3]['num_crowds'] == want[3]['num_crowds']


def test_base_transform_matches_jax(cv2_generic):
    rng = np.random.RandomState(4)
    for max_size, preserve in ((96, False), (550, False), (64, True)):
        cfg = tiny_resnet_config(preserve_aspect_ratio=preserve).copy(
            max_size=max_size)
        for h, w in ((60, 80), (1100, 1100), (37, 51)):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            got = aug.BaseTransform(P(cfg))(img)[0]
            want = jax_aug.BaseTransform(cfg)(img)[0]
            np.testing.assert_array_equal(got, want)


def test_transforms_import_no_cv2():
    """The transforms and the training modules load without cv2."""
    import subprocess
    import sys
    code = ('import sys\n'
            'sys.modules["cv2"] = None\n'
            'import yolact_tpu_torch.data.augmentations\n'
            'import yolact_tpu_torch.data.loader\n'
            'import yolact_tpu_torch.cli.train\n'
            'import yolact_tpu_torch.train.checkpoint\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
