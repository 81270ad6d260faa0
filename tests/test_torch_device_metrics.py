"""Mask IoU on the device (``yolact_tpu_torch/eval/device_metrics.py``)
against the JAX package's ``eval/device_metrics.py`` and against the port's
own host path, and ``evaluate_dataset`` with ``device_mask_iou``, on the
CPU (the function runs wherever its masks are).

Tolerances: the port's IoU matrices equal its host path's
(``finish_masks`` + ``evaluator._np_mask_iou``) exactly, since both
binarise the same ``F.interpolate`` output and count in float32; JAX's
within 1e-4 (its separable upsample into a fixed canvas and the fused one
may put a value at the 0.5 threshold on either side).  The mAP tables of
the two eval paths are equal, on detections crafted from the gt so that
they are not 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from test_torch_inputs import OraclePipeline, SizedEvalSet
from yolact_tpu.eval import device_metrics as jax_dm
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.detect.postprocess import finish_masks
from yolact_tpu_torch.eval import evaluate
from yolact_tpu_torch.eval.device_metrics import mask_iou_device
from yolact_tpu_torch.eval.evaluator import _np_mask_iou
from yolact_tpu_torch.infer import random_state_dict

torch.set_num_threads(2)


def _inputs(rng, d, g, hp, wp, h, w):
    """D sigmoid-like masks [D, hp, wp] (one all zero, one cropped to a
    box) and G gt masks [G, h, w] (rectangles, one empty)."""
    pred = rng.rand(d, hp, wp).astype(np.float32)
    if d:
        pred[0] = 0.0
    if d > 1:
        pred[1, :, : wp // 3] = 0.0
    gt = np.zeros((g, h, w), np.float32)
    for i in range(g):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        gt[i, y0:y0 + rng.randint(1, h // 2 + 1),
           x0:x0 + rng.randint(1, w // 2 + 1)] = 1.0
    if g > 2:
        gt[2] = 0.0
    return pred, gt


def _host(pred, gt, h, w):
    """The host path of evaluate_dataset: finish_masks, then the
    evaluator's IoU (union and crowd)."""
    full = finish_masks(torch.from_numpy(pred), w, h).reshape(
        len(pred), h * w).astype(np.float32)
    g = gt.reshape(len(gt), h * w)
    return _np_mask_iou(full, g), _np_mask_iou(full, g, iscrowd=True), \
        full.sum(1)


@pytest.mark.parametrize('hp,wp,h,w', [
    (32, 32, 24, 40),      # smaller than the prototypes, h != w
    (32, 32, 57, 31),
    (32, 24, 138, 96),     # larger
    (20, 20, 200, 333),
    (32, 32, 32, 32),      # the prototypes' own size
], ids=['24x40', '57x31', '138x96', '200x333', '32x32'])
def test_mask_iou_device_matches_jax_and_host(rng, hp, wp, h, w):
    pred, gt = _inputs(rng, 7, 5, hp, wp, h, w)
    iou, crowd, area = mask_iou_device(torch.from_numpy(pred), gt, h, w)
    assert iou.shape == crowd.shape == (7, 5) and area.shape == (7,)
    assert iou.dtype == crowd.dtype == torch.float32
    want_iou, want_crowd, want_area = _host(pred, gt, h, w)
    np.testing.assert_array_equal(iou.numpy(), want_iou)
    np.testing.assert_array_equal(crowd.numpy(), want_crowd)
    np.testing.assert_array_equal(area.numpy(), want_area)
    assert float(area[0]) == 0 and (iou.numpy()[0] == 0).all()
    assert (iou.numpy()[:, 2] == 0).all()               # the empty gt
    assert (iou.numpy() > 0).sum() >= 5
    assert (crowd.numpy() >= iou.numpy()).all()
    canvas = -(-max(h, w) // 64) * 64
    j_iou, j_crowd, j_area = jax_dm.mask_iou_device(
        jnp.asarray(pred), jnp.asarray(jax_dm.gt_to_canvas(gt, canvas)),
        np.float32(h), np.float32(w), canvas)
    np.testing.assert_allclose(iou.numpy(), np.asarray(j_iou), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(crowd.numpy(), np.asarray(j_crowd), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(area.numpy(), np.asarray(j_area), rtol=0,
                               atol=1)


@pytest.mark.parametrize('d,g', [(4, 0), (0, 3), (0, 0)],
                         ids=['no_gt', 'no_pred', 'neither'])
def test_mask_iou_device_empty(rng, d, g):
    pred, gt = _inputs(rng, d, g, 16, 16, 30, 20)
    iou, crowd, area = mask_iou_device(torch.from_numpy(pred), gt, 30, 20)
    assert iou.shape == crowd.shape == (d, g) and area.shape == (d,)
    want_iou, want_crowd, _ = _host(pred, gt, 30, 20)
    np.testing.assert_array_equal(iou.numpy(), want_iou)
    np.testing.assert_array_equal(crowd.numpy(), want_crowd)


def test_mask_iou_device_counts_are_exact(rng):
    """Areas far above 2048 (where a float16 sum would round) count exactly:
    a 300x400 gt against its own full-image prediction."""
    pred = np.ones((2, 8, 8), np.float32)
    pred[1] = 0.25
    gt = np.ones((2, 300, 400), np.float32)
    gt[1, :, 200:] = 0
    iou, crowd, area = mask_iou_device(torch.from_numpy(pred), gt, 300, 400)
    assert area.tolist() == [120000.0, 0.0]
    assert iou[0].tolist() == [1.0, 0.5] and crowd[0].tolist() == [1.0, 0.5]
    assert iou[1].tolist() == [0.0, 0.0]


def test_mask_iou_device_rejects_a_gt_of_another_size(rng):
    pred, gt = _inputs(rng, 2, 2, 8, 8, 10, 12)
    with pytest.raises(ValueError, match='not'):
        mask_iou_device(torch.from_numpy(pred), gt, 12, 10)


SIZES = ((120, 160), (160, 120), (107, 160))


@pytest.fixture(scope='module')
def oracle_setup():
    cfg = P(tiny_resnet_config())
    data = SizedEvalSet(10, SIZES, cfg.max_size, cfg.num_classes, seed=3)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    return cfg, data, sd


def _oracle_eval(monkeypatch, cfg, data, sd, **kw):
    """evaluate_dataset with the pipeline answering from the gt; returns
    (all_maps, number of mask_iou_device calls)."""
    calls = []
    monkeypatch.setattr(evaluate, 'Pipeline', lambda *a, **k: OraclePipeline(
        data, cfg, (32, 32)))
    real = evaluate.mask_iou_device

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(evaluate, 'mask_iou_device', counted)
    maps = evaluate.evaluate_dataset(cfg, sd, data, 'cpu', quiet=True,
                                     no_sort=True, **kw)
    return maps, len(calls)


@pytest.mark.parametrize('batch', [1, 4])
def test_evaluate_device_mask_iou_equals_host(monkeypatch, oracle_setup,
                                              batch):
    """The whole mAP table, box and mask, both ways: equal, and not 0."""
    cfg, data, sd = oracle_setup
    host, n_host = _oracle_eval(monkeypatch, cfg, data, sd,
                                eval_batch_size=batch, device_mask_iou=False)
    dev, n_dev = _oracle_eval(monkeypatch, cfg, data, sd,
                              eval_batch_size=batch, device_mask_iou=True)
    assert (n_host, n_dev) == (0, len(data))
    assert dev == host
    assert host['mask']['all'] > 10 and host['box']['all'] > 10


def test_evaluate_device_mask_iou_defaults_to_the_card(monkeypatch,
                                                       oracle_setup):
    """None picks the device path only on a CUDA device: on the CPU the
    host path runs, with the same table."""
    cfg, data, sd = oracle_setup
    maps, n = _oracle_eval(monkeypatch, cfg, data, sd, eval_batch_size=4)
    assert n == 0
    assert maps == _oracle_eval(monkeypatch, cfg, data, sd,
                                eval_batch_size=4, device_mask_iou=True)[0]


def test_evaluate_device_mask_iou_real_pipeline(oracle_setup):
    """The port's Pipeline and the traditional one, random weights (mAP
    0): the device and the host IoU give the same tables."""
    cfg, data, sd = oracle_setup
    for fast in (True, False):
        got = [evaluate.evaluate_dataset(cfg, sd, data, 'cpu', quiet=True,
                                         eval_batch_size=4, fast_nms=fast,
                                         device_mask_iou=flag)
               for flag in (True, False)]
        assert got[0] == got[1]
