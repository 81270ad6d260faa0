"""The port's horizon tool (yolact_tpu_torch/scripts/train_horizon.py)
against the JAX package's scripts/train_horizon.py, on the CPU.

- The synthetic set: JAX's ``make_dataset`` writes 4 images to a
  temporary directory while ``cv2.imwrite`` is replaced by a recorder that
  keeps each array before JPEG encoding; the port's in-memory set has the
  same instances dict exactly (annotations, categories, image entries),
  every image equal to JAX's array pixel for pixel, and every mask equal to
  what JAX's loader rasterises with ``cv2.fillPoly``: 0 differing pixels,
  where a differing pixel would lie on a polygon edge.  The channel order
  is the BGR that ``cv2.imread`` gives of JAX's file, up to JPEG.
- ``fill_polygon`` against ``cv2.fillPoly`` on random polygons, convex and
  self-intersecting, on one- and three-channel canvases: equal.
- The ``<config>_horizon`` config equals the one JAX's ``main`` registers,
  through ``config_from_jax``, and ``trainer_argv`` the argv it hands
  ``yolact_tpu.cli.train.train`` (caught by a monkeypatch).
- A tiny horizon on the CPU: two segments of 2 iterations, the second
  ``--resume latest``; the state the second segment starts from is the
  first segment's final state bit for bit (weights, buffers, momentum,
  step), and ``--eval`` writes an mAP JSON with every key.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from test_torch_inputs import tiny_resnet_config
from yolact_tpu.data import rle as jax_rle
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.from_jax import config_from_jax
from yolact_tpu_torch.scripts import train_horizon as th
from yolact_tpu_torch.train import step as step_module

torch.set_num_threads(2)

N_IMAGES = 4


@pytest.fixture(scope='module')
def jax_set(tmp_path_factory):
    """JAX's set of N_IMAGES images: (its arrays before encoding by file
    name, its instances dict, its image directory)."""
    import scripts.train_horizon as jh
    seen = {}
    real = cv2.imwrite

    def record(path, img, *args):
        seen[os.path.basename(path)] = np.array(img)
        return real(path, img, *args)

    cv2.imwrite = record
    try:
        img_dir, json_path = jh.make_dataset(
            str(tmp_path_factory.mktemp('jax_horizon')), N_IMAGES)
    finally:
        cv2.imwrite = real
    with open(json_path) as f:
        info = json.load(f)
    return seen, info, img_dir


@pytest.fixture(scope='module')
def port_set():
    return th.make_dataset(N_IMAGES)


def test_annotations_and_categories_equal_jax(jax_set, port_set):
    _, want, _ = jax_set
    _, got = port_set
    assert got == want
    assert len(got['annotations']) >= 3 * N_IMAGES


def test_images_equal_jax_before_jpeg(jax_set, port_set):
    seen, info, _ = jax_set
    images, _ = port_set
    differing = 0
    for entry in info['images']:
        want, got = seen[entry['file_name']], images[entry['id']]
        assert got.shape == want.shape == (480, 640, 3)
        assert got.dtype == np.uint8
        differing += int((got != want).any(-1).sum())
    assert differing == 0


def test_masks_equal_jax_loader(port_set):
    images, info = port_set
    index = th.HorizonIndex(info)
    differing = 0
    for ann in info['annotations']:
        want = jax_rle.ann_to_mask(ann['segmentation'], 480, 640)
        got = index.ann_to_mask(ann, 480, 640)
        assert got.dtype == bool and got.any()
        differing += int((got != want).sum())
    assert differing == 0


def test_channels_are_what_imread_gives_of_jax_files(jax_set, port_set):
    """Up to JPEG: the mean error against the decoded file is small, and
    far below the error of the other channel order."""
    _, info, img_dir = jax_set
    images, _ = port_set
    for entry in info['images']:
        read = cv2.imread(os.path.join(img_dir, entry['file_name']))
        got = images[entry['id']].astype(np.float64)
        err = np.abs(read - got).mean()
        swapped = np.abs(read - got[:, :, ::-1]).mean()
        assert err < 8, err
        assert swapped > 2 * err, (err, swapped)


@pytest.mark.parametrize('channels', [1, 3])
def test_fill_polygon_matches_cv2(channels):
    rng = np.random.RandomState(channels)
    h, w = 60, 70
    for trial in range(300):
        k = rng.randint(3, 25)
        if trial % 2:
            pts = rng.rand(k, 2) * [w + 10, h + 10] - 5
        else:
            c, r = rng.randint(5, [w - 5, h - 5]), rng.randint(1, 40, 2)
            t = np.linspace(0, 2 * np.pi, k, endpoint=False)
            pts = np.stack([c[0] + r[0] * np.cos(t), c[1] + r[1] * np.sin(t)],
                           -1)
        pts = np.clip(np.round(pts), 0, [w - 1, h - 1]).astype(np.int32)
        shape = (h, w) if channels == 1 else (h, w, 3)
        value = 1 if channels == 1 else (235, 80, 60)
        want = cv2.fillPoly(np.zeros(shape, np.uint8), [pts], value)
        got = th.fill_polygon(np.zeros(shape, np.uint8), pts, value)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


@pytest.mark.parametrize('extra', [[], ['--lr', '0.002'],
                                   ['--resume', 'latest']],
                         ids=['fresh', 'lr', 'resume'])
def test_config_and_argv_equal_jax(tmp_path, monkeypatch, extra):
    import scripts.train_horizon as jh
    import yolact_tpu.cli.train as jax_train
    from yolact_tpu.config import get_config as jax_get_config
    caught = []
    monkeypatch.setattr(jax_train, 'train', caught.append)
    monkeypatch.setattr(jh, 'plot_log', lambda *a: None)
    data, out = str(tmp_path / 'data'), str(tmp_path / 'out')
    monkeypatch.setattr(sys, 'argv', [
        'train_horizon.py', 'yolact_plus_resnet50', '--iters', '1200',
        '--images', '2', '--data_dir', data, '--out_dir', out] + extra)
    jh.main()
    args = th.parse_args(['yolact_plus_resnet50', '--iters', '1200',
                          '--out_dir', out, '--save_folder', 'weights/']
                         + extra)
    assert caught == [th.trainer_argv(args)]
    want = jax_get_config('yolact_plus_resnet50_horizon')
    assert config_from_jax(want) == th.horizon_config(
        'yolact_plus_resnet50', 1200, data)


def test_trainer_argv_on_the_cpu():
    args = th.parse_args(['yolact_base', '--cuda', 'False'])
    argv = th.trainer_argv(args)
    assert argv[-2:] == ['--cuda', 'False']
    assert argv[argv.index('--save_folder') + 1] == th.SAVE_FOLDER
    assert argv[argv.index('--log_folder') + 1] == os.path.join(
        th.OUT_DIR, 'horizon_logs')


def test_loss_blocks_of_jax_log():
    """JAX's committed yolact_plus_resnet50 log: 12 blocks of 200
    iterations, 20 entries each, the five letters and their total."""
    blocks = th.loss_blocks(th.JAX_LOG.format('yolact_plus_resnet50'))
    assert [(b[0], b[1], b[3]) for b in blocks] == [
        (200 * k + 1, 200 * (k + 1), 20) for k in range(12)]
    assert sorted(blocks[-1][2]) == ['B', 'C', 'I', 'M', 'S', 'total']
    assert blocks[-1][2]['total'] < blocks[0][2]['total']


def states_equal(a, b):
    """(weights and buffers, momentum, step) bit-equal between two train
    states (chip_smoke.py's check)."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    weights = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                             for k in sa)
    ma, mb = ({k: s.optimizer.state[p]['momentum_buffer']
               for k, p in s.model.named_parameters()
               if p in s.optimizer.state} for s in (a, b))
    momentum = bool(ma) and ma.keys() == mb.keys() and all(
        torch.equal(ma[k], mb[k]) for k in ma)
    return weights, momentum, a.step == b.step


def _tiny_horizon_config():
    """A tiny yolact_base with the horizon's 8 categories as its classes."""
    cfg = tiny_resnet_config()
    names = tuple(f'{s}_{c}' for s in th.SHAPES for c in ('warm', 'cool'))
    return register_config(cfg.copy(
        name='tinyhorizon', num_classes=len(names) + 1,
        dataset=cfg.dataset.copy(class_names=names, label_map=None)))


def test_tiny_horizon_resumes_bit_equal_and_evaluates(tmp_path, monkeypatch,
                                                      capsys):
    _tiny_horizon_config()
    out, save = str(tmp_path / 'out'), str(tmp_path / 'weights') + '/'
    flags = ['--images', '8', '--batch', '8', '--cuda', 'False',
             '--out_dir', out, '--save_folder', save]
    first = th.main(['tinyhorizon', '--iters', '2'] + flags)
    assert first['iteration'] == 2 and first['start_iter'] == 0
    saved = first['path']
    assert os.path.exists(saved)

    starts = []
    real = step_module.train_step

    def watch(state, batch, generator):
        if not starts:
            starts.append(states_equal(state, first['state']))
        return real(state, batch, generator)

    monkeypatch.setattr(step_module, 'train_step', watch)
    second = th.main(['tinyhorizon', '--iters', '4', '--resume', 'latest']
                     + flags)
    assert second['start_iter'] == 2 and second['iteration'] == 4
    assert starts == [(True, True, True)]
    with open(os.path.join(out, 'horizon_tinyhorizon_2_4.json')) as f:
        report = json.load(f)
    assert report['start'] == 2 and report['end'] == 4
    assert report['wall_s'] > 0 and report['ms_per_iter_median'] > 0

    maps = th.main(['tinyhorizon', '--eval', second['path']] + flags
                   + ['--images', '4'])
    with open(os.path.join(out, 'horizon_map_tinyhorizon_4.json')) as f:
        written = json.load(f)
    assert written['checkpoint'] == os.path.basename(second['path'])
    assert set(written['maps']) == {'box', 'mask'}
    for t in ('box', 'mask'):
        assert set(written['maps'][t]) == {'all'} | {
            str(x) for x in range(50, 100, 5)}
        assert written['maps'][t]['all'] == maps[t]['all']
