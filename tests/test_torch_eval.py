"""The port's eval entry point (yolact_tpu_torch.eval, .cli.eval,
.train.checkpoint) against the JAX package's, on a tiny COCO set written
here, in float32 on the CPU.

Random weights give mAP near 0, so the detection lists are the real check:
the same number of detections per image and the same classes, scores
within 1e-5, bboxes within 1 px, binarised masks agreeing on >= 99.9% of
pixels (the port upsamples with F.interpolate, JAX with a separable matmul
that imitates it; they differ in the last bits), and the all_maps dicts
equal.  The traditional pipeline and forward_raw are held like the fast
one (tests/test_torch_pipeline.py): classes and validity identical, scores
and boxes within 1e-5, masks and mask_scores within 1e-4.  Each side gets
its own package's config (``P`` = ``config_from_jax``), and the CLI's tiny
config is registered in both packages' registries."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import SyntheticEvalSet, seed_offsets_jax
from yolact_tpu.config import register_config as jax_register_config
from yolact_tpu.data import rle as rle_codec
from yolact_tpu.eval.evaluate import evaluate_dataset as jax_evaluate_dataset
from yolact_tpu.eval.evaluator import calc_map
from yolact_tpu.eval.traditional import \
    TraditionalPipeline as JaxTraditionalPipeline
from yolact_tpu.infer import forward_raw as jax_forward_raw
from yolact_tpu.infer import random_variables
from yolact_tpu.models.yolact import MaskIoUHead
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu.ops.resize import resize_bilinear_torch_np
from yolact_tpu.train.checkpoint import load_weights as jax_load_weights
from yolact_tpu_torch.cli import eval as cli
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.from_jax import (config_from_jax as P,
                                               jax_variables_to_state_dict)
from yolact_tpu_torch.detect.postprocess import (finish_masks,
                                                 upsample_masks_device)
from yolact_tpu_torch.eval.evaluate import (evaluate_dataset,
                                            make_eval_dataset)
from yolact_tpu_torch.eval.traditional import TraditionalPipeline
from yolact_tpu_torch.infer import forward_raw, load_model
from yolact_tpu_torch.train.checkpoint import load_weights

torch.set_num_threads(2)

CFG_NAME = 'tinyporteval'


def _write_tiny_coco(root, sizes=((64, 64), (80, 96), (64, 64))):
    """Images (h, w) with two boxes and polygon masks each, classes 1-2."""
    import cv2
    img_dir = root / 'images'
    img_dir.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        img_id = 100 + i
        cv2.imwrite(str(img_dir / f'{img_id:012d}.jpg'),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
        images.append({'id': img_id, 'file_name': f'{img_id:012d}.jpg',
                       'width': w, 'height': h})
        for k in range(2):
            x, y = int(rng.randint(0, w // 2)), int(rng.randint(0, h // 2))
            bw, bh = int(rng.randint(8, w // 2)), int(rng.randint(8, h // 2))
            annotations.append({
                'id': len(annotations) + 1, 'image_id': img_id,
                'category_id': 1 + k, 'bbox': [x, y, bw, bh],
                'area': bw * bh, 'iscrowd': 0,
                'segmentation': [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
    info = {'images': images, 'annotations': annotations,
            'categories': [{'id': 1, 'name': 'thing'}, {'id': 2, 'name': 'b'}]}
    (root / 'instances.json').write_text(json.dumps(info))
    return str(img_dir), str(root / 'instances.json')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """(cfg, JAX variables, the port's state dict, eval dataset)."""
    root = tmp_path_factory.mktemp('coco')
    img_dir, json_path = _write_tiny_coco(root)
    cfg = tiny_resnet_config()
    cfg = cfg.copy(name=CFG_NAME, dataset=cfg.dataset.copy(
        valid_images=img_dir, valid_info=json_path,
        class_names=('thing', 'b', 'c', 'd'), label_map=None))
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=3))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    return (cfg, v, jax_variables_to_state_dict(P(cfg), v),
            make_eval_dataset(P(cfg)))


def _read(path):
    with open(path) as f:
        return json.load(f)


def _mask(det):
    return rle_codec.rle_to_mask({'size': det['segmentation']['size'],
                                  'counts':
                                      det['segmentation']['counts'].encode()})


def _assert_json_match(want_dir, got_dir):
    want_b, got_b = (_read(os.path.join(d, 'bbox.json'))
                     for d in (want_dir, got_dir))
    assert len(want_b) == len(got_b) > 0
    for key in ('image_id', 'category_id'):
        assert [d[key] for d in got_b] == [d[key] for d in want_b], key
    np.testing.assert_allclose([d['score'] for d in got_b],
                               [d['score'] for d in want_b], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose([d['bbox'] for d in got_b],
                               [d['bbox'] for d in want_b], rtol=0, atol=1.0)
    want_m, got_m = (_read(os.path.join(d, 'mask.json'))
                     for d in (want_dir, got_dir))
    assert len(want_m) == len(got_m) == len(want_b)
    agree = total = 0
    for g, w in zip(got_m, want_m):
        assert g['image_id'] == w['image_id']
        assert g['category_id'] == w['category_id']
        assert g['segmentation']['size'] == w['segmentation']['size']
        agree += int((_mask(g) == _mask(w)).sum())
        total += _mask(w).size
    assert agree >= 0.999 * total, (agree, total)


@pytest.mark.parametrize('stem_s2d', [False, True], ids=['plain', 's2d'])
@pytest.mark.parametrize('fast_nms', [True, False], ids=['fast', 'trad'])
def test_evaluate_dataset_matches_jax(setup, tmp_path, fast_nms, stem_s2d):
    cfg, v, sd, dataset = setup
    cfg = cfg.copy(stem_s2d=stem_s2d)
    kw = dict(fast_nms=fast_nms, quiet=True)
    want = jax_evaluate_dataset(cfg, v, dataset, **kw)
    # the port in batches of 2: the last batch is padded
    got = evaluate_dataset(P(cfg), sd, dataset, 'cpu', eval_batch_size=2,
                           **kw)
    assert got == want
    for side in ('jax', 'port'):
        os.makedirs(tmp_path / side)
    files = {side: dict(bbox_det_file=str(tmp_path / side / 'bbox.json'),
                        mask_det_file=str(tmp_path / side / 'mask.json'))
             for side in ('jax', 'port')}
    jax_evaluate_dataset(cfg, v, dataset, output_coco_json=True,
                         **files['jax'], **kw)
    evaluate_dataset(P(cfg), sd, dataset, 'cpu', output_coco_json=True,
                     **files['port'], **kw)
    _assert_json_match(tmp_path / 'jax', tmp_path / 'port')


def _plus_setup():
    cfg = tiny_plus_config()
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=3))
    v = seed_offsets_jax({'params': v['params'],
                          'batch_stats': v['batch_stats']}, seed=4)
    miou = jax.tree_util.tree_map(np.array, dict(MaskIoUHead(cfg).init(
        jax.random.PRNGKey(9), jnp.zeros((1, 32, 32, 1)))))
    return cfg, v, miou, jax_variables_to_state_dict(
        P(cfg), dict(v, maskiou=miou))


@pytest.mark.parametrize('case', ['plain', 's2d', 'plus'])
def test_traditional_pipeline_matches_jax(setup, case):
    """Raw frames through the traditional pipelines; for tiny-plus with
    the maskiou re-scoring."""
    if case == 'plus':
        cfg, v, miou, sd = _plus_setup()
    else:
        cfg, v, sd, _ = setup
        cfg, miou = cfg.copy(stem_s2d=case == 's2d'), None
    frames = np.random.RandomState(7).randint(
        0, 256, (2, 128, 128, 3)).astype(np.float32)
    want = JaxTraditionalPipeline(cfg, v, preprocess=True,
                                  maskiou_variables=miou)(frames)
    got = TraditionalPipeline(P(cfg), sd, 'cpu', preprocess=True)(frames)
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(want.masks),
                               rtol=0, atol=1e-4)
    if case == 'plus':
        np.testing.assert_allclose(got.mask_scores.numpy()[valid],
                                   np.asarray(want.mask_scores)[valid],
                                   rtol=0, atol=1e-4)
    else:
        assert got.mask_scores is None and want.mask_scores is None


@pytest.mark.parametrize('stem_s2d', [False, True], ids=['plain', 's2d'])
def test_forward_raw_matches_jax(setup, stem_s2d):
    cfg, v, sd, _ = setup
    cfg = cfg.copy(stem_s2d=stem_s2d)
    frames = np.random.RandomState(8).randint(
        0, 256, (2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jax_forward_raw(cfg, JaxYolact(cfg), v, x))(
        v, jnp.asarray(frames))
    model = load_model(P(cfg), sd, torch.device('cpu'), 'float32')
    with torch.no_grad():
        got = forward_raw(P(cfg), model, torch.from_numpy(frames))
    for name, g, w, tol in zip(('boxes', 'scores', 'coeffs', 'proto'), got,
                               want, (1e-5, 1e-5, 1e-4, 1e-4)):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=name)


def test_finish_masks_matches_jax(rng):
    """The port's upsample (F.interpolate) against JAX's host imitation of
    it, before and after binarising."""
    from yolact_tpu.detect.postprocess import finish_masks as jax_finish
    masks = rng.rand(5, 32, 32).astype(np.float32)
    for w, h in ((64, 64), (96, 80), (31, 50)):
        up = upsample_masks_device(torch.from_numpy(masks)[None], (h, w),
                                   binarize=False)[0]
        np.testing.assert_allclose(up.numpy(),
                                   resize_bilinear_torch_np(masks, (h, w)),
                                   rtol=0, atol=1e-5)
        got = finish_masks(torch.from_numpy(masks), w, h)
        want = jax_finish(masks, w, h)
        assert got.dtype == want.dtype == bool and got.shape == (5, h, w)
        assert (got == want).mean() >= 0.999
    assert finish_masks(torch.zeros(0, 32, 32), 7, 5).shape == (0, 5, 7)


def _write_pth(cfg, sd, path, wrap):
    """The port's weights as a reference-style .pth, with what real files
    carry and the port drops: num_batches_tracked, a legacy backbone.layer
    key and FPN downsample layers beyond num_downsample."""
    sd = dict(sd)
    sd['backbone.bn1.num_batches_tracked'] = torch.tensor(7)
    sd['backbone.layer1.0.conv1.weight'] = torch.zeros(1)
    n = cfg.fpn.num_downsample
    sd[f'fpn.downsample_layers.{n}.weight'] = torch.zeros(16, 16, 3, 3)
    sd[f'fpn.downsample_layers.{n}.bias'] = torch.zeros(16)
    torch.save({'state_dict': sd} if wrap else sd, path)
    return path


@pytest.mark.parametrize('wrap', [False, True], ids=['bare', 'state_dict'])
def test_load_weights_pth(setup, tmp_path, wrap):
    cfg, _, sd, _ = setup
    path = _write_pth(cfg, sd, str(tmp_path / 'w_1_2.pth'), wrap)
    got = load_weights(P(cfg), path)
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    load_model(P(cfg), got, torch.device('cpu'))       # strict
    with pytest.raises(NotImplementedError, match='A4'):
        load_weights(P(cfg), str(tmp_path / 'w_1_2.ckpt'))


@pytest.fixture(scope='module')
def pth(setup, tmp_path_factory):
    cfg, _, sd, _ = setup
    jax_register_config(cfg)        # for JAX's evaluation of the same file
    register_config(P(cfg))         # for the port's CLI
    path = tmp_path_factory.mktemp('weights') / f'{CFG_NAME}_1_100.pth'
    return _write_pth(cfg, sd, str(path), wrap=True)


def _main(pth, tmp_path, *flags):
    cli.main([f'--trained_model={pth}', '--cuda=False', '--no_bar',
              f'--ap_data_file={tmp_path}/ap.pkl',
              f'--bbox_det_file={tmp_path}/bbox.json',
              f'--mask_det_file={tmp_path}/mask.json', *flags])


@pytest.mark.parametrize('flags', [[], ['--fast_nms=False'], ['--stem_s2d'],
                                   ['--eval_batch_size=2', '--stem_s2d',
                                    '--fast_nms=False']],
                         ids=['fast', 'trad', 's2d', 'b2_s2d_trad'])
def test_cli_dataset_map_and_resume(setup, pth, tmp_path, capsys, flags):
    """Dataset mAP from the .pth, the same table as JAX's evaluation of
    the same file, then --resume from the saved AP data."""
    cfg, _, _, dataset = setup
    _main(pth, tmp_path, *flags)
    table = capsys.readouterr().out
    assert f'Parsed {CFG_NAME}_config' in table and '|  all  |' in table
    want = jax_evaluate_dataset(
        cfg.copy(stem_s2d='--stem_s2d' in flags),
        jax_load_weights(cfg, pth), dataset, quiet=True,
        fast_nms='--fast_nms=False' not in flags)
    with open(tmp_path / 'ap.pkl', 'rb') as f:
        assert calc_map(pickle.load(f), cfg.dataset.class_names,
                        print_table=False) == want
    _main(pth, tmp_path, '--resume')
    assert capsys.readouterr().out.count('|  all  |') == 1


def test_cli_coco_json_and_benchmark(setup, pth, tmp_path, capsys):
    _main(pth, tmp_path, '--output_coco_json', '--output_web_json',
          f'--web_det_path={tmp_path}/web')
    dets = _read(tmp_path / 'bbox.json')
    assert {d['image_id'] for d in dets} == {100, 101, 102}
    assert len(_read(tmp_path / 'mask.json')) == len(dets)
    assert os.path.exists(tmp_path / 'web' / f'{CFG_NAME}.json')
    capsys.readouterr()
    _main(pth, tmp_path, '--benchmark', '--max_images=3')
    out = capsys.readouterr().out
    assert 'ms / frame' in out and 'fps' in out


@pytest.mark.parametrize('flags', [[], ['--fast_nms=False', '--stem_s2d']],
                         ids=['fast', 's2d_trad'])
def test_cli_images(setup, pth, tmp_path, flags):
    import cv2
    inp = tmp_path / 'in'
    inp.mkdir()
    rng = np.random.RandomState(5)
    for name, hw in (('a.png', (90, 120)), ('b.png', (128, 128))):
        cv2.imwrite(str(inp / name),
                    (rng.rand(*hw, 3) * 255).astype(np.uint8))
    _main(pth, tmp_path, f'--images={inp}:{tmp_path}/out', *flags)
    assert sorted(os.listdir(tmp_path / 'out')) == ['a.png', 'b.png']
    _main(pth, tmp_path, f'--image={inp}/a.png:{tmp_path}/a_out.png',
          '--display_lincomb=True', *flags)
    assert cv2.imread(str(tmp_path / 'a_out.png')).shape == (90, 120, 3)
    assert os.path.exists(inp / 'a_lincomb.png')


@pytest.mark.parametrize('flags', [['--video=in.mp4'], ['--eval_devices=2'],
                                   ['--eval_devices=0']])
def test_cli_unported_modes_raise(pth, tmp_path, flags):
    with pytest.raises(NotImplementedError, match='A9'):
        _main(pth, tmp_path, *flags)


def test_cli_cuda_without_a_card_raises(pth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; this checks the no-GPU error')
    with pytest.raises(RuntimeError, match='cuda'):
        cli.main([f'--trained_model={pth}', '--cuda=True'])


@pytest.mark.parametrize('kw,match', [({'n_devices': 2}, 'A9'),
                                      ({'device_mask_iou': True}, 'A5')])
def test_evaluate_unported_options_raise(setup, kw, match):
    cfg, _, sd, dataset = setup
    with pytest.raises(NotImplementedError, match=match):
        evaluate_dataset(P(cfg), sd, dataset, 'cpu', quiet=True, **kw)


def test_evaluate_prefetch_error_propagates(setup):
    cfg, _, sd, dataset = setup
    orig = dataset.pull_item

    def bad_pull(idx):
        if idx == 1:
            raise IOError('corrupt image')
        return orig(idx)

    dataset.pull_item = bad_pull
    try:
        with pytest.raises(RuntimeError, match='eval prefetch failed'):
            evaluate_dataset(P(cfg), sd, dataset, 'cpu', quiet=True)
    finally:
        dataset.pull_item = orig


def test_synthetic_eval_set_matches_jax(setup):
    """The in-memory dataset of the card's eval runs, through both
    evaluators: equal all_maps."""
    cfg, v, sd, _ = setup
    data = SyntheticEvalSet(4, cfg.max_size, cfg.num_classes, seed=2)
    want = jax_evaluate_dataset(cfg, v, data, quiet=True)
    got = evaluate_dataset(P(cfg), sd, data, 'cpu', eval_batch_size=4,
                           quiet=True)
    assert got == want
