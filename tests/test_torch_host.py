"""The port's copies of the JAX package's host modules (data/rle.py,
data/coco.py, data/augmentations.py:BaseTransform, eval/evaluator.py,
eval/coco_json.py, eval/traditional.py's host NMS, native/, utils/) against
the originals on the same seeded inputs.  Equal outputs throughout: the
code is copied, and both run the same numpy (and the same native helper
source) on the CPU."""

import json

import numpy as np
import pytest

from yolact_tpu import config as J
from yolact_tpu.data import augmentations as jax_aug
from yolact_tpu.data import coco as jax_coco
from yolact_tpu.data import rle as jax_rle
from yolact_tpu.eval import coco_json as jax_coco_json
from yolact_tpu.eval import evaluator as jax_evaluator
from yolact_tpu.eval import traditional as jax_traditional
from yolact_tpu.utils import functions as jax_functions
from yolact_tpu_torch import config as C
from yolact_tpu_torch import native
from yolact_tpu_torch.data import augmentations, coco, rle
from yolact_tpu_torch.eval import coco_json, evaluator, traditional
from yolact_tpu_torch.utils import functions, timer


@pytest.fixture(params=['native', 'numpy'])
def codec(request, monkeypatch):
    """Both codec paths of each package: the native helper, and numpy."""
    if request.param == 'numpy':
        monkeypatch.setattr(rle, 'get_native', lambda: None)
        monkeypatch.setattr(jax_rle, 'get_native', lambda: None)
        monkeypatch.setattr(traditional, 'get_native', lambda: None)
        monkeypatch.setattr(jax_traditional, 'get_native', lambda: None)
    else:
        assert native.get_native() is not None     # g++ builds it here
    return request.param


def test_native_helper_builds_into_the_port(tmp_path, monkeypatch):
    lib = native.get_native()
    assert lib is not None
    assert native.BUILD_DIR.endswith('yolact_tpu_torch/_build/native')
    keep = lib.greedy_nms(np.array([[0, 0, 10, 10, .9], [1, 1, 10, 10, .8],
                                    [20, 20, 30, 30, .7]], np.float32), 0.5)
    assert sorted(keep.tolist()) == [0, 2]
    # no source: the numpy versions serve
    monkeypatch.setattr(native, 'SOURCE', str(tmp_path / 'missing.cpp'))
    assert native._build() is None


def test_badhash_matches_jax(rng):
    for x in rng.randint(0, 2 ** 31, 200).tolist() + [0, 1, 581929]:
        assert evaluator.badhash(x) == jax_evaluator.badhash(x)


def _masks(rng, n=6, h=37, w=29):
    m = rng.rand(n, h, w) > 0.6
    m[0] = False
    m[1] = True
    m[2, :, :3] = True
    return m


def test_rle_matches_jax(rng, codec):
    for m in _masks(rng):
        got, want = rle.mask_to_rle(m), jax_rle.mask_to_rle(m)
        assert got == want
        assert np.array_equal(rle.rle_to_mask(got), m)
        assert np.array_equal(rle.decode_counts(got['counts']),
                              jax_rle.decode_counts(want['counts']))
        raw = {'size': got['size'],
               'counts': rle.decode_counts(got['counts']).tolist()}
        assert np.array_equal(rle.ann_to_mask(raw, *m.shape), m)
    counts = rng.randint(0, 300, 50).astype(np.uint32)
    assert rle.encode_counts(counts) == jax_rle.encode_counts(counts)
    poly = [[2, 3, 20, 4, 18, 25, 4, 22], [1, 1, 2, 2]]
    assert np.array_equal(rle.ann_to_mask(poly, 30, 24),
                          jax_rle.ann_to_mask(poly, 30, 24))
    with pytest.raises(ValueError, match='exceed'):
        rle.rle_to_mask({'size': [2, 2], 'counts': [1, 9]})


def _dets(rng, n=60, num_classes=5, p=200):
    boxes = np.sort(rng.rand(p, 4), axis=-1)[:, [0, 2, 1, 3]].astype(
        np.float32)
    coeffs = rng.randn(p, 8).astype(np.float32)
    scores = rng.rand(num_classes - 1, p).astype(np.float32) ** 3
    return boxes, coeffs, scores


def test_traditional_nms_matches_jax(rng, codec):
    cfg = J.get_config('yolact_base').copy(num_classes=5, max_size=128)
    for _ in range(3):
        boxes, coeffs, scores = _dets(rng)
        got = traditional.traditional_nms(
            C.get_config('yolact_base').copy(num_classes=5, max_size=128),
            boxes, coeffs, scores)
        want = jax_traditional.traditional_nms(cfg, boxes, coeffs, scores)
        assert len(got[3]) > 0
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        proto = rng.rand(16, 16, 8).astype(np.float32)
        for crop in (True, False):
            assert np.array_equal(
                traditional.host_assemble_masks(proto, got[1], got[0],
                                                crop=crop),
                jax_traditional.host_assemble_masks(proto, want[1], want[0],
                                                    crop=crop))


def _ap_images(rng, n=4, num_classes=4):
    """Per image: detections, gt (crowds last) and masks."""
    for i in range(n):
        h, w = 40 + 3 * i, 50
        n_gt, crowd, n_det = rng.randint(1, 5), i % 2, rng.randint(0, 9)
        gt_masks = rng.rand(n_gt + crowd, h, w) > 0.5
        gt_boxes = np.sort(rng.rand(n_gt + crowd, 4) * 40, -1)[:, [0, 2, 1, 3]]
        gt_classes = rng.randint(0, num_classes, n_gt + crowd)
        det_masks = rng.rand(n_det, h, w) > 0.5
        det_boxes = np.sort(rng.rand(n_det, 4) * 40, -1)[:, [0, 2, 1, 3]]
        classes = rng.randint(0, num_classes, n_det)
        # some detections are near copies of gt: true positives
        hits = min(n_det, n_gt)
        det_boxes[:hits] = gt_boxes[:hits] + rng.rand(hits, 4)
        det_masks[:hits] = gt_masks[:hits]
        det_masks[:hits, :2] = ~det_masks[:hits, :2]
        classes[:hits] = gt_classes[:hits]
        yield dict(classes=classes,
                   box_scores=rng.rand(n_det), mask_scores=rng.rand(n_det),
                   boxes=det_boxes, masks=det_masks, gt_boxes=gt_boxes,
                   gt_classes=gt_classes, gt_masks=gt_masks, num_crowd=crowd)


def test_prep_metrics_and_calc_map_match_jax(rng):
    names = ('a', 'b', 'c', 'd')
    ours, theirs = evaluator.make_ap_data(4), jax_evaluator.make_ap_data(4)
    for image in _ap_images(rng):
        evaluator.prep_metrics(ours, **image)
        jax_evaluator.prep_metrics(theirs, **image)
    got = evaluator.calc_map(ours, names, print_table=False)
    assert got == jax_evaluator.calc_map(theirs, names, print_table=False)
    assert got['box']['all'] > 0 and got['mask']['all'] > 0


def test_detections_writer_matches_jax(rng, tmp_path):
    jax_cfg = J.get_config('yolact_base')
    files = {}
    for side, writer in (('port', coco_json.DetectionsWriter(
            C.get_config('yolact_base'))),
            ('jax', jax_coco_json.DetectionsWriter(jax_cfg))):
        for i, m in enumerate(_masks(np.random.RandomState(3))):
            writer.add_bbox(7 + i, i % 80, [1.26, 2.0, 9.94, 7.5], 0.5 - i / 9)
            writer.add_mask(7 + i, i % 80, m, 0.4 - i / 9)
        (tmp_path / side).mkdir()
        writer.dump(str(tmp_path / side / 'bbox.json'),
                    str(tmp_path / side / 'mask.json'))
        writer.dump_web(str(tmp_path / side / 'web'))
        files[side] = [json.loads((tmp_path / side / f).read_text())
                       for f in ('bbox.json', 'mask.json',
                                 'web/yolact_base.json')]
    assert files['port'] == files['jax']
    assert files['port'][0][0]['category_id'] == 1


def _write_coco(root, rng):
    import cv2
    images, anns = [], []
    for i, (h, w) in enumerate(((40, 52), (61, 45))):
        cv2.imwrite(str(root / f'{i:012d}.jpg'),
                    (rng.rand(h, w, 3) * 255).astype(np.uint8))
        images.append({'id': i, 'file_name': f'{i:012d}.jpg', 'width': w,
                       'height': h})
        for k in range(3):
            x, y = int(rng.randint(0, w // 2)), int(rng.randint(0, h // 2))
            anns.append({'id': len(anns) + 1, 'image_id': i,
                         'category_id': 1 + k, 'bbox': [x, y, 9, 8],
                         'iscrowd': int(k == 2),
                         'segmentation': [[x, y, x + 9, y, x + 9, y + 8]]})
    path = root / 'instances.json'
    path.write_text(json.dumps({'images': images, 'annotations': anns,
                                'categories': [{'id': k} for k in (1, 2, 3)]}))
    return str(path)


def test_coco_dataset_and_base_transform_match_jax(rng, tmp_path):
    info = _write_coco(tmp_path, rng)
    cfg = J.get_config('yolact_base').copy(max_size=64)
    port_cfg = C.get_config('yolact_base').copy(max_size=64)
    ours = coco.COCODetection(str(tmp_path), info,
                              augmentations.BaseTransform(port_cfg),
                              dataset_cfg=port_cfg.dataset)
    theirs = jax_coco.COCODetection(str(tmp_path), info,
                                    jax_aug.BaseTransform(cfg),
                                    dataset_cfg=cfg.dataset)
    assert ours.ids == theirs.ids == [0, 1]
    for i in range(2):
        got, want = ours.pull_item(i), theirs.pull_item(i)
        assert got[0].shape == (64, 64, 3) and got[5] == 1
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        assert ours.pull_anno(i) == theirs.pull_anno(i)


def test_utils_match_jax():
    ours, theirs = functions.MovingAverage(3), jax_functions.MovingAverage(3)
    for v in (1.0, float('nan'), 2.0, 4.0, 8.0):
        ours.add(v)
        theirs.add(v)
        assert ours.get_avg() == theirs.get_avg() and len(ours) == len(theirs)
    bar, jax_bar = functions.ProgressBar(10, 7), jax_functions.ProgressBar(10, 7)
    for v in (0, 3, 7, 9):
        bar.set_val(v)
        jax_bar.set_val(v)
        assert repr(bar) == repr(jax_bar)
    with timer.env('outer'):
        with timer.env('inner'):
            pass
    assert {'outer', 'inner'} <= set(timer._total)
    assert timer.total_time() >= 0
