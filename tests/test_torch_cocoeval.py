"""The port's COCO protocol over result JSONs (``yolact_tpu_torch/eval/
cocoeval.py``, a copy of the JAX package's) and its entry point
``python -m yolact_tpu_torch.cli.coco_eval`` against ``yolact_tpu``'s
``COCOEvalLite`` and the repo's ``run_coco_eval.py``, on the same files:
the 12 numbers and the printout equal."""

import json
import sys

import numpy as np
import pytest

import run_coco_eval
from yolact_tpu.data import rle as jax_rle
from yolact_tpu.eval.cocoeval import COCOEvalLite as JaxCOCOEvalLite
from yolact_tpu_torch.cli import coco_eval
from yolact_tpu_torch.data import rle
from yolact_tpu_torch.eval.cocoeval import COCOEvalLite

SIZES = ((48, 64), (64, 48), (43, 64), (80, 80))


def _rle(mask):
    r = rle.mask_to_rle(mask)
    return {'size': r['size'], 'counts': r['counts'].decode()}


def _write(tmp_path, seed):
    """A gt instances JSON (4 images of mixed sizes, 2 categories, small,
    medium and large objects, a crowd, polygon and RLE segmentations) and
    bbox / mask result JSONs: each gt object found with a jittered box and
    mask (not every one), plus false positives, seeded scores."""
    rng = np.random.RandomState(seed)
    images, anns, bbox_dets, mask_dets = [], [], [], []
    for img_id, (h, w) in enumerate(SIZES, start=1):
        images.append({'id': img_id, 'height': h, 'width': w})
        for k in range(rng.randint(2, 5)):
            bw, bh = rng.randint(3, w // 2), rng.randint(3, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            mask = np.zeros((h, w), bool)
            mask[y:y + bh, x:x + bw] = True
            crowd = int(k == 0 and img_id % 2 == 0)
            seg = _rle(mask) if k % 2 else \
                [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]
            cat = int(rng.randint(1, 3))
            anns.append({'id': len(anns) + 1, 'image_id': img_id,
                         'category_id': cat, 'bbox': [x, y, bw, bh],
                         'area': float(bw * bh), 'iscrowd': crowd,
                         'segmentation': seg})
            for _ in range(rng.randint(0, 3)):
                dx, dy = rng.randint(-2, 3, 2)
                dmask = np.zeros((h, w), bool)
                dmask[max(y + dy, 0):y + dy + bh, max(x + dx, 0):x + dx + bw] \
                    = True
                score = float(rng.rand())
                c = cat if rng.rand() < 0.8 else 3 - cat
                bbox_dets.append({'image_id': img_id, 'category_id': c,
                                  'bbox': [float(x + dx), float(y + dy),
                                           float(bw), float(bh)],
                                  'score': score})
                mask_dets.append({'image_id': img_id, 'category_id': c,
                                  'segmentation': _rle(dmask),
                                  'score': score})
    gt = {'images': images, 'annotations': anns,
          'categories': [{'id': 1, 'name': 'a'}, {'id': 2, 'name': 'b'}]}
    paths = {}
    for name, blob in (('gt', gt), ('bbox', bbox_dets), ('mask', mask_dets)):
        paths[name] = str(tmp_path / f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(blob, f)
    return paths


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('iou_type', ['bbox', 'segm'])
def test_coco_eval_lite_matches_jax(tmp_path, seed, iou_type):
    paths = _write(tmp_path, seed)
    dets = paths['bbox' if iou_type == 'bbox' else 'mask']
    got = COCOEvalLite(paths['gt'], dets, iou_type).evaluate()
    want = JaxCOCOEvalLite(paths['gt'], dets, iou_type).evaluate()
    assert list(got) == list(want) and len(got) == 12
    assert got == want
    assert 0 < got['AP'] < 1 and got['AR100'] > 0


@pytest.mark.parametrize('eval_type', ['both', 'bbox', 'mask'])
def test_cli_matches_run_coco_eval(tmp_path, capsys, monkeypatch, eval_type):
    paths = _write(tmp_path, 4)
    argv = [f'--gt_ann_file={paths["gt"]}',
            f'--bbox_det_file={paths["bbox"]}',
            f'--mask_det_file={paths["mask"]}', f'--eval_type={eval_type}']
    stats = coco_eval.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['run_coco_eval.py'] + argv)
    run_coco_eval.main()
    want = capsys.readouterr().out
    assert got == want
    assert set(stats) == {'both': {'bbox', 'segm'}, 'bbox': {'bbox'},
                          'mask': {'segm'}}[eval_type]
    assert got.count(' = ') == 12 * len(stats)
    assert all(np.isfinite(v) for s in stats.values() for v in s.values())


def test_rle_area_matches_jax(rng):
    for _ in range(5):
        m = rng.rand(23, 31) > 0.6
        r = rle.mask_to_rle(m)
        assert rle.area(r) == jax_rle.area(jax_rle.mask_to_rle(m)) == m.sum()
        assert rle.area({'size': r['size'],
                         'counts': rle.decode_counts(r['counts'])}) == m.sum()
