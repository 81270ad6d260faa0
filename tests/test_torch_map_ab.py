"""The port's mAP A/B (yolact_tpu_torch/scripts/map_ab.py) against the JAX
package's evaluate_dataset under the same knobs, on carried weights.

The weights come from a short overfit of the port on the tiny COCO set
itself (random weights give mAP 0.00 and would make every row equal
trivially), converted to JAX variables with JAX's own importer
(``yolact_tpu/convert/torch_import.py:convert_state_dict``).  Every float32
row (``nms_candidates`` 0, 1024 and 8, the float32 trunk, the kernel and
plain rows, which both take the plain versions on the CPU) has the JAX
row's all_maps dict exactly, as ``test_evaluate_dataset_matches_jax``
holds it; the bfloat16 trunk's box and mask mAP are within BF16_MAP_TOL of
JAX's bfloat16 row (the two packages round their bf16 convolutions
differently).  The port's table is CLEAN, and a row changed by hand makes
it DIRTY."""

import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from test_torch_eval import _write_tiny_coco
from yolact_tpu.convert.torch_import import convert_state_dict
from yolact_tpu.eval.evaluate import evaluate_dataset as jax_evaluate_dataset
from yolact_tpu.eval.evaluate import make_eval_dataset as jax_eval_dataset
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.eval.evaluate import make_eval_dataset
from yolact_tpu_torch.ops.resize import resize_bilinear_np
from yolact_tpu_torch.scripts import map_ab
from yolact_tpu_torch.train.step import create_train_state, train_step

torch.set_num_threads(2)

# box and mask mAP points between the port's and JAX's bfloat16 rows: on 3
# images with 6 gts one detection that ranks otherwise moves a class's AP
# by several points; measured here box 40.27 against JAX's 38.04 (float32
# 37.36), mask 25.80 on both
BF16_MAP_TOL = 4.0
OVERFIT_STEPS = 60


def port_overfit(cfg, dataset, steps=OVERFIT_STEPS, lr=2e-3):
    """The port trained `steps` steps on the eval images themselves (the
    JAX test's overfit_variables, on the port), from its seeded weights;
    its state dict."""
    S = cfg.max_size
    items = [dataset.pull_item(i) for i in range(len(dataset))]
    B, G = len(items), max(len(it[1]) for it in items)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -2, np.int32)
    masks = np.zeros((B, G, S, S), np.uint8)
    for b, (_, gt, m, _, _, _) in enumerate(items):
        n = len(gt)
        boxes[b, :n] = gt[:, :4]
        labels[b, :n] = gt[:, 4].astype(np.int32)
        masks[b, :n] = resize_bilinear_np(np.asarray(m, np.float32),
                                          (S, S)) > 0.5
    batch = dict(image=np.stack([it[0] for it in items]), gt_boxes=boxes,
                 gt_labels=labels, gt_masks=masks,
                 num_gts=np.array([len(it[1]) for it in items], np.int32),
                 num_crowds=np.zeros(B, np.int32))
    state = create_train_state(cfg.copy(lr=lr, lr_warmup_until=0,
                                        freeze_bn=False), device='cpu')
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        out = train_step(state, batch, gen)
    assert out['finite'] and np.isfinite(float(out['total']))
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


@pytest.fixture(scope='module')
def carried(tmp_path_factory):
    """(JAX config, JAX variables, JAX eval set, port state dict, port eval
    set) on the tiny COCO set, the weights overfit by the port."""
    img_dir, json_path = _write_tiny_coco(tmp_path_factory.mktemp('map_ab'))
    cfg = tiny_resnet_config()
    cfg = cfg.copy(name='tinyportmapab', dataset=cfg.dataset.copy(
        valid_images=img_dir, valid_info=json_path,
        class_names=('thing', 'b', 'c', 'd'), label_map=None))
    port_set = make_eval_dataset(P(cfg))
    sd = port_overfit(P(cfg), port_set)
    variables, unhandled = convert_state_dict(
        cfg, {k: v.numpy() for k, v in sd.items()})
    assert unhandled == []
    variables = {'params': variables['params'],
                 'batch_stats': variables['batch_stats']}
    return cfg, variables, jax_eval_dataset(cfg), sd, port_set


@pytest.fixture(scope='module')
def rows(carried):
    cfg, _, _, sd, port_set = carried
    return map_ab.ab_rows(P(cfg), sd, port_set, 'cpu', batch=2)


def _jax_row(carried, overrides):
    cfg, variables, jax_set, _, _ = carried
    return jax_evaluate_dataset(cfg.copy(**overrides), variables, jax_set,
                                quiet=True, device_mask_iou=False,
                                eval_batch_size=2)


def test_carried_weights_give_a_real_map(rows):
    exact = dict(rows)['nms_candidates=0 (exact)']
    assert exact['box']['all'] > 10, exact['box']
    assert exact['mask']['all'] > 10, exact['mask']


@pytest.mark.parametrize('row', [r[0] for r in map_ab.ROWS
                                 if r[0] != 'trunk bfloat16'])
def test_float32_row_equals_jax(carried, rows, row):
    """The JAX row under the same knob; both mask assembly rows against
    JAX's default row (the CPU takes the plain versions on both sides)."""
    overrides = {name: o for name, o, _ in map_ab.ROWS}[row]
    assert dict(rows)[row] == _jax_row(carried, overrides)


def test_bfloat16_row_near_jax(carried, rows):
    got = dict(rows)['trunk bfloat16']
    want = _jax_row(carried, dict(compute_dtype='bfloat16'))
    for t in ('box', 'mask'):
        assert abs(got[t]['all'] - want[t]['all']) <= BF16_MAP_TOL, \
            (t, got[t], want[t])


def test_table_is_clean_and_a_changed_row_is_dirty(rows):
    ok, lines = map_ab.verdict(rows)
    print('\n'.join(lines))
    assert ok and lines[-1] == 'A/B CLEAN'
    assert any(l.startswith('bfloat16 - float32 trunk') for l in lines)
    for name in ('nms_candidates=8 (fallback)', 'mask assembly plain'):
        bad = [(n, {t: dict(v, all=v['all'] + 1.0) for t, v in m.items()})
               if n == name else (n, m) for n, m in rows]
        ok, lines = map_ab.verdict(bad)
        assert not ok and lines[-1] == 'A/B DIRTY'
