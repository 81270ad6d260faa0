"""The port's model (yolact_tpu_torch.models) and weight conversion against
the JAX package: names and shapes at full yolact_base and yolact_plus_base
width, a lossless round trip through convert_state_dict, the tiny models'
forward in float32 within rtol/atol 1e-4 (the same convolutions summed in
another order by XLA and by PyTorch; the tiny-plus DCN offsets are seeded
non-zero on both sides), and the YOLACT++ mask scorer and re-scoring
within 1e-5.  The port gets its own config (``P`` = ``config_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import seed_offsets_jax
from yolact_tpu import config as C
from yolact_tpu.convert.torch_import import convert_state_dict
from yolact_tpu.detect.detection import Detections as JaxDetections
from yolact_tpu.detect.postprocess import \
    rescore_with_maskiou as jax_rescore_with_maskiou
from yolact_tpu.infer import random_variables
from yolact_tpu.models import resnet as jax_resnet
from yolact_tpu.models.yolact import MaskIoUHead
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.detect.detection import Detections
from yolact_tpu_torch.detect.postprocess import rescore_with_maskiou
from yolact_tpu_torch.infer import preprocess_device
from yolact_tpu_torch.models import resnet
from yolact_tpu_torch.models.heads import FastMaskIoUNet
from yolact_tpu_torch.models.yolact import Yolact

torch.set_num_threads(2)


def _maskiou_variables(cfg, seed=0):
    v = MaskIoUHead(cfg).init(jax.random.PRNGKey(seed + 1),
                              jnp.zeros((1, 138, 138, 1)))
    return jax.tree_util.tree_map(np.array, dict(v))


def _variables(cfg, seed=0):
    """JAX variables for Yolact(cfg); for YOLACT++ configs also the mask
    scorer's (under 'maskiou', where convert_state_dict puts it) and
    non-zero DCN offset convs."""
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=seed))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    if cfg.use_maskiou:
        v['maskiou'] = _maskiou_variables(cfg, seed)
        seed_offsets_jax(v, seed)
    return v


def test_weights_round_trip_and_strict_load():
    cfg = tiny_resnet_config()
    v = _variables(cfg)
    sd = jax_variables_to_state_dict(P(cfg), v)
    Yolact(P(cfg)).load_state_dict(sd, strict=True)
    back, unhandled = convert_state_dict(
        cfg, {k: t.numpy() for k, t in sd.items()})
    assert unhandled == []
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_back) == len(flat_v)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_full_width_names_and_shapes_match_jax():
    """Every parameter of full-width yolact_base has the reference's torch
    name and the shape the JAX tree implies (nothing is computed)."""
    cfg = C.get_config('yolact_base')
    shapes = jax.eval_shape(
        lambda: JaxYolact(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 550, 550, 3)),
                                    train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape),
        {'params': shapes['params'], 'batch_stats': shapes['batch_stats']})
    want = {k: tuple(t.shape)
            for k, t in jax_variables_to_state_dict(P(cfg), zeros).items()}
    with torch.device('meta'):
        model = Yolact(P(cfg))
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    assert 'backbone.layers.2.22.conv2.weight' in got
    assert got['proto_net.8.weight'] == (256, 256, 3, 3)
    assert got['prediction_layers.0.upfeature.0.weight'] == (256, 256, 3, 3)
    assert got['fpn.lat_layers.0.weight'] == (256, 2048, 1, 1)


@pytest.mark.parametrize('make_cfg,overrides', [
    (tiny_resnet_config, {}),
    (tiny_resnet_config, {'extra_layers': (1, 0, 2)}),
    (tiny_resnet_config, {'eval_mask_branch': False}),
    (tiny_resnet_config, {'fpn': dict(interpolation_mode='nearest',
                                      use_conv_downsample=False,
                                      relu_downsample_layers=True)}),
    (tiny_plus_config, {}),
], ids=['base', 'extra_layers', 'box_only', 'fpn_options', 'plus'])
def test_tiny_forward_matches_jax(make_cfg, overrides):
    cfg = make_cfg()
    if 'fpn' in overrides:
        overrides = dict(overrides, fpn=cfg.fpn.copy(**overrides['fpn']))
    cfg = cfg.copy(**overrides)
    v = _variables(cfg, seed=5)
    rng = np.random.RandomState(11)
    frames = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.float32)
    from yolact_tpu.infer import preprocess_device as jax_preprocess
    want = JaxYolact(cfg).apply(v, jax_preprocess(cfg, jnp.asarray(frames)),
                                train=False)
    model = Yolact(P(cfg)).eval()
    model.load_state_dict(jax_variables_to_state_dict(P(cfg), v))
    with torch.no_grad():
        got = model(preprocess_device(P(cfg), torch.from_numpy(frames)))
    assert set(got) == set(want)
    assert ('proto' in got) == cfg.eval_mask_branch
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize('args', [
    ((3, 4, 23, 3), (0, 0, 0, 0), 1, (), 0),
    ((3, 4, 6, 3), (0, 4, 6, 3), 3, (), 0),
    ((1, 2, 2, 1), (0, 0, 0, 0), 1, (2, 3), 2),
])
def test_stage_plan_matches_jax(args):
    want = jax_resnet._stage_plan(*args)
    got = resnet._stage_plan(*args)
    assert [[{k: v for k, v in b.items() if k != 'inplanes'} for b in s]
            for s in got] == [list(s) for s in want]


def test_plus_weights_round_trip_and_strict_load():
    """tiny-plus, DCN layers and the separate maskiou tree included."""
    cfg = tiny_plus_config()
    v = _variables(cfg)
    sd = jax_variables_to_state_dict(P(cfg), v)
    Yolact(P(cfg)).load_state_dict(sd, strict=True)
    assert sd['backbone.layers.1.0.conv2.weight'].shape == (128, 128, 3, 3)
    back, unhandled = convert_state_dict(
        cfg, {k: t.numpy() for k, t in sd.items()})
    assert unhandled == []
    assert set(back) == {'params', 'batch_stats', 'maskiou'}
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_back) == len(flat_v)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_plus_full_width_names_and_shapes_match_jax():
    """yolact_plus_base at full width: every DCN block, the mask scorer
    (JAX's separate MaskIoUHead tree) and the rest have the reference's
    torch names and the shapes the JAX trees imply (nothing is computed)."""
    cfg = C.get_config('yolact_plus_base')
    shapes = jax.eval_shape(
        lambda: JaxYolact(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 550, 550, 3)),
                                    train=False))
    miou = jax.eval_shape(
        lambda: MaskIoUHead(cfg).init(jax.random.PRNGKey(1),
                                      jnp.zeros((1, 138, 138, 1))))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape),
        {'params': shapes['params'], 'batch_stats': shapes['batch_stats'],
         'maskiou': dict(miou)})
    want = {k: tuple(t.shape)
            for k, t in jax_variables_to_state_dict(P(cfg), zeros).items()}
    with torch.device('meta'):
        model = Yolact(P(cfg))
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    dcn_blocks = sorted(k[:-len('.conv2.conv_offset_mask.weight')]
                        for k in got if k.endswith('conv_offset_mask.weight'))
    assert dcn_blocks == sorted(
        ['backbone.layers.1.0', 'backbone.layers.1.3', 'backbone.layers.3.0']
        + [f'backbone.layers.2.{i}' for i in range(0, 22, 3)])
    assert got['backbone.layers.2.21.conv2.conv_offset_mask.weight'] == \
        (27, 256, 3, 3)
    assert got['backbone.layers.2.21.conv2.weight'] == (256, 256, 3, 3)
    assert got['backbone.layers.2.21.conv2.bias'] == (256,)
    assert got['maskiou_net.maskiou_net.0.weight'] == (8, 1, 3, 3)
    assert got['maskiou_net.maskiou_net.10.weight'] == (80, 128, 1, 1)


@pytest.mark.parametrize('make_cfg,hw', [
    (tiny_plus_config, 32),
    (lambda: C.get_config('yolact_plus_base'), 138),
], ids=['tiny_plus', 'yolact_plus_base'])
def test_maskiou_net_and_rescore_match_jax(rng, make_cfg, hw):
    cfg = make_cfg()
    mv = _maskiou_variables(cfg, seed=2)
    B, D = 2, 5
    masks = rng.rand(B, D, hw, hw).astype(np.float32)
    masks[:, :, :, : hw // 3] = 0.0                   # cropped-away columns
    classes = rng.randint(0, cfg.num_classes - 1, (B, D)).astype(np.int32)
    classes[0, 0] = cfg.num_classes + 3               # clamped like JAX
    scores = rng.rand(B, D).astype(np.float32)

    net = FastMaskIoUNet(P(cfg)).eval()
    net.load_state_dict({k[len('maskiou_net.'):]: t for k, t in
                         jax_variables_to_state_dict(
                             P(cfg), {'maskiou': mv}).items()})
    head = MaskIoUHead(cfg)
    flat = masks.reshape(B * D, hw, hw, 1)
    want_iou = np.asarray(head.apply(mv, jnp.asarray(flat)))
    with torch.no_grad():
        got_iou = net(torch.from_numpy(flat).permute(0, 3, 1, 2)).numpy()
    assert got_iou.shape == (B * D, cfg.num_classes - 1)
    np.testing.assert_allclose(got_iou, want_iou, rtol=0, atol=1e-5)

    arrays = dict(boxes=np.zeros((B, D, 4), np.float32),
                  masks=np.zeros((B, D, 4), np.float32), classes=classes,
                  scores=scores, valid=np.ones((B, D), bool))
    want = jax_rescore_with_maskiou(
        cfg, lambda m: head.apply(mv, m), jnp.asarray(masks),
        JaxDetections(**{k: jnp.asarray(a) for k, a in arrays.items()},
                      proto=None))
    with torch.no_grad():
        got = rescore_with_maskiou(
            net, torch.from_numpy(masks),
            Detections(**{k: torch.from_numpy(a) for k, a in arrays.items()},
                       proto=None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
