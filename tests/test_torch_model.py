"""The port's model (yolact_tpu_torch.models) and weight conversion against
the JAX package: names and shapes at full yolact_base width, a lossless
round trip through convert_state_dict, and the tiny model's forward in
float32 within rtol/atol 1e-4 (the same convolutions summed in another
order by XLA and by PyTorch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from yolact_tpu import config as C
from yolact_tpu.convert.torch_import import convert_state_dict
from yolact_tpu.infer import random_variables
from yolact_tpu.models import resnet as jax_resnet
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.infer import preprocess_device
from yolact_tpu_torch.models import resnet
from yolact_tpu_torch.models.yolact import Yolact

torch.set_num_threads(2)


def _variables(cfg, seed=0):
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=seed))
    return {'params': v['params'], 'batch_stats': v['batch_stats']}


def test_weights_round_trip_and_strict_load():
    cfg = tiny_resnet_config()
    v = _variables(cfg)
    sd = jax_variables_to_state_dict(cfg, v)
    Yolact(cfg).load_state_dict(sd, strict=True)
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
            for k, t in jax_variables_to_state_dict(cfg, zeros).items()}
    with torch.device('meta'):
        model = Yolact(cfg)
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    assert 'backbone.layers.2.22.conv2.weight' in got
    assert got['proto_net.8.weight'] == (256, 256, 3, 3)
    assert got['prediction_layers.0.upfeature.0.weight'] == (256, 256, 3, 3)
    assert got['fpn.lat_layers.0.weight'] == (256, 2048, 1, 1)


@pytest.mark.parametrize('overrides', [
    {},
    {'extra_layers': (1, 0, 2)},
    {'eval_mask_branch': False},
    {'fpn': dict(interpolation_mode='nearest', use_conv_downsample=False,
                 relu_downsample_layers=True)},
], ids=['base', 'extra_layers', 'box_only', 'fpn_options'])
def test_tiny_forward_matches_jax(overrides):
    cfg = tiny_resnet_config()
    if 'fpn' in overrides:
        overrides = dict(overrides, fpn=cfg.fpn.copy(**overrides['fpn']))
    cfg = cfg.copy(**overrides)
    v = _variables(cfg, seed=5)
    rng = np.random.RandomState(11)
    frames = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.float32)
    from yolact_tpu.infer import preprocess_device as jax_preprocess
    want = JaxYolact(cfg).apply(v, jax_preprocess(cfg, jnp.asarray(frames)),
                                train=False)
    model = Yolact(cfg).eval()
    model.load_state_dict(jax_variables_to_state_dict(cfg, v))
    with torch.no_grad():
        got = model(preprocess_device(cfg, torch.from_numpy(frames)))
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


def test_dcn_backbone_not_ported():
    with pytest.raises(NotImplementedError, match='A7'):
        Yolact(tiny_plus_config())
