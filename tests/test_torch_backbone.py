"""Backbone-only init of a fresh run (``yolact_tpu_torch/convert/
backbone_import.py``) against the JAX package's
``yolact_tpu/convert/backbone_import.py``.

A synthetic torchvision-style ResNet state dict (``layerN.`` keys, an
``fc.`` classifier, ``num_batches_tracked``) of the tiny config's backbone
is saved as a ``.pth``; the port's ``load_backbone_weights`` +
``merge_backbone`` must give the same weights, bit for bit, as JAX's
followed by ``convert/from_jax.jax_variables_to_state_dict``, and leave
every other weight as it was.  ``focal_bias_init`` (its reference quirk
included) against JAX's the same way, and the raises."""

import jax
import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from yolact_tpu import config as J
from yolact_tpu.convert import backbone_import as jax_bb
from yolact_tpu.infer import random_variables
from yolact_tpu_torch.convert import backbone_import as bb
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.models.yolact import Yolact


def _torchvision_sd(sd, seed=0):
    """The port's backbone keys as torchvision names them, seeded values."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, value in sd.items():
        if not key.startswith('backbone.'):
            continue
        key = key[len('backbone.'):]
        if key.startswith('layers.'):
            stage, rest = key[len('layers.'):].split('.', 1)
            key = f'layer{int(stage) + 1}.{rest}'
        out[key] = torch.randn(value.shape, generator=gen)
    out['bn1.num_batches_tracked'] = torch.tensor(5)
    out['fc.weight'] = torch.randn(10, 2048, generator=gen)
    out['fc.bias'] = torch.zeros(10)
    return out


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    cfg = tiny_resnet_config()
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=3))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    sd = jax_variables_to_state_dict(P(cfg), v)
    path = str(tmp_path_factory.mktemp('bb') / 'resnet_tiny.pth')
    torch.save(_torchvision_sd(sd), path)
    return cfg, v, sd, path


def test_backbone_merge_matches_jax(setup):
    cfg, v, sd, path = setup
    got = bb.merge_backbone(sd, bb.load_backbone_weights(P(cfg), path),
                            P(cfg))
    want = jax_variables_to_state_dict(
        P(cfg), jax_bb.merge_backbone(
            v, jax_bb.load_backbone_weights(cfg, path)))
    assert got.keys() == want.keys() == sd.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    file = torch.load(path)
    assert torch.equal(got['backbone.layers.3.0.conv2.weight'],
                       file['layer4.0.conv2.weight'])
    assert torch.equal(got['backbone.bn1.running_var'],
                       file['bn1.running_var'])
    moved = {k for k in sd if not torch.equal(got[k], sd[k])}
    assert moved == {k for k in sd if k.startswith('backbone.')}


@pytest.mark.parametrize('sigmoid', [False, True], ids=['softmax', 'sigmoid'])
def test_focal_bias_init_matches_jax(setup, sigmoid):
    cfg, v, sd, _ = setup
    cfg = cfg.copy(use_focal_loss=True, use_sigmoid_focal_loss=sigmoid)
    got = bb.focal_bias_init(P(cfg), sd)
    want = jax_variables_to_state_dict(P(cfg), jax_bb.focal_bias_init(cfg, v))
    key = 'prediction_layers.0.conf_layer.bias'
    assert torch.equal(got[key], want[key])
    assert not torch.equal(got[key], sd[key])
    assert got[key][0] != got[key][1] and bool((got[key][1:] ==
                                                got[key][1]).all())
    # no focal loss: nothing changes
    assert bb.focal_bias_init(P(cfg.copy(use_focal_loss=False)), sd) is sd


def test_backbone_merge_raises(setup, tmp_path):
    cfg, _, sd, path = setup
    weights = bb.load_backbone_weights(P(cfg), path)
    with pytest.raises(ValueError, match='zero'):
        bb.merge_backbone(sd, {}, P(cfg))
    short = dict(weights)
    del short['backbone.layers.2.0.bn3.running_mean']
    with pytest.raises(ValueError, match='unmatched'):
        bb.merge_backbone(sd, short, P(cfg))
    with pytest.raises(ValueError, match='lacks'):
        bb.merge_backbone(sd, dict(weights, **{'backbone.extra.weight':
                                               torch.zeros(1)}), P(cfg))
    bad = dict(weights)
    bad['backbone.conv1.weight'] = torch.zeros(1, 3, 7, 7)
    with pytest.raises(ValueError, match='shapes'):
        bb.merge_backbone(sd, bad, P(cfg))
    # a ResNet file into another family's model
    for name in ('yolact_vgg16', 'yolact_darknet53'):
        other = P(J.get_config(name))
        with torch.device('meta'):
            other_sd = Yolact(other).state_dict()
        with pytest.raises(ValueError, match='lacks'):
            bb.merge_backbone(other_sd, bb.load_backbone_weights(other, path),
                              other)


def test_fresh_run_loads_backbone(setup, tmp_path):
    """cli/train's fresh run: the backbone file under --save_folder named by
    cfg.backbone.path initialises the backbone (the rest keeps its seeded
    init); without it the run starts from random weights."""
    import shutil
    from yolact_tpu_torch.cli.train import _init_fresh
    from yolact_tpu_torch.train.step import create_train_state
    cfg, _, _, path = setup
    cfg = P(cfg)
    shutil.copy(path, str(tmp_path / cfg.backbone.path))
    state = create_train_state(cfg, device='cpu')
    _init_fresh(cfg, state, str(tmp_path))
    got = state.model.state_dict()
    fresh = random_state_dict(cfg, torch.Generator().manual_seed(0))
    file = torch.load(path)
    assert torch.equal(got['backbone.layers.0.0.conv1.weight'],
                       file['layer1.0.conv1.weight'])
    assert torch.equal(got['fpn.lat_layers.0.weight'],
                       fresh['fpn.lat_layers.0.weight'])
    state = create_train_state(cfg, device='cpu')
    _init_fresh(cfg, state, str(tmp_path / 'missing'))
    assert torch.equal(state.model.state_dict()['backbone.conv1.weight'],
                       fresh['backbone.conv1.weight'])
