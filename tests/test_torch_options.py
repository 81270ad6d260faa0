"""The model options the port builds beside the plain lincomb head, against
the JAX package on the tiny ResNet config, in float32 on the CPU.

* make_net's ``'cat'`` entry and transposed convs (k = s = 2, p = 0; the
  stride-1 cases) against JAX's ``SpecNet``, within 1e-5;
* the forward of each head and protonet option (grid and bias prototypes,
  the raw image as protonet source, prototypes as features with and
  without their gradient, DSSD's prediction module, YOLO regressors, the
  coefficient gate, mask scoring, instance coefficients, prototypes split
  by head, ``'cat'`` and a transposed conv in ``extra_head_net``, direct
  masks, and the options together) from JAX's weights through
  ``convert_from_jax``: eval forward within 1e-4, training forward of the
  options with batch statistics by the float64 yardstick of
  ``test_torch_model.py``;
* the converter's names, the DSSD module's included;
* direct masks from the frame to ``finish_masks_direct`` (fast and
  traditional NMS) and ``direct_mask_loss`` with one ``train_step``;
* a short ``cli/train`` run and ``cli/eval`` mAP on a tiny direct config
  and a tiny options config, with JAX's mAP on the same weights.

Each package gets its own config (``P`` = ``config_from_jax``); seeds are
numpy's and JAX's, and the port gets JAX's draws."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from test_torch_eval import _write_tiny_coco
from test_torch_inputs import (CAT_DECONV_HEAD, PAD1, tiny_option_overrides,
                               write_grid)
from test_torch_loss import _inputs as loss_inputs
from test_torch_model import (_hold_to_float64, _jax_train_forward,
                              _train_variables)
from test_torch_train import _leaves, _numpy, _port_state
from yolact_tpu.config import MaskType
from yolact_tpu.config import register_config as jax_register_config
from yolact_tpu.convert.torch_import import convert_state_dict
from yolact_tpu.detect.postprocess import \
    finish_masks_direct as jax_finish_masks_direct
from yolact_tpu.eval.evaluate import evaluate_dataset as jax_evaluate_dataset
from yolact_tpu.eval.evaluate import sanitize_boxes_np
from yolact_tpu.eval.traditional import \
    TraditionalPipeline as JaxTraditionalPipeline
from yolact_tpu.infer import Pipeline as JaxPipeline
from yolact_tpu.infer import random_variables
from yolact_tpu.models.layers import SpecNet
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu.train import loss as jax_loss
from yolact_tpu.train.step import create_train_state as jax_create_train_state
from yolact_tpu.train.step import train_step as jax_train_step
from yolact_tpu_torch.cli import eval as cli_eval
from yolact_tpu_torch.cli import train as cli_train
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.from_jax import _state_dict
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import (jax_variables_to_state_dict,
                                               state_dict_to_train_state)
from yolact_tpu_torch.detect.postprocess import finish_masks_direct
from yolact_tpu_torch.eval.evaluate import evaluate_dataset, make_eval_dataset
from yolact_tpu_torch.eval.traditional import TraditionalPipeline
from yolact_tpu_torch.infer import Pipeline
from yolact_tpu_torch.models.layers import make_net
from yolact_tpu_torch.models.yolact import Yolact
from yolact_tpu_torch.ops.anchors import spec_out_hw
from yolact_tpu_torch.train import loss
from yolact_tpu_torch.train.step import apply_gradients, loss_and_grads

torch.set_num_threads(2)

SPECS = {
    'cat': (('cat', (((6, 3, PAD1),), ((4, 1, ()), (5, 3, PAD1)))),
            (7, 1, ())),
    'deconv_k2_s2': ((6, -2, (('stride', 2),)),),
    'deconv_k2_s1': ((6, -2, ()),),                # torch's default stride 1
    'deconv_k3_s1_p1': ((6, -3, PAD1),),
    'deconv_k4_s2_p1': ((6, -4, (('stride', 2), ('padding', 1))),),
}


@pytest.mark.parametrize('name', list(SPECS))
def test_make_net_layers_match_jax(rng, name):
    """make_net against SpecNet on the same weights, with and without the
    last ReLU: the output size is torch's (in - 1) s - 2p + k for the
    transposed convs (and ``ops/anchors.py:spec_out_hw``'s), and values
    agree within 1e-5."""
    spec = SPECS[name]
    x = rng.randn(2, 9, 11, 5).astype(np.float32)
    for last_relu in (True, False):
        net = SpecNet(spec, include_last_relu=last_relu)
        params = jax.tree_util.tree_map(
            np.array, net.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        params = params['params']
        for path, leaf in _leaves(params).items():    # non-zero biases
            if path.endswith("['bias']"):
                leaf += rng.randn(*leaf.shape).astype(np.float32) * 0.1
        want = np.asarray(net.apply({'params': params}, jnp.asarray(x)))
        port, ch = make_net(5, spec, include_last_relu=last_relu)
        port.load_state_dict(_state_dict([params]), strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape and ch == want.shape[-1]
        assert spec_out_hw(spec, 9, 11) == got.shape[1:3]
        if name.startswith('deconv'):
            k = -spec[0][1]
            kw = dict(spec[0][2])
            s, p = kw.get('stride', 1), kw.get('padding', 0)
            assert got.shape[1:3] == ((9 - 1) * s - 2 * p + k,
                                      (11 - 1) * s - 2 * p + k)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _options(tmp_path):
    grid = write_grid(tmp_path / 'grid.npy')
    every = tiny_option_overrides(grid)
    return {
        'grid': dict(mask_proto_use_grid=True, mask_proto_grid_file=grid),
        'bias': dict(mask_proto_bias=True),
        'proto_src_image': dict(mask_proto_src=None),
        'prototypes_as_features': dict(
            mask_proto_prototypes_as_features=True),
        'prototypes_as_features_bias_no_grad': dict(
            mask_proto_prototypes_as_features=True, mask_proto_bias=True,
            mask_proto_prototypes_as_features_no_grad=True),
        'prediction_module': dict(use_prediction_module=True),
        'yolo_regressors': dict(use_yolo_regressors=True),
        'coeff_gate': dict(mask_proto_coeff_gate=True),
        'mask_scoring': dict(use_mask_scoring=True),
        'instance_coeff': dict(use_instance_coeff=True),
        # ten prototypes, two per head
        'split_by_head': dict(
            mask_proto_split_prototypes_by_head=True,
            mask_proto_net=((8, 3, PAD1), (None, -2, ()), (10, 1, ()))),
        'extra_head_cat_deconv': dict(extra_head_net=CAT_DECONV_HEAD),
        'direct': dict(mask_type=MaskType.DIRECT),
        'every': every,
    }


OPTION_NAMES = ('grid', 'bias', 'proto_src_image', 'prototypes_as_features',
                'prototypes_as_features_bias_no_grad', 'prediction_module',
                'yolo_regressors', 'coeff_gate', 'mask_scoring',
                'instance_coeff', 'split_by_head', 'extra_head_cat_deconv',
                'direct', 'every')
# the options that hold batch norm outside the backbone
BATCH_STATS_OPTIONS = ('prediction_module', 'every')


def _option_cfg(tmp_path, name):
    return tiny_resnet_config().copy(**_options(tmp_path)[name])


@pytest.mark.parametrize('name', OPTION_NAMES)
def test_option_forward_matches_jax(tmp_path, rng, name):
    """The eval forward of each option from JAX's seeded weights: every
    output within 1e-4 (as tests/test_torch_model.py's tiny forward), and
    the converted weights load strictly."""
    cfg = _option_cfg(tmp_path, name)
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=2))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    x = rng.randn(2, 128, 128, 3).astype(np.float32)
    want = JaxYolact(cfg).apply(v, jnp.asarray(x))
    model = Yolact(P(cfg))
    model.load_state_dict(jax_variables_to_state_dict(P(cfg), v),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    expect = {'loc', 'conf', 'mask', 'priors'}
    expect |= {'proto'} if cfg.mask_type == MaskType.LINCOMB else set()
    expect |= {'score'} if cfg.use_mask_scoring else set()
    expect |= {'inst'} if cfg.use_instance_coeff else set()
    assert set(got) == expect
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    if cfg.mask_proto_bias:
        assert got['proto'].shape[-1] == P(cfg).mask_dim == 9
        assert bool((got['proto'][..., -1] == 1).all())
    if cfg.mask_type == MaskType.DIRECT:
        assert got['mask'].shape[-1] == cfg.mask_size ** 2
        assert bool(((got['mask'] > 0) & (got['mask'] < 1)).all())


def test_grid_file_resolves_and_must_match(tmp_path, monkeypatch):
    """The grid file: a relative path resolves against the repo root from
    any working directory (data/grid.npy is [32, 35, 35], the stride-16
    level at 550), and a grid whose size is not the protonet input's
    raises, as JAX's does."""
    from yolact_tpu_torch.models.heads import ProtoNet
    monkeypatch.chdir(tmp_path)
    cfg = P(tiny_resnet_config(mask_proto_use_grid=True))
    assert cfg.mask_proto_grid_file == 'data/grid.npy'
    net = ProtoNet(cfg, 16)
    assert tuple(net.grid.shape) == (32, 35, 35)
    assert net[0].in_channels == 16 + 32
    assert 'grid' not in net.state_dict()
    with pytest.raises(ValueError, match='spatial shape'):
        net(torch.zeros(1, 16, 16, 16))


@pytest.mark.parametrize('name', BATCH_STATS_OPTIONS)
def test_option_train_forward_matches_jax(tmp_path, rng, name, monkeypatch):
    """forward(train=True) with the prediction module's batch norm on batch
    statistics: each output and each next running statistic by the float64
    yardstick (``test_torch_model._hold_to_float64``)."""
    from yolact_tpu_torch.models.layers import commit_batch_stats
    cfg = _option_cfg(tmp_path, name)
    v = _train_variables(cfg, seed=4)
    x = rng.randn(2, 128, 128, 3).astype(np.float32)
    want, stats = _jax_train_forward(cfg, v, x, True)
    want64, stats64 = _jax_train_forward(cfg, v, x, True, float64=True)
    sd = jax_variables_to_state_dict(P(cfg), v)
    assert 'prediction_layers.0.bn.running_var' in sd
    model, model64 = Yolact(P(cfg)), Yolact(P(cfg))
    model.load_state_dict(sd, strict=True)
    model64.load_state_dict(sd, strict=True)
    model64.double().set_compute_dtype(torch.float64, cast_weights=False)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, 'float', torch.Tensor.double)
        got64 = model64(torch.from_numpy(x.astype(np.float64))
                        .permute(0, 3, 1, 2), train=True)
    assert set(got) == set(want)
    for k in want:
        _hold_to_float64(k, got[k].detach(), want[k], got64[k].detach(),
                         want64[k])
    commit_batch_stats(model)
    commit_batch_stats(model64)
    want_sd = jax_variables_to_state_dict(P(cfg), {'batch_stats': stats})
    want_sd64 = jax_variables_to_state_dict(P(cfg),
                                            {'batch_stats': stats64})
    head = [k for k in want_sd if k.startswith('prediction_layers.0.b')]
    assert 'prediction_layers.0.block.bn3.running_mean' in head
    after, after64 = model.state_dict(), model64.state_dict()
    for k in want_sd:
        _hold_to_float64(k, after[k], want_sd[k], after64[k], want_sd64[k])


def test_converter_names(tmp_path):
    """The port's state-dict names of the options: the reference's (a
    ``'cat'`` branch under ``{i}.nets.{j}``, a transposed conv's IOHW
    weight, the DSSD module's ``block`` / ``conv`` / ``bn``, the gate,
    score and instance layers), a lossless round trip back to JAX's tree,
    and JAX's own importer reads all of them but the DSSD module's, for
    which it maps no names."""
    cfg = _option_cfg(tmp_path, 'every')
    v = _train_variables(cfg, seed=1)
    sd = jax_variables_to_state_dict(P(cfg), v)
    head = 'prediction_layers.0.'
    names = {
        # the FPN's 16 channels and the 8 prototypes as features
        'upfeature.0.nets.0.0.weight': (6, 16 + 8, 3, 3),
        'upfeature.0.nets.1.0.weight': (16 + 8, 4, 2, 2),      # IOHW
        'upfeature.0.nets.1.2.weight': (6, 4, 2, 2),
        'upfeature.2.weight': (12, 16, 3, 3),                  # IOHW
        'block.conv1.weight': (4, 16, 1, 1),
        'block.bn3.running_var': (16,),
        'conv.weight': (16, 16, 1, 1),
        'bn.running_mean': (16,),
        'gate_layer.weight': (3 * 9, 16, 3, 3),
        'score_layer.weight': (3, 16, 3, 3),
        'inst_layer.weight': (3 * cfg.num_instance_coeffs, 16, 3, 3),
    }
    for name, shape in names.items():
        assert tuple(sd[head + name].shape) == shape, name
    params, stats = state_dict_to_train_state(
        sd, {'model': v['params']}, v['batch_stats'])
    for tree, want in ((params['model'], v['params']),
                       (stats, v['batch_stats'])):
        got, want = _leaves(tree), _leaves(want)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    jax_tree, unhandled = convert_state_dict(
        cfg, {k: t.numpy() for k, t in sd.items()})
    dssd = {k for k in sd if k.startswith(
        tuple(head + m for m in ('block.', 'conv.', 'bn.')))}
    assert set(unhandled) == dssd and len(dssd) == 21
    imported = _leaves(jax_tree['params'])
    for path, leaf in _leaves(v['params']).items():
        if "['block']" in path or "['pm_" in path:
            continue
        np.testing.assert_array_equal(imported[path], leaf, err_msg=path)


def _sparse_variables(cfg, seed=3, bias=3.0):
    """JAX's seeded weights with the conf head biased toward background,
    so tens of the tiny priors pass conf_thresh (as
    tests/test_torch_pipeline.py's sparse cell)."""
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=seed))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    head = v['params']['prediction_layers_0']['conf_layer']['conv']
    b = head['bias'].reshape(-1, cfg.num_classes)
    b[:, 0] += bias
    head['bias'] = b.reshape(-1)
    return v


@pytest.mark.parametrize('fast_nms', [True, False], ids=['fast', 'trad'])
def test_direct_masks_match_jax(fast_nms):
    """Direct masks from raw frames: detections and patches against JAX's
    pipeline (classes and validity identical, scores and boxes within
    1e-5, patches within 1e-4, no maskiou); then the host paste into boxes
    of a larger image: the port's finish_masks_direct equals JAX's bit for
    bit on JAX's patches and boxes, and the two chains agree on >= 99.9%
    of pixels."""
    cfg = tiny_resnet_config(mask_type=MaskType.DIRECT)
    v = _sparse_variables(cfg)
    sd = jax_variables_to_state_dict(P(cfg), v)
    frames = np.random.RandomState(7).randint(
        0, 256, (2, 128, 128, 3)).astype(np.float32)
    if fast_nms:
        want = JaxPipeline(cfg, v)(frames)
        got = Pipeline(P(cfg), sd, 'cpu')(frames)
    else:
        want = JaxTraditionalPipeline(cfg, v, preprocess=True)(frames)
        got = TraditionalPipeline(P(cfg), sd, 'cpu', preprocess=True)(frames)
    valid = np.asarray(want.valid)
    assert valid.sum(1).min() > 3
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    for name, tol in (('scores', 1e-5), ('boxes', 1e-5), ('masks', 1e-4)):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g[valid], w[valid], rtol=0, atol=tol,
                                   err_msg=name)
    assert tuple(got.masks.shape[2:]) == (cfg.mask_size, cfg.mask_size)
    assert got.mask_scores is None and want.mask_scores is None
    agree = total = 0
    for b in range(2):
        n = int(valid[b].sum())
        for w_img, h_img in ((160, 120), (97, 131)):
            jboxes = sanitize_boxes_np(np.asarray(want.boxes[b, :n]),
                                       w_img, h_img)
            jpatch = np.asarray(want.masks[b, :n])
            ref = jax_finish_masks_direct(jpatch, jboxes, w_img, h_img)
            same = finish_masks_direct(torch.from_numpy(jpatch), jboxes,
                                       w_img, h_img)
            assert same.dtype == bool and same.shape == (n, h_img, w_img)
            np.testing.assert_array_equal(same, ref)
            boxes = sanitize_boxes_np(got.boxes[b, :n].numpy(), w_img, h_img)
            chain = finish_masks_direct(got.masks[b, :n], boxes, w_img, h_img)
            agree += int((chain == ref).sum())
            total += ref.size
    assert agree >= 0.999 * total, (agree, total)
    # degenerate boxes are skipped; no detections give an empty stack
    patch = np.full((2, cfg.mask_size, cfg.mask_size), 0.9, np.float32)
    out = finish_masks_direct(patch, np.array([[5, 5, 5, 9], [2, 3, 6, 8]]),
                              10, 10)
    assert not out[0].any() and out[1].sum() == 4 * 5
    assert finish_masks_direct(patch[:0], np.zeros((0, 4)), 7, 5).shape == \
        (0, 5, 7)


def _direct_draws(key, b, p):
    """The priorities JAX's direct_mask_loss draws from `key`: one uniform
    row of P per image, from split(key, B) (no split for a mask-IoU cap)."""
    return np.stack([np.asarray(jax.random.uniform(k, (p,)))
                     for k in jax.random.split(key, b)])


@pytest.mark.parametrize('masks_to_train', [100, 3],
                         ids=['all_positives', 'subsampled'])
def test_direct_mask_loss_matches_jax(masks_to_train):
    """multibox_loss of a direct config, every letter and the gradient of
    each prediction within 1e-4 of its largest entry; with fewer slots than
    positives the rescale by positives / slots is taken."""
    cfg = tiny_resnet_config(mask_type=MaskType.DIRECT,
                             masks_to_train=masks_to_train)
    preds, batch = loss_inputs(cfg, seed=3)
    preds.pop('proto')
    preds['mask'] = (1 / (1 + np.exp(-preds['mask'] * 3))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    b, p = preds['mask'].shape[:2]
    pri = _direct_draws(key, b, p)
    diff = ('loc', 'conf', 'mask', 'segm')
    jb = {k: jnp.asarray(t) for k, t in batch.items()}

    def jax_total(d):
        losses, _ = jax_loss.multibox_loss(
            cfg, key, dict(d, priors=jnp.asarray(preds['priors'])), jb)
        return sum(losses.values()), losses

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))({k: jnp.asarray(preds[k]) for k in diff})
    tp = {k: torch.from_numpy(t) for k, t in preds.items()}
    for k in diff:
        tp[k].requires_grad_()
    got, m = loss.multibox_loss(
        P(cfg), tp, {k: torch.from_numpy(t) for k, t in batch.items()},
        torch.from_numpy(pri))
    sum(got.values()).backward()
    assert set(got) == set(want) == {'B', 'C', 'M', 'S'}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in diff:
        w = np.asarray(want_grads[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f'grad {k}')
    assert np.abs(np.asarray(want_grads['mask'])).max() > 0
    pos = m.pos.sum(1)
    assert (int(pos.max()) > masks_to_train) == (masks_to_train == 3)


def test_direct_train_step_matches_jax():
    """One train_step of a tiny direct config from JAX's weights, batch and
    key: every loss within 1e-4 relative, every gradient (through the SGD
    momentum buffer) within 1e-3 of its largest entry and, against the
    port's float64 run, within 1e-4 (batch statistics: flax with its
    two-pass variance, as tests/test_torch_train.py runs it)."""
    import flax.linen

    from test_torch_inputs import make_train_batch
    from test_torch_train import _float64_grads

    class BatchNorm(flax.linen.BatchNorm):
        use_fast_variance: bool = False

    cfg = tiny_resnet_config(mask_type=MaskType.DIRECT, masks_to_train=8)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(flax.linen, 'BatchNorm', BatchNorm)
        model, jstate = jax_create_train_state(cfg, seed=0)
        batch = make_train_batch(np.random.RandomState(4), cfg)
        key = jax.random.PRNGKey(7)
        jnew, jlosses = jax.jit(
            lambda s, b, r: jax_train_step(cfg, model, s, b, r))(
                jstate, batch, key)
    p = 3 * sum((128 // s) ** 2 for s in (8, 16, 32, 64, 128))
    draws = (torch.from_numpy(_direct_draws(key, 2, p)),
             torch.rand(2 * cfg.masks_to_train))
    state = _port_state(cfg, jstate)
    losses = apply_gradients(state, loss_and_grads(state, batch, *draws))
    assert losses['finite'] and set(jlosses) == set(losses) - {'finite'}
    assert 'M' in losses
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    bufs = {k: state.optimizer.state[q]['momentum_buffer']
            for k, q in state.model.named_parameters()}
    old = _numpy(jstate.params), _numpy(jstate.batch_stats)
    got = {k: v for k, v in _leaves(
        state_dict_to_train_state(bufs, *old)[0]).items() if v is not None}
    want = _leaves(jnew.opt_state[1].trace)
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        if name.endswith("['conv2']['bias']"):
            continue
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    ref = _float64_grads(cfg, jstate, batch, draws, pytest.MonkeyPatch())
    for k, q in state.model.named_parameters():
        err = float((q.grad - ref[k]).abs().max()
                    / ref[k].abs().max().clamp(min=1e-12))
        assert err < 1e-4, (k, err)
    assert float(state.model.prediction_layers[0].mask_layer.weight.grad
                 .abs().max()) > 0


CLI_CONFIGS = {'tinydirect': dict(mask_type=MaskType.DIRECT),
               'tinyoptions': 'every'}


@pytest.mark.parametrize('name', list(CLI_CONFIGS))
def test_cli_train_and_eval_match_jax(tmp_path, capsys, name):
    """A short cli/train run (two iterations on a tiny COCO set, then the
    saved .pth) and cli/eval's mAP table of JAX's weights against JAX's
    evaluation of the same weights: the same all_maps dict."""
    root = tmp_path / 'coco'
    root.mkdir()
    img_dir, json_path = _write_tiny_coco(root)
    opts = CLI_CONFIGS[name]
    opts = _options(tmp_path)[opts] if isinstance(opts, str) else opts
    cfg = tiny_resnet_config().copy(**opts)
    cfg = cfg.copy(name=name, max_iter=2, dataset=cfg.dataset.copy(
        train_images=img_dir, train_info=json_path, valid_images=img_dir,
        valid_info=json_path, class_names=('thing', 'b', 'c', 'd'),
        label_map=None))
    jax_register_config(cfg)
    register_config(P(cfg))
    summary = cli_train.train([
        f'--config={name}', '--cuda=False', '--no_autoscale',
        '--batch_size=2', '--num_workers=1', '--max_gt=8',
        '--validation_epoch=100',
        f'--save_folder={tmp_path}/w/', f'--log_folder={tmp_path}/log/'])
    assert summary['iteration'] == 2
    assert all(np.isfinite(v) for e in summary['losses']
               for v in e['loss'].values())
    assert os.path.exists(summary['path'])

    v = _sparse_variables(cfg, bias=2.0)
    sd = jax_variables_to_state_dict(P(cfg), v)
    pth = tmp_path / f'{name}_1_100.pth'
    torch.save(sd, pth)
    capsys.readouterr()
    cli_eval.main([f'--trained_model={pth}', '--cuda=False', '--no_bar',
                   f'--ap_data_file={tmp_path}/ap.pkl'])
    printed = capsys.readouterr().out
    want = jax_evaluate_dataset(cfg, v, make_eval_dataset(P(cfg)),
                                quiet=True)
    got = evaluate_dataset(P(cfg), sd, make_eval_dataset(P(cfg)), 'cpu',
                           quiet=True)
    assert got == want
    assert 'box |' in printed and 'mask |' in printed
    assert json.dumps(got)
