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
from yolact_tpu_torch.convert.from_jax import (_torch_key, _walk,
                                               jax_variables_to_state_dict)
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


def _variables(cfg, seed=0, train=False):
    """JAX variables for Yolact(cfg); for YOLACT++ configs also the mask
    scorer's (under 'maskiou', where convert_state_dict puts it) and
    non-zero DCN offset convs.  `train`: initialised with train=True, which
    is when flax creates the training-only heads a reference .pth holds."""
    if train:
        v = JaxYolact(cfg).init(
            jax.random.PRNGKey(seed),
            jnp.zeros((1, cfg.max_size, cfg.max_size, 3)), train=True)
    else:
        v = random_variables(cfg, seed=seed)
    v = jax.tree_util.tree_map(np.array, dict(v))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    if cfg.use_maskiou:
        v['maskiou'] = _maskiou_variables(cfg, seed)
        seed_offsets_jax(v, seed)
    return v


def test_weights_round_trip_and_strict_load():
    cfg = tiny_resnet_config()
    v = _variables(cfg, train=True)
    sd = jax_variables_to_state_dict(P(cfg), v)
    Yolact(P(cfg)).load_state_dict(sd, strict=True)
    # an eval tree lacks the training-only heads; the converter adds
    # initial ones, the same every time, so that it loads strictly too
    eval_sd = jax_variables_to_state_dict(P(cfg), _variables(cfg))
    assert eval_sd.keys() == sd.keys()
    again = jax_variables_to_state_dict(P(cfg), _variables(cfg))
    assert torch.equal(eval_sd['semantic_seg_conv.weight'],
                       again['semantic_seg_conv.weight'])
    assert float(eval_sd['semantic_seg_conv.weight'].abs().max()) > 0
    with pytest.raises(RuntimeError, match='Missing key'):
        Yolact(P(cfg)).load_state_dict(
            {k: t for k, t in sd.items() if 'semantic_seg' not in k})
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
                                    train=True))
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
    v = _variables(cfg, train=True)
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
                                    train=True))
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


def _train_variables(cfg, seed=0):
    """JAX variables of the training model (the two training-only heads
    included); DCN offset convs seeded non-zero."""
    v = JaxYolact(cfg).init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 128, 128, 3)), train=True)
    v = jax.tree_util.tree_map(np.array, dict(v))
    if cfg.use_maskiou:
        v['maskiou'] = _maskiou_variables(cfg, seed)
        # offsets of a pixel or so, nearly independent of the input: a DCN
        # block multiplies the float32 rounding of its offsets by the slope
        # of the sampled map, and the batch norms of the tiny last stages
        # (8 values per channel) divide by a small deviation, so with the
        # eval tests' offset convs the float32 forward itself is 5e-3 off a
        # float64 run (tests/test_torch_train.py's docstring)
        seed_offsets_jax(v, seed, w_scale=0.01, b_scale=1.0)
    return v


def _jax_train_forward(cfg, v, x, bn_train, float64=False):
    """JAX's forward(train=True) -> (outputs, new batch_stats) as float64
    numpy; `float64` runs it in float64 (x64 on, weights and input widened,
    compute dtype float64)."""
    variables = {k: v[k] for k in ('params', 'batch_stats')}
    mutable = ['batch_stats'] if bn_train else False
    if not float64:
        out = JaxYolact(cfg).apply(variables, jnp.asarray(x), train=True,
                                   mutable=mutable)
    else:
        with jax.enable_x64(True):
            variables = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
            out = JaxYolact(cfg.copy(compute_dtype='float64')).apply(
                variables, jnp.asarray(x, jnp.float64), train=True,
                mutable=mutable)
    want, stats = out if bn_train else (out, v)
    as64 = lambda t: jax.tree_util.tree_map(      # noqa: E731
        lambda a: np.asarray(a, np.float64), t)
    return as64(dict(want)), as64(stats['batch_stats'])


def _hold_to_float64(name, got, want, got64, want64):
    """The float64 yardstick of the train-forward test, per output: the two
    float64 runs agree within 1e-6 of the output's largest entry (the
    formulas are the same: a wrong epsilon, variance or layout fails
    here), and the float32 port lies within twice JAX float32's own
    distance from the float64 result, plus 1e-6 of that largest entry (its
    rounding is no worse than JAX's)."""
    got, want, got64, want64 = (np.asarray(a, np.float64)
                                for a in (got, want, got64, want64))
    top = float(np.abs(got64).max())
    formula = float(np.abs(want64 - got64).max())
    d_port = float(np.abs(got - got64).max())
    d_jax = float(np.abs(want - got64).max())
    assert formula <= 1e-6 * top, (name, formula, top)
    assert d_port <= 2 * d_jax + 1e-6 * top, (name, d_port, d_jax, top)


@pytest.mark.parametrize('make_cfg,overrides', [
    (tiny_resnet_config, {}),
    (tiny_resnet_config, {'use_class_existence_loss': True}),
    (tiny_resnet_config, {'freeze_bn': True}),
    (tiny_plus_config, {}),
], ids=['base', 'class_existence', 'freeze_bn', 'plus'])
def test_train_forward_matches_jax(rng, make_cfg, overrides, monkeypatch):
    """forward(train=True): batch-statistics batch norm (running statistics
    under freeze_bn), the segm and classes outputs in JAX's layouts, and the
    next running statistics (flax stores the biased batch variance; so does
    the port).

    The yardstick is measured here, not fixed: the same weights and input
    run through the port and JAX in float64 as well
    (``_hold_to_float64``).  A fixed 1e-4 failed on some hosts: flax
    computes the batch variance in one pass, E[x^2] - E[x]^2, which loses
    about (mean / std)^2 float32 ulps, so JAX float32 lies about four
    times further from the float64 result than the port does (segm 1.04e-4
    against 2.5e-5 of a largest entry near 8 on the tiny base config), and
    one segm element near 0.016 once came 1.0484e-4 from the port.  The
    tiny DCN config is held by the same rule (its float64 runs agree within
    2e-7 of the largest entry: JAX samples at float32 offsets)."""
    from yolact_tpu_torch.models.layers import (BatchNorm2d,
                                                commit_batch_stats)
    cfg = make_cfg(**overrides)
    v = _train_variables(cfg, seed=4)
    x = rng.randn(2, 128, 128, 3).astype(np.float32)
    bn_train = not cfg.freeze_bn
    want, new_stats = _jax_train_forward(cfg, v, x, bn_train)
    want64, new_stats64 = _jax_train_forward(cfg, v, x, bn_train,
                                             float64=True)
    assert ('classes' in want) == cfg.use_class_existence_loss
    assert want['segm'].shape == (2, 16, 16, cfg.num_classes - 1)

    model = Yolact(P(cfg))
    sd = jax_variables_to_state_dict(P(cfg), v)
    model.load_state_dict(sd, strict=True)
    assert {'semantic_seg_conv.weight', 'semantic_seg_conv.bias'} <= set(sd)
    assert ('class_existence_fc.weight' in sd) == \
        cfg.use_class_existence_loss
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    model64 = Yolact(P(cfg))
    model64.load_state_dict(sd, strict=True)
    model64.double().set_compute_dtype(torch.float64, cast_weights=False)
    with monkeypatch.context() as patch:
        # the port widens to float32 by name (DCN offsets); here that is
        # float64
        patch.setattr(torch.Tensor, 'float', torch.Tensor.double)
        got64 = model64(torch.from_numpy(x.astype(np.float64))
                        .permute(0, 3, 1, 2), train=True)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _hold_to_float64(k, got[k].detach(), want[k], got64[k].detach(),
                         want64[k])
    # the forward leaves the new statistics pending; the buffers move on
    # commit, and not at all under freeze_bn
    before = {k: t.clone() for k, t in model.state_dict().items()}
    assert all(torch.equal(t, before[k])
               for k, t in model.state_dict().items())
    n_bn = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    assert commit_batch_stats(model) == (n_bn if bn_train else 0)
    commit_batch_stats(model64)
    # the converter's keys, the values as they are (it casts to float32)
    want_sd, want_sd64 = ({_torch_key(path): a for path, a in _walk(s)}
                          for s in (new_stats, new_stats64))
    after, after64 = model.state_dict(), model64.state_dict()
    moved = 0
    for k in want_sd:
        _hold_to_float64(k, after[k], want_sd[k], after64[k], want_sd64[k])
        moved += not torch.equal(after[k], before[k])
    assert moved == (len(want_sd) if bn_train else 0)
    assert commit_batch_stats(model) == 0
    # the eval forward runs neither training-only head
    with torch.no_grad():
        assert not {'segm', 'classes'} & set(
            model(torch.from_numpy(x).permute(0, 3, 1, 2)))


def test_batch_norm_running_variance_is_biased_like_flax(rng):
    """One layer: F.batch_norm would store the unbiased batch variance
    (n / (n - 1) larger); flax and the port store the biased one."""
    from yolact_tpu.models.layers import BatchNorm as JaxBatchNorm
    from yolact_tpu_torch.models.layers import (BatchNorm2d,
                                                commit_batch_stats)
    x = (rng.randn(2, 3, 3, 4) * 2 + 1).astype(np.float32)
    bn = JaxBatchNorm()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    want, new = bn.apply(v, jnp.asarray(x), train=True,
                         mutable=['batch_stats'])
    layer = BatchNorm2d(4)
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    commit_batch_stats(layer)
    stats = new['batch_stats']['bn']
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(stats['mean']), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(stats['var']), rtol=1e-6, atol=1e-7)
    biased = 0.9 + 0.1 * x.reshape(-1, 4).var(0)
    np.testing.assert_allclose(layer.running_var.numpy(), biased, rtol=1e-5)
    unbiased = 0.9 + 0.1 * x.reshape(-1, 4).var(0, ddof=1)
    assert np.all(np.abs(layer.running_var.numpy() - unbiased) > 1e-3)


@pytest.mark.parametrize('remat', ['dcn', 'all'])
def test_train_remat_gives_the_grads_of_none(rng, remat):
    """Checkpointed bottlenecks (cfg.train_remat): the same state dict
    keys, outputs, gradients and pending batch-norm statistics as without,
    and the DCN sampler's forward runs once more per checkpointed block."""
    from yolact_tpu_torch.kernels import dcn
    from yolact_tpu_torch.models.layers import BatchNorm2d
    x = torch.from_numpy(rng.randn(1, 3, 128, 128).astype(np.float32))
    cfgs = {r: P(tiny_plus_config(train_remat=r)) for r in ('none', remat)}
    sd = jax_variables_to_state_dict(
        cfgs['none'], _train_variables(tiny_plus_config(), seed=2))
    results = {}
    calls = {}
    orig = dcn.dcn_columns_plain
    for r, cfg in cfgs.items():
        model = Yolact(cfg)
        model.load_state_dict(sd, strict=True)
        count = [0]

        def counted(*a, **kw):
            count[0] += 1
            return orig(*a, **kw)

        dcn.dcn_columns_plain = counted
        try:
            out = model(x, train=True)
            loss = sum((t.float() ** 2).sum() * 1e-6 for k, t in out.items()
                       if k != 'priors')
            loss.backward()
        finally:
            dcn.dcn_columns_plain = orig
        calls[r] = count[0]
        results[r] = (float(loss), {k: p.grad for k, p in
                                    model.named_parameters()
                                    if p.grad is not None},
                      [m.pending for m in model.modules()
                       if isinstance(m, BatchNorm2d)])
    assert calls == {'none': 3, remat: 6}       # three DCN blocks
    (l0, g0, s0), (l1, g1, s1) = results['none'], results[remat]
    assert l0 == l1 and g0.keys() == g1.keys()
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g0[k].abs().max()),
                                   err_msg=k)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(s0, s1))
    with pytest.raises(ValueError, match='train_remat'):
        Yolact(P(tiny_plus_config(train_remat='dnc')))(x, train=True)
