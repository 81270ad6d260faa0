"""The port's train step (``yolact_tpu_torch.train.step``, ``.schedule``,
``data/coco.py``'s batch helpers) against the JAX package's, on the tiny
configs, float32 on the CPU, the port on its kernels' plain versions.

Both sides start one step from the same weights (the JAX ``TrainState``
converted by ``convert/from_jax.train_state_to_state_dict``), the same batch
and the same random draws (``test_torch_loss.jax_draws`` repeats the JAX
loss's ``jax.random`` calls).  Tolerances: each loss letter 1e-4 relative
(the two frameworks sum the convolutions in another order); every momentum
buffer after the first step, which is the gradient plus weight decay, and
every gradient derived from it, within 1e-3 of that tensor's largest entry;
every updated parameter within lr times that, plus float32 rounding of the
parameter; batch-norm running statistics within 1e-4, the tolerance of the
models' forward (``test_torch_model.py``).

Batch norm on batch statistics makes the comparison delicate in three
ways, each measured against a float64 run of the port (``_float64_grads``):

* flax computes the batch variance as E[x^2] - E[x]^2, and the backward of
  that form loses about (mean / std)^2 float32 ulps: on the tiny base config
  its backbone gradients lie up to 6.5e-2 of a tensor's largest entry from
  the float64 run where the port's lie within 1e-5
  (``test_float64_witness_sides_with_the_port`` asserts it).  So the
  batch-statistics cases run flax with its two-pass variance
  (``use_fast_variance=False``, the same function, patched in by the test;
  the ``freeze_bn`` cases run flax as it ships);
* a ReLU input within float32 rounding of zero (about one in a million here)
  takes another sign in another implementation, and that one element moves
  every gradient upstream by 1e-3 to 1e-1 of its largest entry, in JAX, in the
  port and in either against float64.  The batch seeds of the two
  batch-statistics cases are ones where no sign differs; there the port, flax
  (two-pass) and the float64 run agree entry by entry within 2e-5;
* a DCN block multiplies the rounding error of its offsets by the slope of
  the sampled map, and a batch norm over the few values of the tiny last
  stages divides by a small deviation: with offset convs of scale 0.1 the
  tiny DCN config's float32 forward lies 5e-3 to 8e-3 from its float64 run
  by the last stage and its gradients are rounding noise.  The batch-statistics DCN case
  therefore seeds the offset convs' weights at scale 0.01 (biases at 1, so
  the samples still lie off the grid and every DCN gradient is exercised);
  the ``freeze_bn`` DCN cases keep 0.1.

Every case holds every gradient entry by entry within 1e-3, and the
batch-statistics cases also hold the port within 1e-4 of the float64 run."""

import jax
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import (cv2_generic, make_train_batch,  # noqa: F401
                              seed_offsets_jax)
from test_torch_loss import jax_draws
from yolact_tpu.train import schedule as jax_schedule
from yolact_tpu.train.step import create_train_state as jax_create_train_state
from yolact_tpu.train.step import train_step as jax_train_step
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import (state_dict_to_train_state,
                                               train_state_to_state_dict)
from yolact_tpu_torch.models.layers import BatchNorm2d
from yolact_tpu_torch.train import schedule
from yolact_tpu_torch.train.step import (apply_gradients, create_train_state,
                                         loss_and_grads, train_step)

torch.set_num_threads(2)


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_state(cfg, seed=0, w_scale=0.1):
    model, state = jax_create_train_state(cfg, seed=seed)
    if cfg.use_maskiou:       # DCN configs: offsets off the grid
        params = _numpy(state.params)
        seed_offsets_jax({'params': params['model']}, seed=1,
                         w_scale=w_scale, b_scale=1.0)
        state = state.replace(params=params)
    return model, state


def _port_state(cfg, jstate, step=0):
    sd = train_state_to_state_dict(P(cfg), _numpy(jstate.params),
                                   _numpy(jstate.batch_stats))
    state = create_train_state(P(cfg), device='cpu', state_dict=sd)
    state.step = step
    return state


def _step_inputs(cfg, seed=0, step=0, w_scale=0.1):
    """(JAX model, JAX state, batch, key, the key's draws as tensors)."""
    model, jstate = _jax_state(cfg, w_scale=w_scale)
    jstate = jstate.replace(step=np.asarray(step, np.int32))
    batch = make_train_batch(np.random.RandomState(seed), cfg)
    key = jax.random.PRNGKey(7)
    p = 3 * sum((128 // s) ** 2 for s in (8, 16, 32, 64, 128))
    draws = [torch.from_numpy(a.copy())
             for a in jax_draws(key, 2, p, cfg.masks_to_train)]
    return model, jstate, batch, key, draws


def _one_step_both(cfg, seed=0, step=0, inputs=None):
    """(JAX state before, JAX state after, JAX losses, port state after,
    port losses) for one step from the same weights, batch and draws."""
    model, jstate, batch, key, draws = \
        inputs or _step_inputs(cfg, seed, step)
    jnew, jlosses = jax.jit(
        lambda s, b, r: jax_train_step(cfg, model, s, b, r))(jstate, batch,
                                                             key)
    state = _port_state(cfg, jstate, step)
    losses = loss_and_grads(state, batch, *draws)
    losses = apply_gradients(state, losses)
    return jstate, jnew, jlosses, state, losses


def _float64_grads(cfg, jstate, batch, draws, monkeypatch):
    """The port's gradients by name from a float64 run of the same forward,
    loss and backward: the witness of which float32 side is the accurate
    one.  The port widens to float32 by name (``.float()``); for this run
    the name means float64."""
    from yolact_tpu_torch.train.loss import multibox_loss
    from yolact_tpu_torch.train.step import batch_to_device, model_input
    state = _port_state(cfg, jstate)
    state.model.double()
    state.model.compute_dtype = torch.float64
    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, 'float', torch.Tensor.double)
        tensors = batch_to_device(
            dict(batch, image=batch['image'].astype(np.float64)), 'cpu')
        preds = state.model(model_input(P(cfg), tensors['image']),
                            train=True)
        losses, _ = multibox_loss(
            P(cfg), preds, tensors, *[d.double() for d in draws],
            maskiou_net=state.model.maskiou_net, num_gts=batch['num_gts'])
        sum(losses.values()).backward()
    return {k: p.grad for k, p in state.model.named_parameters()
            if p.grad is not None}


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture
def two_pass_variance(monkeypatch):
    """flax batch norm with the variance as mean((x - mean)^2)."""
    import flax.linen

    class BatchNorm(flax.linen.BatchNorm):
        use_fast_variance: bool = False

    monkeypatch.setattr(flax.linen, 'BatchNorm', BatchNorm)


@pytest.mark.parametrize('make_cfg,overrides,seed,w_scale', [
    (tiny_resnet_config, {}, 4, None), (tiny_plus_config, {}, 11, 0.01),
    (tiny_resnet_config, {'freeze_bn': True}, 0, None),
    (tiny_plus_config, {'freeze_bn': True}, 0, 0.1),
    (tiny_resnet_config, {'stem_s2d': True, 'freeze_bn': True}, 0, None),
    (tiny_plus_config, {'train_remat': 'none', 'freeze_bn': True}, 0, 0.1)],
    ids=['base', 'plus', 'base_frozen_bn', 'plus_frozen_bn',
         'base_s2d_frozen_bn', 'plus_no_remat_frozen_bn'])
def test_train_step_matches_jax(make_cfg, overrides, seed, w_scale, request,
                                monkeypatch):
    cfg = make_cfg(**overrides)
    if not cfg.freeze_bn:
        request.getfixturevalue('two_pass_variance')
    inputs = _step_inputs(cfg, seed, w_scale=w_scale)
    jold, jnew, jlosses, state, losses = _one_step_both(cfg, inputs=inputs)
    assert losses['finite'] and state.step == int(jnew.step) == 1
    assert set(losses) - {'finite'} == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)

    sd = state.model.state_dict()
    bufs = {k: state.optimizer.state[p]['momentum_buffer']
            for k, p in state.model.named_parameters() if p.requires_grad}
    old = _numpy(jold.params), _numpy(jold.batch_stats)
    got_params, got_stats = state_dict_to_train_state(sd, *old)
    got_bufs, _ = state_dict_to_train_state(bufs, *old)
    want_bufs = _leaves(jnew.opt_state[1].trace)
    want_params, old_params = _leaves(jnew.params), _leaves(jold.params)
    lr = float(jlosses['lr'])
    got_bufs = {k: v for k, v in _leaves(got_bufs).items() if v is not None}
    frozen = {k for k in want_bufs if cfg.freeze_bn and "['bn']" in k}
    assert want_bufs.keys() - frozen == got_bufs.keys()
    for name, got in got_bufs.items():
        want = want_bufs[name]
        if name.endswith("['conv2']['bias']") and not cfg.freeze_bn:
            # a DCN bias right before a batch norm on batch statistics,
            # which subtracts it again: the gradient is zero but for
            # rounding on both sides (the other gradients are O(0.1-10))
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-4, name
            continue
        tol = max(np.abs(want).max(), 1e-6) * 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f'momentum {name}')
        # the gradients themselves: the buffer less the weight decay
        decay = cfg.decay * old_params[name]
        np.testing.assert_allclose(got - decay, want - decay, rtol=0,
                                   atol=tol, err_msg=f'grad {name}')
        new = _leaves(got_params)[name]
        np.testing.assert_allclose(
            new, want_params[name], rtol=0, err_msg=f'param {name}',
            atol=lr * tol + 1e-6 * np.abs(want_params[name]).max())
        assert np.abs(want_params[name] - old_params[name]).max() > 0 or \
            np.abs(want).max() == 0, name
    for name in frozen:       # JAX: zero update; the port: never touched
        np.testing.assert_array_equal(_leaves(got_params)[name],
                                      old_params[name])
        np.testing.assert_array_equal(want_params[name], old_params[name])
    for name, got in _leaves(got_stats).items():
        np.testing.assert_allclose(got, _leaves(jnew.batch_stats)[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the stem and, for the DCN config, the offset convs got a gradient
    assert float(bufs['backbone.conv1.weight'].abs().max()) > 0
    for k, b in bufs.items():
        if 'conv_offset_mask' in k:
            assert float(b.abs().max()) > 0, k
    if not cfg.freeze_bn:
        # batch statistics: the float64 witness (found: 2e-5 of the largest
        # entry at most)
        ref = _float64_grads(cfg, jold, inputs[2], inputs[4], monkeypatch)
        grads = {k: p.grad for k, p in state.model.named_parameters()
                 if p.grad is not None}
        assert grads.keys() == ref.keys()
        for k, g in grads.items():
            if k.endswith('conv2.bias'):     # zero but for rounding, as above
                continue
            err = float((g - ref[k]).abs().max() /
                        ref[k].abs().max().clamp(min=1e-12))
            assert err < 1e-4, (k, err)


def test_float64_witness_sides_with_the_port(monkeypatch):
    """flax as it ships (one-pass batch variance), the port and a float64 run
    of the port on the tiny base config, batch statistics: every gradient of
    the port within 1e-4 of the witness tensor's largest entry (found 1e-5),
    JAX's backbone gradients at least ten times farther off in some tensor
    and more than 1e-3 (found 6.5e-2).  This is why the parity test above runs
    flax with its two-pass variance."""
    cfg = tiny_resnet_config()
    inputs = _step_inputs(cfg, seed=4)
    jold, jnew, _, state, _ = _one_step_both(cfg, inputs=inputs)
    ref = _float64_grads(cfg, jold, inputs[2], inputs[4], monkeypatch)
    old = _numpy(jold.params), _numpy(jold.batch_stats)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    trees = [state_dict_to_train_state(g, *old)[0] for g in (grads, ref)]
    got, witness = [{k: v for k, v in _leaves(t).items() if v is not None}
                    for t in trees]
    bufs, params = _leaves(jnew.opt_state[1].trace), _leaves(jold.params)
    port_err, jax_err = {}, {}
    for name, w in witness.items():
        top = max(np.abs(w).max(), 1e-12)
        port_err[name] = np.abs(got[name] - w).max() / top
        jax_grad = bufs[name] - cfg.decay * params[name]
        jax_err[name] = np.abs(jax_grad - w).max() / top
    assert max(port_err.values()) < 1e-4, port_err
    worst = max((k for k in jax_err if 'backbone' in k), key=jax_err.get)
    print('float64 witness: port', max(port_err.values()), 'jax',
          jax_err[worst], worst)
    assert jax_err[worst] > 1e-3
    assert jax_err[worst] > 10 * max(port_err.values())


def test_freeze_bn_matches_jax():
    """Frozen batch norm: running statistics, scale and bias do not move
    (no weight decay either) while the convs train; losses as JAX's."""
    cfg = tiny_resnet_config(freeze_bn=True)
    jold, jnew, jlosses, state, losses = _one_step_both(cfg, seed=1)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    for name, m in state.model.named_modules():
        if isinstance(m, BatchNorm2d):
            assert m.pending is None and m.weight.grad is None
            assert bool((m.weight == 1).all()) and bool((m.bias == 0).all())
            assert bool((m.running_mean == 0).all())
            assert bool((m.running_var == 1).all())
    got, _ = state_dict_to_train_state(
        state.model.state_dict(), _numpy(jold.params),
        _numpy(jold.batch_stats))
    want, old = _leaves(jnew.params), _leaves(jold.params)
    name = "['model']['backbone']['conv1']['conv']['kernel']"
    np.testing.assert_allclose(_leaves(got)[name], want[name], rtol=0,
                               atol=1e-6)
    assert np.abs(want[name] - old[name]).max() > 0


def test_lr_follows_resumed_step_as_jax():
    cfg = tiny_resnet_config()
    _, _, jlosses, state, losses = _one_step_both(cfg, step=600)
    assert losses['lr'] == pytest.approx(float(jlosses['lr']), rel=1e-6)
    assert losses['lr'] == pytest.approx(cfg.lr) and state.step == 601
    assert state.optimizer.param_groups[0]['lr'] == losses['lr']


@pytest.fixture(scope='module')
def port_trainer():
    cfg = P(tiny_resnet_config())
    return cfg, make_train_batch(np.random.RandomState(0), cfg)


def test_three_steps_reduce_the_loss(port_trainer):
    cfg, batch = port_trainer
    state = create_train_state(cfg, seed=0, device='cpu')
    gen = torch.Generator().manual_seed(0)
    totals = [float(train_step(state, batch, gen)['total'])
              for _ in range(3)]
    assert np.isfinite(totals).all() and totals[-1] < totals[0], totals
    assert state.step == 3


def test_train_step_is_seeded(port_trainer):
    cfg, batch = port_trainer
    cfg = cfg.copy(masks_to_train=1)     # sub-sampling: the draws matter
    outs = []
    for seed in (0, 0, 1):
        state = create_train_state(cfg, seed=0, device='cpu')
        outs.append(float(train_step(
            state, batch, torch.Generator().manual_seed(seed))['M']))
    assert outs[0] == outs[1] != outs[2]


def test_non_finite_step_changes_nothing_but_the_count(port_trainer):
    cfg, batch = port_trainer
    state = create_train_state(cfg, seed=0, device='cpu')
    gen = torch.Generator().manual_seed(0)
    train_step(state, batch, gen)            # momentum and statistics exist
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    bufs = [state.optimizer.state[p]['momentum_buffer'].clone()
            for p in state.model.parameters()]
    bad = dict(batch, image=batch['image'].copy())
    bad['image'][0, 5, 5, 0] = np.nan
    out = train_step(state, bad, gen)
    assert not out['finite'] and not np.isfinite(float(out['total']))
    assert state.step == 2
    after = state.model.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert all(torch.equal(state.optimizer.state[p]['momentum_buffer'], b)
               for p, b in zip(state.model.parameters(), bufs))
    assert all(m.pending is None for m in state.model.modules()
               if isinstance(m, BatchNorm2d))
    # and the next good step trains again
    assert train_step(state, batch, gen)['finite'] and state.step == 3


def test_class_balanced_conf_state_accumulates(port_trainer):
    cfg, batch = port_trainer
    state = create_train_state(cfg.copy(use_class_balanced_conf=True),
                               device='cpu')
    gen = torch.Generator().manual_seed(0)
    train_step(state, batch, gen)
    first = float(state.conf_state['total'])
    assert first > 0 and float(state.conf_state['class_counts'].sum()) == \
        pytest.approx(first)
    train_step(state, batch, gen)
    assert float(state.conf_state['total']) > first


def test_unported_step_options_raise(port_trainer):
    cfg, batch = port_trainer
    gen = torch.Generator().manual_seed(0)
    state = create_train_state(cfg, device='cpu')
    with pytest.raises(NotImplementedError, match='A6b'):
        train_step(state, dict(batch, gt_masks_packed=0), gen)
    state.model.set_compute_dtype(torch.bfloat16)   # cast for inference
    with pytest.raises(ValueError, match='master weights'):
        train_step(state, batch, gen)
    state = create_train_state(cfg.copy(use_device_augment=True),
                               device='cpu')
    with pytest.raises(NotImplementedError, match='A9'):
        train_step(state, batch, gen)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            create_train_state(cfg)          # the default device is the card


@pytest.mark.parametrize('step', [0, 1, 250, 499, 500, 279999, 280000,
                                  600000, 750000])
def test_learning_rate_matches_jax(step):
    for cfg in (tiny_resnet_config(),
                tiny_resnet_config(lr_warmup_until=0, lr_steps=())):
        assert schedule.learning_rate(P(cfg), step) == pytest.approx(
            float(jax_schedule.learning_rate(cfg, step)), rel=1e-6)


def test_schedule_helpers_match_jax():
    cfg = tiny_resnet_config(delayed_settings=(
        (10, (('lr', 0.5),)), (20, (('gamma', 0.3), ('lr', 0.25)))))
    for batch_size in (8, 16, 4, 12):
        got = schedule.scale_config_for_batch(P(cfg), batch_size)
        want = jax_schedule.scale_config_for_batch(cfg, batch_size)
        assert got == P(want)
    assert schedule.scale_config_for_batch(P(cfg), 8) is not None
    port = P(cfg)
    assert schedule.apply_delayed_settings(port, 9) is port
    for it in (10, 19, 20, 1000):
        got = schedule.apply_delayed_settings(port, it)
        want = jax_schedule.apply_delayed_settings(cfg, it)
        assert got == P(want)
        assert schedule.apply_delayed_settings(got, it) is got


def _ragged_samples(rng, n_img, counts, crowds, size=32):
    imgs, targets, masks = [], [], []
    for n in counts:
        imgs.append(rng.rand(size, size, 3).astype(np.float32))
        xy = rng.rand(n, 2) * 0.5
        t = np.concatenate([xy, xy + rng.rand(n, 2) * 0.4 + 0.05,
                            rng.randint(0, 4, (n, 1))], 1)
        targets.append(t.astype(np.float32))
        masks.append(rng.rand(n, size, size).astype(np.float32))
    for t, c in zip(targets, crowds):
        if c:
            t[-c:, 4] = -1
    return imgs, targets, masks


@pytest.mark.parametrize('multires', [None, {'proto': (8, 8), 'seg': (4, 4)},
                                      {'proto': (8, 8), 'seg': None}],
                         ids=['full_res', 'multires', 'multires_no_seg'])
def test_pad_batch_matches_jax(rng, multires):
    """Padding, the crowd-first truncation and the multires targets, which
    the port returns unpacked: equal to the unpacked bits of JAX's."""
    from yolact_tpu.data import coco as jax_coco
    from yolact_tpu.ops.bits import unpack_bits_last
    from yolact_tpu_torch.data import coco
    counts, crowds = (3, 7, 5, 0), (1, 3, 0, 0)
    imgs, targets, masks = _ragged_samples(rng, 4, counts, crowds)
    samples = [(i, (t, m, c)) for i, t, m, c in zip(imgs, targets, masks,
                                                    crowds)]
    got_c, want_c = coco.detection_collate(samples), \
        jax_coco.detection_collate(samples)
    assert all(np.array_equal(a, b) for a, b in zip(got_c[0], want_c[0]))
    for a, b in zip(got_c[1], want_c[1]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for max_gt in (8, 5, 3):
        got = coco.pad_batch(imgs, targets, masks, crowds, max_gt, multires)
        want = jax_coco.pad_batch(imgs, targets, masks, crowds, max_gt,
                                  multires)
        for name in ('proto', 'seg'):
            packed = want.pop(f'gt_masks_{name}_packed', None)
            if packed is not None:
                want[f'gt_masks_{name}'] = np.asarray(unpack_bits_last(
                    packed, multires[name][1]))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_enforce_size_matches_jax(rng, cv2_generic):
    from yolact_tpu.data import coco as jax_coco
    from yolact_tpu_torch.data import coco
    img = rng.rand(40, 60, 3).astype(np.float32)
    masks = (rng.rand(2, 40, 60) > 0.5).astype(np.float32)
    targets = np.array([[0.1, 0.2, 0.5, 0.6, 1], [0.3, 0.3, 0.9, 0.8, 2]],
                       np.float32)
    for new_w, new_h in ((48, 48), (60, 40), (30, 64)):
        got = coco.enforce_size(img, targets, masks, 0, new_w, new_h)
        want = jax_coco.enforce_size(img, targets, masks, 0, new_w, new_h)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[:2] == (new_h, new_w)
