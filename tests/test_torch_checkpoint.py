"""Checkpoints of the port (``yolact_tpu_torch/train/checkpoint.py``), its
msgpack reader (``convert/msgpack.py``) and the JAX ``.ckpt`` import
(``convert/from_jax.py:jax_checkpoint_to_port``), against the JAX package.

* A port checkpoint round-trips bit for bit: weights, batch-norm
  statistics, every momentum buffer, ``conf_state`` and the step; a step
  from the reloaded state on a fixed batch and fixed draws equals, bit for
  bit, the same step from the state that was saved.
* ``SavePath``, ``resolve_resume``, ``iteration_from_path`` and
  ``prune_previous_checkpoint`` behave as the JAX package's on the same
  file names (the cases of ``tests/test_loader_checkpoint_regressions.py:
  107``).
* The msgpack reader gives ``flax.serialization.msgpack_restore``'s tree of
  a JAX train state, leaf for leaf, and raises on what it does not read.
* A JAX train state saved by ``yolact_tpu.train.checkpoint`` with a
  non-zero momentum trace resumes in the port with its weights, momentum
  and step, and the port's next step matches JAX's next ``train_step``
  from the same batch and ``jax.random`` draws within PR 6's tolerances
  (``tests/test_torch_train.py``): each loss letter 1e-4 relative, every
  momentum buffer within 1e-3 of its largest entry, every parameter within
  the learning rate times that plus float32 rounding.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import make_train_batch
from test_torch_loss import jax_draws
from yolact_tpu.train import checkpoint as jax_ckpt
from yolact_tpu.train.step import create_train_state as jax_create_train_state
from yolact_tpu.train.step import train_step as jax_train_step
from yolact_tpu.utils.functions import SavePath as JaxSavePath
from yolact_tpu_torch.convert import msgpack
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import (jax_checkpoint_to_port,
                                               state_dict_to_train_state,
                                               train_state_to_state_dict)
from yolact_tpu_torch.train import checkpoint as ckpt
from yolact_tpu_torch.train.step import create_train_state, train_step
from yolact_tpu_torch.utils.functions import SavePath

torch.set_num_threads(2)


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _momentum(state):
    return {k: state.optimizer.state[p]['momentum_buffer']
            for k, p in state.model.named_parameters()
            if 'momentum_buffer' in state.optimizer.state.get(p, {})}


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ma, mb = _momentum(a), _momentum(b)
    assert ma.keys() == mb.keys() and ma
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert a.step == b.step
    assert (a.conf_state is None) == (b.conf_state is None)
    if a.conf_state is not None:
        assert all(torch.equal(a.conf_state[k], b.conf_state[k])
                   for k in a.conf_state)


def test_checkpoint_round_trip_and_resumed_step_bit_equal(tmp_path):
    cfg = P(tiny_plus_config(use_class_balanced_conf=True))
    batch = make_train_batch(np.random.RandomState(0), cfg)
    state = create_train_state(cfg, device='cpu')
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        assert train_step(state, batch, gen)['finite']
    path = SavePath(cfg.name, 0, 2, ext='.pth').get_path(str(tmp_path))
    ckpt.save_checkpoint(state, path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]   # no .tmp left
    resumed = create_train_state(cfg, seed=1, device='cpu')
    ckpt.load_checkpoint(path, resumed)
    _assert_states_equal(resumed, state)
    assert float(state.conf_state['total']) > 0

    # the next step, from each, on the same batch and draws
    outs = [train_step(s, batch, torch.Generator().manual_seed(9))
            for s in (state, resumed)]
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0]
               if isinstance(outs[0][k], torch.Tensor))
    _assert_states_equal(resumed, state)

    # the weights of a train state serve eval (--trained_model)
    weights = ckpt.load_weights(cfg, path)
    assert weights.keys() == torch.load(path)['state_dict'].keys()
    # weights alone do not resume a train state
    torch.save(weights, str(tmp_path / 'ref_1_2.pth'))
    with pytest.raises(ValueError, match='weights only'):
        ckpt.load_checkpoint(str(tmp_path / 'ref_1_2.pth'), resumed)


@pytest.mark.parametrize('make_cfg', [tiny_resnet_config, tiny_plus_config],
                         ids=['base', 'plus'])
def test_port_checkpoint_reads_as_jax_weights(tmp_path, make_cfg):
    """A checkpoint the port's trainer writes is a weights file the JAX
    package reads: ``yolact_tpu.train.checkpoint.load_weights`` gives the
    JAX variables of the same weights (``convert/from_jax``'s inverse of
    the port's state dict), every leaf equal, and its converter leaves no
    key of the file unhandled (the training-only heads included)."""
    from yolact_tpu.convert.torch_import import load_reference_weights
    jcfg = make_cfg()
    cfg = P(jcfg)
    state = create_train_state(cfg, device='cpu')
    assert train_step(state, make_train_batch(np.random.RandomState(0), cfg),
                      torch.Generator().manual_seed(0))['finite']
    path = str(tmp_path / 'tiny_0_1.pth')
    ckpt.save_checkpoint(state, path)
    got = jax_ckpt.load_weights(jcfg, path)
    assert load_reference_weights(jcfg, path)[1] == []
    _, template = jax_create_train_state(jcfg)
    params, stats = state_dict_to_train_state(
        state.model.state_dict(), _numpy(template.params),
        _numpy(template.batch_stats))
    want = {'params': params['model'], 'batch_stats': stats}
    if 'maskiou' in params:
        want['maskiou'] = {'params': params['maskiou']}
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_checkpoint_of_the_older_layout_resumes_bit_for_bit(tmp_path):
    """A checkpoint written before the weights moved under 'state_dict'
    (the weights under 'model') resumes to the same state, and the next
    step from it equals the next step from the state that was saved."""
    cfg = P(tiny_resnet_config(use_class_balanced_conf=True))
    batch = make_train_batch(np.random.RandomState(0), cfg)
    state = create_train_state(cfg, device='cpu')
    assert train_step(state, batch, torch.Generator().manual_seed(3))['finite']
    path = str(tmp_path / 'tiny_0_1.pth')
    ckpt.save_checkpoint(state, path)
    blob = torch.load(path, weights_only=False)
    blob['model'] = blob.pop('state_dict')
    torch.save(blob, path)
    resumed = create_train_state(cfg, seed=1, device='cpu')
    ckpt.load_checkpoint(path, resumed)
    _assert_states_equal(resumed, state)
    outs = [train_step(s, batch, torch.Generator().manual_seed(9))
            for s in (state, resumed)]
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0]
               if isinstance(outs[0][k], torch.Tensor))
    _assert_states_equal(resumed, state)


NAMES = ['yolact_base_1_100.pth', 'yolact_base_2_200.ckpt',
         'yolact_base_12_3000.pth', 'yolact_plus_base_3_900.pth',
         'yolact_base_2_150_interrupt.pth', 'tiny_1_100.msgpack']


def test_save_path_and_resume_bookkeeping_match_jax(tmp_path):
    for name in NAMES:
        got, want = SavePath.from_str(name), JaxSavePath.from_str(name)
        assert vars(got) == vars(want)
        assert got.get_path('w') == want.get_path('w')
    assert SavePath('a_b', 1, 2).get_path() == JaxSavePath('a_b', 1, 2).get_path()
    for side in ('port', 'jax'):
        (tmp_path / side).mkdir()
        for name in NAMES:
            (tmp_path / side / name).write_bytes(b'x')
    port, jax_dir = str(tmp_path / 'port'), str(tmp_path / 'jax')
    for config in ('yolact_base', 'yolact_plus_base', 'tiny', 'other'):
        got = SavePath.get_latest(port, config)
        want = JaxSavePath.get_latest(jax_dir, config)
        assert (got and os.path.basename(got)) == \
            (want and os.path.basename(want))
        for resume in ('latest', 'interrupt', 'w/x_1_2.pth'):
            got = ckpt.resolve_resume(resume, port, config)
            want = jax_ckpt.resolve_resume(resume, jax_dir, config)
            assert (got and os.path.basename(got)) == \
                (want and os.path.basename(want))
    assert ckpt.iteration_from_path('w/yolact_base_2_150_interrupt.pth') == \
        jax_ckpt.iteration_from_path('w/yolact_base_2_150_interrupt.pth') == 150
    SavePath.remove_interrupt(port)
    JaxSavePath.remove_interrupt(jax_dir)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))


@pytest.mark.parametrize('ext', ['.pth', '.ckpt'])
def test_prune_matches_jax(tmp_path, ext):
    """The cases of test_loader_checkpoint_regressions.py:107, on both."""
    names = [f'tiny_1_100{ext}', f'tiny_2_200{ext}', f'tiny_3_300{ext}',
             f'tiny_2_150_interrupt{ext}']
    calls = [(f'tiny_3_300{ext}', 400, 100, 0),
             (f'tiny_2_150_interrupt{ext}', 400, 100, 0),
             (f'tiny_2_200{ext}', 300, 100, 200),
             (f'tiny_1_100{ext}', 200, 100, 200),
             (None, 500, 100, 0), (f'missing{ext}', 500, 100, 0)]
    left = {}
    for side, prune in (('port', ckpt.prune_previous_checkpoint),
                        ('jax', jax_ckpt.prune_previous_checkpoint)):
        root = tmp_path / side
        root.mkdir()
        for n in names:
            (root / n).write_bytes(b'x')
        left[side] = []
        for latest, *args in calls:
            prune(latest and str(root / latest), *args)
            left[side].append(sorted(os.listdir(root)))
    assert left['port'] == left['jax']
    assert left['port'][-1] == [f'tiny_2_150_interrupt{ext}',
                                f'tiny_2_200{ext}']


@pytest.fixture(scope='module')
def jax_checkpoint(tmp_path_factory):
    """A JAX tiny train state with the mask scorer, class-balanced counts, a
    seeded momentum trace and step 7, saved by the JAX package."""
    cfg = tiny_resnet_config(use_class_balanced_conf=True, use_maskiou=True,
                             maskiou_net=((8, 3, (('stride', 2),)),))
    _, state = jax_create_train_state(cfg, seed=0)
    rng = np.random.RandomState(2)
    trace = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.01).astype(np.float32),
        _numpy(state.opt_state[1].trace))
    state = state.replace(
        step=np.asarray(7, np.int32),
        opt_state=(state.opt_state[0],
                   state.opt_state[1]._replace(trace=trace),
                   state.opt_state[2]),
        conf_state={'class_counts': np.arange(cfg.num_classes,
                                              dtype=np.float32),
                    'total': np.asarray(10.0, np.float32)})
    path = str(tmp_path_factory.mktemp('jax') / 'tiny_0_7.ckpt')
    jax_ckpt.save_checkpoint(state, path)
    return cfg, state, path


def test_msgpack_reader_matches_flax(jax_checkpoint, tmp_path):
    _, _, path = jax_checkpoint
    with open(path, 'rb') as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    got = msgpack.unpackb(blob)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    for k, w in want_leaves.items():
        assert got_leaves[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got_leaves[k], w, err_msg=k)
    # what the reader refuses: flax's chunked arrays, other ext types,
    # truncated and trailing bytes
    import msgpack as reference
    chunked = reference.packb({'w': {'__msgpack_chunked_array__': True}})
    with pytest.raises(ValueError, match='chunked'):
        msgpack.unpackb(chunked)
    with pytest.raises(ValueError, match='ext type 2'):
        msgpack.unpackb(serialization.msgpack_serialize({'c': 1 + 2j}))
    with pytest.raises(ValueError, match='truncated'):
        msgpack.unpackb(blob[:-3])
    with pytest.raises(ValueError, match='trailing'):
        msgpack.unpackb(blob + b'\x00')


def test_jax_checkpoint_converts(jax_checkpoint):
    cfg, state, path = jax_checkpoint
    got = jax_checkpoint_to_port(P(cfg), msgpack.read(path))
    want = train_state_to_state_dict(P(cfg), _numpy(state.params),
                                     _numpy(state.batch_stats))
    assert got['step'] == 7
    assert got['model'].keys() == want.keys()
    assert all(torch.equal(got['model'][k], want[k]) for k in want)
    trace = train_state_to_state_dict(
        P(cfg), _numpy(state.opt_state[1].trace), {})
    params = {k for k, _ in create_train_state(
        P(cfg), device='cpu').model.named_parameters()}
    assert got['momentum'].keys() == params
    assert all(torch.equal(got['momentum'][k], trace[k]) for k in params)
    assert torch.equal(got['conf_state']['class_counts'],
                       torch.arange(5, dtype=torch.float32))
    # and it resumes a port train state (freeze_bn drops the batch norms'
    # buffers from the optimizer, as the port never trains them)
    port = create_train_state(P(cfg.copy(freeze_bn=True)), device='cpu')
    ckpt.load_checkpoint(path, port)
    assert port.step == 7 and float(port.conf_state['total']) == 10.0
    momentum = _momentum(port)
    assert momentum.keys() == {k for k in params
                               if '.bn' not in k and 'downsample.1' not in k}
    assert all(torch.equal(momentum[k], trace[k]) for k in momentum)
    # the weights of a JAX train state serve eval
    weights = ckpt.load_weights(P(cfg), path)
    assert all(torch.equal(weights[k], want[k]) for k in want)


def test_jax_checkpoint_next_step_matches_jax(tmp_path):
    cfg = tiny_resnet_config(freeze_bn=True)
    model, state = jax_create_train_state(cfg, seed=0)
    rng = np.random.RandomState(4)
    trace = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32),
        _numpy(state.opt_state[1].trace))
    state = state.replace(
        step=np.asarray(3, np.int32),
        opt_state=(state.opt_state[0],
                   state.opt_state[1]._replace(trace=trace),
                   state.opt_state[2]))
    path = str(tmp_path / 'tiny_0_3.ckpt')
    jax_ckpt.save_checkpoint(state, path)

    batch = make_train_batch(np.random.RandomState(0), cfg)
    key = jax.random.PRNGKey(7)
    jnew, jlosses = jax.jit(
        lambda s, b, r: jax_train_step(cfg, model, s, b, r))(state, batch,
                                                             key)
    port = create_train_state(P(cfg), device='cpu')
    ckpt.load_checkpoint(path, port)
    assert port.step == 3
    p = 3 * sum((128 // s) ** 2 for s in (8, 16, 32, 64, 128))
    draws = [torch.from_numpy(a.copy())
             for a in jax_draws(key, 2, p, cfg.masks_to_train)]
    from yolact_tpu_torch.train.step import apply_gradients, loss_and_grads
    losses = apply_gradients(port, loss_and_grads(port, batch, *draws))
    assert losses['finite'] and port.step == 4
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    old = _numpy(state.params), _numpy(state.batch_stats)
    got_bufs, _ = state_dict_to_train_state(_momentum(port), *old)
    got_params, _ = state_dict_to_train_state(port.model.state_dict(), *old)
    got_bufs = {k: v for k, v in _leaves(got_bufs).items() if v is not None}
    want_bufs = _leaves(jnew.opt_state[1].trace)
    want_params, got_params = _leaves(jnew.params), _leaves(got_params)
    lr = float(jlosses['lr'])
    assert got_bufs.keys() == {k for k in want_bufs if "['bn']" not in k}
    for name, got in got_bufs.items():
        want = want_bufs[name]
        tol = max(np.abs(want).max(), 1e-6) * 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f'momentum {name}')
        np.testing.assert_allclose(
            got_params[name], want_params[name], rtol=0,
            atol=lr * tol + 1e-6 * np.abs(want_params[name]).max(),
            err_msg=f'param {name}')


def test_cli_resumes_jax_checkpoint(jax_checkpoint, tmp_path):
    """``cli/train --resume <JAX train state>.ckpt``: a run started by the
    JAX trainer carries on in the port at its step, with its class counts."""
    from test_torch_inputs import SyntheticTrainSet
    from yolact_tpu_torch.cli.train import train
    from yolact_tpu_torch.config import register_config
    from yolact_tpu_torch.data.augmentations import SSDAugmentation
    cfg, _, path = jax_checkpoint
    cfg = register_config(P(cfg.copy(name='jaxresume', max_iter=9)))
    data = SyntheticTrainSet(4, ((96, 128),), cfg.num_classes,
                             SSDAugmentation(cfg), seed=3)
    run = train(['--config', 'jaxresume', '--batch_size', '2', '--cuda=False',
                 '--no_autoscale', '--save_folder', str(tmp_path), '--no_log',
                 '--num_workers', '1', '--validation_epoch', '0',
                 '--resume', path], dataset=data)
    assert run['start_iter'] == 7 and run['state'].step == 9
    assert float(run['state'].conf_state['total']) > 10.0
    assert os.path.basename(run['path']) == 'jaxresume_4_9.pth'
