"""The port's trainer (``python -m yolact_tpu_torch.cli.train``) on the CPU,
and its bfloat16 step against the JAX package's.

* The CLI over the tiny COCO set of ``tests/test_eval.py`` with
  ``--cuda=False``: a run interrupted by SIGINT after its sixth step, then
  ``--resume interrupt`` to the end of the schedule with ``--keep_latest``
  and mid-run validation, then ``--resume latest`` for two more, then a
  reference ``.pth`` (weights only) as ``--resume``.  The checkpoint names,
  what ``--keep_latest`` prunes and the ``Log`` entries (their types, keys
  and order) are what ``yolact_tpu/cli/train.py:240-350`` and
  ``utils/logger.py`` set out for the same flags, worked out by hand
  below.  (The JAX CLI itself is not run here: its jit costs minutes.)
* The trainer on in-memory data with cv2 made unimportable: augmentation,
  loader, step, checkpoint and validation need no cv2.
* One bfloat16 step over float32 master weights (``compute_dtype``, the s2d
  stem, frozen batch norm) against JAX's ``train_step`` with
  ``compute_dtype='bfloat16'`` from the same weights, batch and draws.
  bfloat16 keeps 8 mantissa bits (a rounding is 2^-9 relative), and the two
  frameworks round in different places (JAX sums some losses and bias
  gradients in bfloat16, the port widens the predictions to float32 first),
  so the step is held to: each loss letter within 1e-2 relative (found
  3.3e-3 in S); the parameters, momentum and gradients float32; the update
  of all the parameters together within 0.1 relative L2 of JAX's (found
  0.051); and the port's bfloat16 update within 0.1 relative L2, tensor by
  tensor, of the port's float32 step from the same inputs (found 0.045;
  JAX's bfloat16 update lies up to 0.28 from it, in the biases it sums in
  bfloat16).
"""

import json
import signal
import sys

import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from test_eval import _write_tiny_coco
from test_torch_inputs import SyntheticEvalSet, SyntheticTrainSet
from yolact_tpu_torch.cli import train as cli
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.data.augmentations import SSDAugmentation
from yolact_tpu_torch.train import step as step_module
from yolact_tpu_torch.train.checkpoint import read_checkpoint

torch.set_num_threads(2)


def _config(name, **kw):
    cfg = tiny_resnet_config()
    return cfg.copy(name=name, lr_warmup_until=0, **kw)


def _files(folder):
    import os
    return sorted(os.listdir(folder))


def _args(name, save, logs, *extra):
    return ['--config', name, '--batch_size', '2', '--no_autoscale',
            '--save_folder', save, '--log_folder', logs, '--num_workers', '2',
            '--max_gt', '8', '--cuda=False', *extra]


def test_cli_saves_interrupts_resumes_and_validates(tmp_path, monkeypatch):
    img_dir, json_path = _write_tiny_coco(tmp_path, n_images=4, size=96)
    cfg = _config('clitorch', max_iter=12)
    data = cfg.dataset.copy(train_images=img_dir, train_info=json_path,
                            valid_images=img_dir, valid_info=json_path,
                            class_names=('thing', 'b', 'c', 'd'),
                            label_map=None)
    register_config(P(cfg.copy(dataset=data)))
    save, logs = str(tmp_path / 'weights'), str(tmp_path / 'logs')

    # run 1: SIGINT after the 6th step -> the loop stops there and saves
    # the interrupt state.  4 images at batch 2: 2 iterations an epoch
    real_step = step_module.train_step

    def step_then_interrupt(state, batch, generator):
        out = real_step(state, batch, generator)
        if state.step == 6:
            signal.raise_signal(signal.SIGINT)
        return out

    monkeypatch.setattr(step_module, 'train_step', step_then_interrupt)
    handler = signal.getsignal(signal.SIGINT)
    run = cli.train(_args('clitorch', save, logs, '--save_interval', '4',
                          '--keep_latest', '--validation_epoch', '2'))
    monkeypatch.setattr(step_module, 'train_step', real_step)
    assert signal.getsignal(signal.SIGINT) is handler     # restored
    assert run['iteration'] == 6 and run['maps'] is None
    assert _files(save) == ['clitorch_1_4.pth',
                            'clitorch_2_6_interrupt.pth']
    assert read_checkpoint(P(cfg), run['path'])['step'] == 6

    # run 2: --resume interrupt continues at iteration 6: validation after
    # epochs 2 and 4 (iterations 6 and 10) and at the end, a loss line at
    # 10, saves at 8 and 12, --keep_latest prunes 8 when 12 is saved (the
    # interrupt state is never pruned)
    run = cli.train(_args('clitorch', save, logs, '--save_interval', '4',
                          '--keep_latest', '--validation_epoch', '2',
                          '--resume', 'interrupt'))
    assert run['start_iter'] == 6 and run['iteration'] == 12
    assert run['state'].step == 12
    assert _files(save) == ['clitorch_1_4.pth', 'clitorch_2_6_interrupt.pth',
                            'clitorch_5_12.pth']
    assert set(run['maps']) == {'box', 'mask'}

    # run 3: --resume latest (iteration 12) for two more
    register_config(P(cfg.copy(dataset=data, max_iter=14)))
    run = cli.train(_args('clitorch', save, logs, '--validation_epoch', '0',
                          '--resume', 'latest'))
    assert run['start_iter'] == 12 and run['state'].step == 14
    assert run['losses'] == [] and run['maps'] is None
    assert 'clitorch_6_14.pth' in _files(save)
    saved = read_checkpoint(P(cfg), run['path'])
    # batch 2 freezes batch norm: the optimizer trains the rest
    params = {k: p for k, p in run['state'].model.named_parameters()
              if p.requires_grad}
    assert saved['param_names'] == list(params)
    assert all(torch.equal(run['state'].optimizer.state[params[name]]
                           ['momentum_buffer'].cpu(), m['momentum_buffer'])
               for name, m in zip(saved['param_names'],
                                  saved['optimizer']['state'].values()))

    # a reference .pth (weights only) resumes at the step its name gives,
    # with a fresh optimizer
    torch.save(saved['model'], str(tmp_path / 'clitorch_49_98.pth'))
    register_config(P(cfg.copy(dataset=data, max_iter=100)))
    run = cli.train(_args('clitorch', save, logs, '--validation_epoch', '0',
                          '--no_log', '--resume',
                          str(tmp_path / 'clitorch_49_98.pth')))
    assert run['start_iter'] == 98 and run['state'].step == 100
    assert run['log'] is None and 'clitorch_49_100.pth' in _files(save)

    # the log: run 1's session, then run 2's (appended, as a resumed run
    # does), then run 3's
    with open(str(tmp_path / 'logs' / 'clitorch.log')) as f:
        entries = [json.loads(line) for line in f]
    assert [(e['type'], e['data'].get('iter')) for e in entries] == [
        ('session', None), ('session', None), ('val', 6), ('train', 10),
        ('val', 10), ('val', 12), ('session', None)]
    for e in entries:
        assert list(e) == ['type', 'session', 'data'] + \
            (['env'] if e['type'] == 'session' else []) + ['time']
    assert list(entries[0]['data']) == ['args', 'config_name']
    assert list(entries[0]['env']) == ['python', 'platform', 'argv']
    train_entry = entries[3]['data']
    assert list(train_entry) == ['loss', 'lr', 'epoch', 'iter', 'elapsed']
    assert list(train_entry['loss']) == ['B', 'M', 'C', 'S']
    assert train_entry['epoch'] == 4
    assert [list(e['data']) for e in entries if e['type'] == 'val'] == \
        [['box', 'mask', 'epoch', 'iter', 'elapsed']] * 3
    assert [e['data']['epoch'] for e in entries if e['type'] == 'val'] == \
        [2, 4, 5]


def test_unported_flags_raise():
    """What the trainer refuses: --distributed outside torchrun's
    environment (it is ported: tests/test_torch_parallel.py), and a
    spatial split without it, one process having no ranks to split the
    image over (the split runs: tests/test_torch_spatial.py::
    test_cli_spatial_split_trains_and_resumes)."""
    for flag, error, match in (
            (['--distributed'], RuntimeError, 'environment'),
            (['--spatial_split', '2'], ValueError, '--distributed')):
        with pytest.raises(error, match=match):
            cli.train(['--cuda=False'] + flag)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            cli.train([])               # the default device is the card


def test_device_augment_trains_and_resumes(tmp_path, monkeypatch):
    """``--device_augment`` on in-memory frames through ``RawResize``: the
    loader ships uint8 images and packed full-resolution masks, the step
    augments them; 3 iterations, then ``--resume latest`` for 2 more."""
    from yolact_tpu_torch.data.augmentations import RawResize
    shipped = []
    real_step = step_module.train_step

    def spy(state, batch, generator, **kw):
        shipped.append({k: (str(v.dtype).replace('torch.', ''),
                            tuple(v.shape)) for k, v in batch.items()
                        if hasattr(v, 'dtype')})
        return real_step(state, batch, generator, **kw)

    monkeypatch.setattr(step_module, 'train_step', spy)
    cfg = P(_config('clidevaug', max_iter=3, augment_random_flip=True))
    register_config(cfg)
    data = SyntheticTrainSet(4, ((70, 90), (90, 70)), cfg.num_classes,
                             RawResize(cfg), seed=1)
    save, logs = str(tmp_path / 'w'), str(tmp_path / 'logs')
    argv = _args('clidevaug', save, logs, '--device_augment',
                 '--validation_epoch', '0')
    run = cli.train(argv, dataset=data)
    assert run['iteration'] == 3 and run['state'].cfg.use_device_augment
    S = cfg.max_size
    assert shipped[0]['image'] == ('uint8', (2, S, S, 3))
    assert shipped[0]['gt_masks_packed'] == ('uint8', (2, 8, S, S // 8))
    assert not any(k.startswith('gt_masks_proto') for k in shipped[0])
    register_config(cfg.copy(max_iter=5))
    again = cli.train(argv + ['--resume', 'latest'], dataset=data)
    assert again['start_iter'] == 3 and again['iteration'] == 5
    assert again['state'].step == 5
    sd = again['state'].model.state_dict()
    assert all(bool(torch.isfinite(v).all()) for v in sd.values()
               if v.is_floating_point())


def test_trainer_needs_no_cv2(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    cfg = P(_config('clinocv2', max_iter=4, augment_random_flip=True))
    register_config(cfg)
    train = SyntheticTrainSet(5, ((70, 90), (90, 70), (80, 80)),
                              cfg.num_classes, SSDAugmentation(cfg), seed=1)
    val = SyntheticEvalSet(3, cfg.max_size, cfg.num_classes, seed=2)
    run = cli.train(_args('clinocv2', str(tmp_path / 'w'),
                          str(tmp_path / 'logs'), '--validation_epoch', '1'),
                    dataset=train, val_dataset=val)
    assert run['iteration'] == 4 and set(run['maps']) == {'box', 'mask'}
    assert len(run['iter_seconds']) == len(run['wait_seconds']) == 4
    assert all(np.isfinite(v) for e in run['losses']
               for v in e['loss'].values())


def test_bf16_step_matches_jax():
    import jax
    from test_torch_train import _one_step_both, _port_state, _step_inputs
    from yolact_tpu_torch.convert.from_jax import train_state_to_state_dict
    from yolact_tpu_torch.train.step import apply_gradients, loss_and_grads

    cfg = tiny_resnet_config(compute_dtype='bfloat16', stem_s2d=True,
                             freeze_bn=True)
    inputs = _step_inputs(cfg, seed=0)
    jold, jnew, jlosses, state, losses = _one_step_both(cfg, inputs=inputs)
    assert state.model.compute_dtype == torch.bfloat16 and losses['finite']
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-2, err_msg=k)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(s['momentum_buffer'].dtype == torch.float32
               for s in state.optimizer.state.values())

    f32 = _port_state(cfg.copy(compute_dtype='float32'), jold)
    apply_gradients(f32, loss_and_grads(f32, inputs[2], *inputs[4]))

    def port(tree):
        return train_state_to_state_dict(
            P(cfg), *[jax.tree_util.tree_map(np.array, t) for t in tree])

    before = port((jold.params, jold.batch_stats))
    want = port((jnew.params, jnew.batch_stats))
    got, got32 = state.model.state_dict(), f32.model.state_dict()
    num = den = 0.0
    for k in before:
        update = got[k] - before[k]
        num += float(((want[k] - before[k]) - update).norm()) ** 2
        den += float((want[k] - before[k]).norm()) ** 2
        update32 = got32[k] - before[k]
        if float(update32.norm()) > 0:
            err = float((update - update32).norm() / update32.norm())
            assert err <= 0.1, (k, err)
    assert (num / den) ** 0.5 <= 0.1


def test_log_matches_jax(tmp_path):
    """utils/logger.py writes the JAX package's JSONL entries: the session
    header, then each entry with its type, session and data; the
    visualizer reads them back."""
    from yolact_tpu.utils.logger import Log as JaxLog
    from yolact_tpu_torch.utils.logger import Log, LogVisualizer
    files = {}
    for side, cls in (('port', Log), ('jax', JaxLog)):
        log = cls('run', str(tmp_path / side), {'config_name': 'run'},
                  overwrite=True, log_time=False)
        log.log('train', loss={'B': 1.0, 'C': 2.0}, lr=1e-3, epoch=0, iter=10,
                elapsed=0.5)
        log.log('val', box={'all': 0.0}, mask={'all': 0.0}, epoch=0, iter=10,
                elapsed=1.0)
        with open(log.path) as f:
            files[side] = [json.loads(line) for line in f]
    for got, want in zip(files['port'], files['jax']):
        got.pop('session'), want.pop('session')
        assert got == want
    viz = LogVisualizer()
    viz.load(str(tmp_path / 'port' / 'run.log'))
    assert viz.query('data.loss.C', 'train') == [2.0]
    # --log_gpu: the card's memory per entry (none on a machine without one)
    log = Log('gpu', str(tmp_path / 'gpu'), {}, log_gpu_stats=True)
    log.log('train', iter=1)
    with open(log.path) as f:
        entry = [json.loads(line) for line in f][-1]
    assert isinstance(entry['accelerators'], list)
    if torch.cuda.is_available():
        assert {'memory_allocated', 'max_memory_allocated'} <= \
            set(entry['accelerators'][0])
