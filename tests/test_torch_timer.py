"""The port's span and counter recorder (``yolact_tpu_torch/utils/timer.py``)
on the CPU: the span tree, exclusive host time, per-thread stacks,
counters, the root bound, the eval loop's table, what a span costs with
recording off (mocks, not timings), spans under ``torch.export``, and the
spans and counters of a ``Pipeline`` call, a train step and the trainer's
iteration.  Device ms are read from stand-in CUDA events here; the card
test is ``test_torch_cuda.py::test_spans_bracket_kernels_and_cover_the_call``.
"""

import contextlib
import io
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_inputs import (SyntheticTrainSet, make_train_batch,
                               tiny_plus_config, tiny_resnet_config)
from yolact_tpu.utils import timer as jax_timer
from yolact_tpu_torch.cli import train as cli
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.data.augmentations import SSDAugmentation
from yolact_tpu_torch.data.loader import BatchLoader
from yolact_tpu_torch.infer import Pipeline, random_state_dict
from yolact_tpu_torch.train.step import create_train_state, train_step
from yolact_tpu_torch.utils import timer

torch.set_num_threads(2)

CALL_CHILDREN = ['input', 'preprocess', 'backbone', 'fpn', 'heads', 'detect',
                 'masks', 'maskiou']


@pytest.fixture(autouse=True)
def fresh():
    timer.reset()
    yield
    timer.reset()


class Clock:
    """A host clock that moves only when told to (ns)."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(timer.time, 'perf_counter_ns', c)
    return c


class FakeEvent:
    """A CUDA timing event on a stand-in device clock."""

    device_now = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = FakeEvent.device_now[0]

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.device_now[0] = 0.0
    monkeypatch.setattr(torch.cuda, 'Event', FakeEvent)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None: None)
    return FakeEvent.device_now


def test_span_tree_parents_and_root_ids():
    with timer.recording():
        for _ in range(2):
            with timer.span('call'):
                with timer.span('backbone'):
                    pass
                with timer.span('detect'):
                    with timer.span('detect.fits_read'):
                        pass
        with timer.span('lone'):
            pass
    roots = timer.roots()
    assert [r.name for r in roots] == ['call', 'call', 'lone']
    assert len({r.id for r in roots}) == 3
    for r in roots[:2]:
        names = [s.name for s in r.spans]
        parents = [s.parent.name if s.parent else None for s in r.spans]
        assert names == ['call', 'backbone', 'detect', 'detect.fits_read']
        assert parents == [None, 'call', 'call', 'detect']
        assert all(s.root is r for s in r.spans)
        assert all(s.device_ms is None for s in r.spans)   # no CUDA device
    assert timer.dropped() == 0


def test_exclusive_host_time(clock):
    with timer.recording():
        with timer.span('call'):
            clock.now += 5_000_000
            with timer.span('backbone'):
                clock.now += 20_000_000
                with timer.span('inner'):
                    clock.now += 3_000_000
            clock.now += 2_000_000
            with timer.span('detect'):
                clock.now += 1_000_000
    (root,) = timer.roots()
    by = {s.name: s for s in root.spans}
    assert by['call'].host_ms == 31 and by['call'].self_host_ms == 7
    assert by['backbone'].host_ms == 23 and by['backbone'].self_host_ms == 20
    assert by['inner'].self_host_ms == 3 and by['detect'].self_host_ms == 1
    # the reference timer's totals: exclusive, summing to the root's span
    assert timer._total == {'call': 0.007, 'backbone': 0.02, 'inner': 0.003,
                            'detect': 0.001}
    assert timer.total_time() == pytest.approx(0.031)


def test_env_keeps_the_reference_contract(clock):
    with timer.env('outer'):
        clock.now += 50_000_000
        with timer.env('inner'):
            clock.now += 50_000_000
        clock.now += 20_000_000
    assert timer._total == {'outer': 0.07, 'inner': 0.05}
    assert timer.roots() == []            # not recording: nothing kept
    timer.start('a')
    timer.start('b')
    with pytest.raises(RuntimeError, match="stop\\('a'\\)"):
        timer.stop('a')                   # 'b' is open
    timer.stop('b')
    timer.stop()
    with pytest.raises(RuntimeError):
        timer.stop('a')                   # nothing open
    timer.reset()
    assert not timer._total and timer.total_time() == 0


def test_each_thread_has_its_own_stack():
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with timer.span(f'{tag}.root'):
                barrier.wait()
                for i in range(50):
                    with timer.span(f'{tag}.{i}'):
                        with timer.span(f'{tag}.{i}.leaf'):
                            pass
                barrier.wait()
        except Exception as e:            # noqa: BLE001 - reported below
            errors.append(e)

    with timer.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in 'ab']
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    roots = sorted(timer.roots(), key=lambda r: r.name)
    assert [r.name for r in roots] == ['a.root', 'b.root']
    for r, tag in zip(roots, 'ab'):
        assert len(r.spans) == 101
        for s in r.spans[1:]:
            assert s.name.startswith(tag + '.')
            want = s.name[:-len('.leaf')] if s.name.endswith('.leaf') \
                else f'{tag}.root'
            assert s.parent.name == want


def test_counters_are_kept_per_root():
    with timer.recording():
        timer.count('host_syncs')          # outside any frame: not kept
        for i in range(3):
            with timer.span('call'):
                with timer.span('detect'):
                    timer.count('host_syncs')
                    timer.count('nms_candidates', torch.tensor(10 * i))
                timer.count('host_syncs', 2)
    roots = timer.roots()
    assert [r.counter('host_syncs') for r in roots] == [3, 3, 3]
    assert [r.counter('nms_candidates') for r in roots] == [0, 10, 20]
    assert roots[0].counter('never') is None


def test_copies_are_counted_by_kind(monkeypatch):
    frames = np.zeros((2, 4, 5, 3), np.uint8)
    with timer.recording():
        with timer.span('call'):
            timer.count_copy(frames, 'cuda:0')
            timer.count_copy(torch.zeros(10), 'cuda')
            timer.count_copy(frames, 'cpu')          # no copy to a card
    (root,) = timer.roots()
    assert root.counter('h2d_bytes') == 120 + 40
    assert root.counter('h2d_pageable_bytes') == 160
    monkeypatch.setattr(torch.Tensor, 'is_pinned', lambda self: True)
    with timer.recording():
        with timer.span('call'):
            timer.count_copy(torch.zeros(10), 'cuda')
    (root,) = timer.roots()
    assert root.counter('h2d_bytes') == 40
    assert root.counter('h2d_pageable_bytes') is None


def test_the_first_roots_are_kept_and_the_rest_counted():
    extra = 7
    with timer.recording():
        for i in range(timer.MAX_ROOTS + extra):
            with timer.span('call'):
                with timer.span('x'):
                    timer.count('n', i)
    roots = timer.roots()
    assert len(roots) == timer.MAX_ROOTS == 1024
    assert timer.dropped() == extra
    assert [r.counter('n') for r in roots] == list(range(1024))
    assert [r.id for r in roots] == sorted(r.id for r in roots)
    # a new recording starts again from none
    with timer.recording():
        with timer.span('call'):
            pass
    assert len(timer.roots()) == 1 and timer.dropped() == 0


def _table():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        timer.print_stats()
    return buf.getvalue()


def test_print_stats_table_is_the_reference_table(clock):
    steps = [('Network', 31_000_000), ('Postprocess', 4_500_000),
             ('Main loop', 12_250_000), ('JSON Output', 0)]
    for name, ns in steps * 2:
        with timer.env(name):
            clock.now += ns
    jax_timer.reset()
    jax_timer.disable_all(False)
    for name, _ in steps:
        jax_timer._total[name] = timer._total[name]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_timer.print_stats()
    jax_timer.reset()
    assert _table() == buf.getvalue()
    assert 'Device' not in _table()
    timer.reset()
    assert _table() == ' No timing data \n'


def test_device_ms_and_the_tables_device_column(clock, fake_cuda):
    with timer.recording():
        with timer.env('Network'):                 # a host frame
            with timer.span('call', 'cuda:0'):
                fake_cuda[0] += 1.0
                with timer.span('backbone'):
                    fake_cuda[0] += 20.0
                    clock.now += 1_000_000
                with timer.span('detect'):
                    fake_cuda[0] += 2.5
                fake_cuda[0] += 0.5
    (root,) = timer.roots()
    assert root.name == 'Network'
    assert root.device_ms('Network') is None
    assert root.device_ms('call') == 24.0
    assert root.device_ms('backbone') == 20.0
    assert root.device_ms('detect') == 2.5
    assert root.device_ms('masks') is None
    assert root.spans[2].device == torch.device('cuda:0')     # inherited
    assert timer.device_totals() == {'call': 1.5, 'backbone': 20.0,
                                     'detect': 2.5}
    lines = _table().splitlines()
    assert lines[1].endswith('| Time (ms) | Device (ms)')
    row = {ln.split('|')[0].strip(): ln for ln in lines[3:-3]}
    assert row['call'].endswith('|        1.50')
    assert row['backbone'].endswith('|       20.00')
    assert row['Network'].endswith('0.00')       # no device cell


def test_recording_off_costs_a_check(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError('called with recording off')

    monkeypatch.setattr(torch.profiler, 'record_function', forbidden)
    monkeypatch.setattr(torch.cuda, 'Event', forbidden)
    monkeypatch.setattr(torch.cuda, 'synchronize', forbidden)
    monkeypatch.setattr(torch.cuda, 'current_stream', forbidden)
    assert not timer.active()
    off = timer.span('call', 'cuda:0')
    assert off is timer.span('backbone') is timer._OFF   # nothing allocated
    with off:
        with timer.span('detect'):
            timer.count('host_syncs')
            timer.count_copy(np.zeros(4), 'cuda')
    assert timer.roots() == [] and timer._total == {}
    # a whole Pipeline call and a train step open no range and no event
    cfg = tiny_plus_config(nms_candidates=256)
    pipe = Pipeline(cfg, random_state_dict(cfg, torch.Generator()
                                           .manual_seed(0)), 'cpu')
    pipe(np.zeros((1, 64, 80, 3), np.uint8))
    state = create_train_state(tiny_resnet_config(), device='cpu')
    train_step(state, make_train_batch(np.random.RandomState(0), state.cfg),
               torch.Generator().manual_seed(0))
    assert timer.roots() == [] and timer._total == {}


def test_recording_under_the_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert timer.active()
        with timer.span('call'):
            with timer.span('backbone'):
                torch.ones(3).sum()
    assert [s.name for s in timer.roots()[0].spans] == ['call', 'backbone']
    annotated = {e.name for e in prof.events()
                 if getattr(e, 'is_user_annotation', False)}
    assert {'call', 'backbone'} <= annotated
    assert not timer.active()


class _Layered(torch.nn.Module):
    def forward(self, x):
        with timer.span('call', x.device):
            with timer.span('backbone'):
                y = x * 2
            timer.count('host_syncs')
            with timer.span('heads'):
                return y + 1


@pytest.mark.parametrize('strict', [False, True])
def test_spans_are_inert_under_export(strict):
    with timer.recording():
        ep = torch.export.export(_Layered(), (torch.ones(2, 3),),
                                 strict=strict)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert not any('profiler' in t or 'record_function' in t
                   for t in targets), targets
    assert timer.roots() == []
    # the exported program runs, and eager calls still record
    assert torch.equal(ep.module()(torch.ones(2, 3)), torch.full((2, 3), 3.))
    with timer.recording():
        _Layered()(torch.ones(2, 3))
    assert [s.name for s in timer.roots()[0].spans] == ['call', 'backbone',
                                                         'heads']


def test_exported_pipeline_has_no_profiler_op(tmp_path):
    from yolact_tpu_torch.convert.export import export_inference
    cfg = tiny_resnet_config(nms_candidates=256)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    with timer.recording():
        export_inference(cfg, sd, str(tmp_path / 'x.pt2'), device='cpu')
    ep = torch.export.load(str(tmp_path / 'x.pt2'))
    targets = {str(n.target) for n in ep.graph.nodes}
    assert not any('profiler' in t for t in targets)
    assert 'yolact_tpu_torch.mask_assembly.default' in targets
    assert timer.roots() == []


def test_pipeline_call_spans_and_counters():
    cfg = tiny_plus_config(nms_candidates=256)
    pipe = Pipeline(cfg, random_state_dict(cfg, torch.Generator()
                                           .manual_seed(0)), 'cpu')
    frames = np.random.RandomState(0).randint(0, 256, (2, 64, 80, 3),
                                              dtype=np.uint8)
    with timer.recording():
        pipe(frames)
        pipe(frames)
    roots = timer.roots()
    assert [r.name for r in roots] == ['call', 'call']
    for r in roots:
        top = [s.name for s in r.spans if s.parent is r.spans[0]]
        assert top == CALL_CHILDREN
        fits = [s for s in r.spans if s.name == 'detect.fits_read']
        assert len(fits) == 1 and fits[0].parent.name == 'detect'
        assert r.counter('host_syncs') == 1
        assert r.counter('h2d_bytes') is None         # no card: no copy
        assert r.device_ms('call') is None
        child_ms = sum(s.host_ms for s in r.spans if s.parent is r.spans[0])
        assert child_ms <= r.spans[0].host_ms
    # nms_candidates: priors past conf_thresh, summed over the batch
    from yolact_tpu_torch.detect.detection import eval_scores
    with torch.inference_mode():
        from yolact_tpu_torch.infer import _prepare_input
        x = _prepare_input(pipe.cfg, torch.as_tensor(frames), True)
        scores = eval_scores(pipe.cfg, pipe.model(x))[..., 1:]
    want = int((scores.max(-1).values > cfg.nms_conf_thresh).sum())
    assert [r.counter('nms_candidates') for r in roots] == [want, want]


def test_train_step_spans():
    state = create_train_state(tiny_plus_config(), device='cpu')
    batch = make_train_batch(np.random.RandomState(0), state.cfg)
    with timer.recording():
        train_step(state, batch, torch.Generator().manual_seed(0))
    (root,) = timer.roots()
    top = [s.name for s in root.spans if s.parent is root.spans[0]]
    assert top == ['draws', 'input', 'augment', 'forward', 'loss',
                   'backward', 'finite_read', 'optimizer']
    parent = {s.name: s.parent.name for s in root.spans[1:]}
    assert parent['backbone'] == parent['fpn'] == parent['heads'] == 'forward'
    assert parent['match'] == 'loss'
    assert root.counter('host_syncs') == 1


def test_trainer_iteration_is_the_root(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    cfg = tiny_resnet_config().copy(name='timer_iteration', max_iter=3,
                                    lr_warmup_until=0)
    register_config(cfg)
    data = SyntheticTrainSet(4, ((70, 90), (80, 80)), cfg.num_classes,
                             SSDAugmentation(cfg), seed=1)
    with timer.recording():
        run = cli.train(['--config', cfg.name, '--batch_size', '2',
                         '--no_autoscale', '--save_folder',
                         str(tmp_path / 'w'), '--log_folder',
                         str(tmp_path / 'l'), '--num_workers', '1',
                         '--max_gt', '8', '--cuda=False'], dataset=data)
    assert run['iteration'] == 3
    iters = [r for r in timer.roots() if r.name == 'iteration']
    assert len(iters) == 3
    for r in iters:
        top = [s.name for s in r.spans if s.parent is r.spans[0]]
        assert top == ['loader_wait', 'step']
        ready = r.counter('loader_ready')
        assert ready is not None and ready >= 0


def test_loader_ready_counts_batches_waiting():
    from test_torch_loader import _FakeDataset
    loader = BatchLoader(_FakeDataset(8), 2, max_gt=4, num_workers=2,
                         shuffle=False)
    try:
        loader.next_batch()
        for _ in range(200):              # let the workers fill the queue
            if loader._batch_queue.qsize() + len(loader._hold) >= 2:
                break
            threading.Event().wait(0.01)
        with timer.recording():
            with timer.span('iteration'):
                loader.next_batch()
        (root,) = timer.roots()
        assert root.counter('loader_ready') >= 2
    finally:
        loader.stop()
