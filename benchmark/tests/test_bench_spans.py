"""The readers of the program's spans and counters (``spans.py`` and the
``program_span`` / ``program_counter`` metrics of ``BENCHMARK.json``) on a
recorder filled here, with stand-in CUDA events: the median of the slice's
first ``calls`` roots, and no number without a trace, off a CUDA device,
for a span that never ran, or from a program without the recorder."""

import json
import os

import pytest
import torch

from benchmark import cells
from benchmark.record import Run
from benchmark.trace import DeviceTrace

ROOT = os.path.dirname(cells.HERE)
CALLS = 3


def span_metrics():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    return [m for m in bench['per_layer']
            if m['source'] in ('program_span', 'program_counter')]


SPAN_OF = {'input_copy_device_ms.infer': 'input'}


def span_name(metric):
    return SPAN_OF.get(metric, metric.split('_device_ms')[0])


def counter_name(metric):
    """The program's counter that a ``program_counter`` metric reads."""
    return metric.split('.')[0]


COUNTERS = tuple(counter_name(m['name']) for m in span_metrics()
                 if m['source'] == 'program_counter')


class FakeEvent:
    now = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = FakeEvent.now[0]

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def recorder(monkeypatch):
    from yolact_tpu_torch.utils import timer
    monkeypatch.setattr(torch.cuda, 'Event', FakeEvent)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device=None: None)
    timer.reset()
    yield timer
    timer.reset()


def record_calls(timer, ms_per_call, device='cuda:0', syncs=1,
                 counters=('host_syncs',)):
    """One root a call; each span of the call takes its ms (a dict) and
    counts each of `counters` `syncs` times."""
    for ms in ms_per_call:
        with timer.span('call', device):
            for name, t in ms.items():
                with timer.span(name):
                    FakeEvent.now[0] += t
                    for _ in range(syncs):
                        for counter in counters:
                            timer.count(counter)


def run_with_trace(calls=CALLS):
    trace = DeviceTrace(calls=calls, window_s=1.0, busy_s=0.5, launches=0,
                        kernels=0, by_name={}, gaps={})
    return Run(cell='yolact_plus_base.infer_b16', mode='infer', seed=0,
               seconds=1, trace=True, t0=0.0, device_trace=trace)


@pytest.mark.parametrize('metric', [m['name'] for m in span_metrics()])
def test_reader_takes_the_median_of_the_first_pass(recorder, metric):
    read = cells.load_reader(metric)
    spans = sorted({span_name(m['name']) for m in span_metrics()
                    if m['source'] == 'program_span'})
    with recorder.recording():
        # the first pass's three calls, then a second pass's two
        record_calls(recorder, [{s: k * 1.0 for s in spans}
                                for k in (5, 1, 3)], syncs=1,
                     counters=COUNTERS)
        record_calls(recorder, [{s: 100.0 for s in spans}] * 2, syncs=4,
                     counters=COUNTERS)
        run = run_with_trace()
        # a span's median ms, or a counter's count a call: one a span
        source = next(m['source'] for m in span_metrics()
                      if m['name'] == metric)
        want = 3.0 if source == 'program_span' else len(spans)
        assert read(run) == pytest.approx(want)
        run.device_trace = None
        assert read(run) is None                  # no trace
        run = run_with_trace()
        run.mode = 'train'
        assert read(run) is None


@pytest.mark.parametrize('metric', [m['name'] for m in span_metrics()
                                    if m['source'] == 'program_span'])
def test_span_reader_gives_none_off_the_card_or_unrun(recorder, metric):
    read = cells.load_reader(metric)
    with recorder.recording():
        record_calls(recorder, [{span_name(metric): 2.0}] * CALLS,
                     device='cpu')
        assert read(run_with_trace()) is None     # on the CPU
    with recorder.recording():
        record_calls(recorder, [{'other': 2.0}] * CALLS)
        assert read(run_with_trace()) is None     # the span never ran
    with recorder.recording():
        record_calls(recorder, [{span_name(metric): 2.0}] * (CALLS - 1))
        assert read(run_with_trace()) is None     # fewer calls than traced


@pytest.mark.parametrize('metric', [m['name'] for m in span_metrics()])
def test_reader_of_a_program_without_the_recorder(recorder, monkeypatch,
                                                  metric):
    read = cells.load_reader(metric)
    with recorder.recording():
        record_calls(recorder, [{span_name(metric): 2.0}] * CALLS)
    monkeypatch.delattr(recorder, 'roots')
    assert read(run_with_trace()) is None


def test_host_syncs_reads_zero_where_a_call_took_none(recorder):
    read = cells.load_reader('host_syncs.infer')
    with recorder.recording():
        record_calls(recorder, [{}] * CALLS)
        assert read(run_with_trace()) == 0
