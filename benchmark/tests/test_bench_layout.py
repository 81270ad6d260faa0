"""The reader of the program's ``nchw_maps`` counter (``nchw_maps.infer``)
on a recorder filled here: the median of the slice's first pass, 0 where
the calls took the counter and found no NCHW map, and no number where the
program never takes the counter (a tree older than it), without a trace,
or in training."""

import pytest

from benchmark import cells
from benchmark.tests.test_bench_spans import (CALLS, record_calls,  # noqa: F401
                                              recorder, run_with_trace)


def record_maps(timer, per_call):
    """One root a call, which counts its maps' NCHW ones."""
    for n in per_call:
        with timer.span('call', 'cuda:0'):
            with timer.span('backbone'):
                timer.count('nchw_maps', n)


@pytest.mark.parametrize('per_call,want', [([0, 0, 0], 0), ([4, 0, 2], 2),
                                           ([1, 1, 1, 9, 9], 1)])
def test_nchw_maps_reads_the_median_of_the_first_pass(recorder, per_call,
                                                      want):
    read = cells.load_reader('nchw_maps.infer')
    with recorder.recording():
        record_maps(recorder, per_call)
        assert read(run_with_trace()) == want
        run = run_with_trace()
        run.device_trace = None
        assert read(run) is None                  # no trace
        run = run_with_trace()
        run.mode = 'train'
        assert read(run) is None


def test_nchw_maps_reads_none_from_a_program_without_the_counter(recorder):
    read = cells.load_reader('nchw_maps.infer')
    with recorder.recording():
        record_calls(recorder, [{'backbone': 1.0}] * CALLS)
        assert read(run_with_trace()) is None
    with recorder.recording():
        record_maps(recorder, [0] * (CALLS - 1))   # fewer calls than traced
        assert read(run_with_trace()) is None


def test_nchw_maps_reads_zero_on_the_programs_own_calls(recorder):
    """A recorded call of the tiny yolact_base Pipeline takes the counter
    and hands the model's layers channels_last maps only."""
    import numpy as np
    import torch

    from tests.test_torch_inputs import tiny_resnet_config
    from yolact_tpu_torch.infer import Pipeline, random_state_dict
    cfg = tiny_resnet_config(nms_candidates=256)
    pipe = Pipeline(cfg, random_state_dict(cfg, torch.Generator()
                                           .manual_seed(0)), 'cpu')
    frames = np.random.RandomState(0).randint(0, 256, (1, 64, 80, 3),
                                              dtype=np.uint8)
    read = cells.load_reader('nchw_maps.infer')
    with recorder.recording():
        for _ in range(CALLS):
            pipe(frames)
        assert read(run_with_trace()) == 0
