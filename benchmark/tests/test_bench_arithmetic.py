"""The rate, tail and idle-share arithmetic of the metric readers, and
the roofline formulae against the bounds of the port's kernel table
(PERF.md: mask assembly 24.0 us and IoU max 2.47 us at b8)."""

import pytest

from benchmark import cells, trace, yardstick
from benchmark.record import Run, quantile


def closed_loop(ms, stall_at=None, stall_ms=0.0):
    calls, t = [], 0.0
    for i, m in enumerate(ms):
        d = m + (stall_ms if i == stall_at else 0.0)
        calls.append((t, t + d / 1e3))
        t += d / 1e3
    return Run(cell='c', mode='infer', seed=0, seconds=1, trace=False,
               t0=0.0, calls=calls, items_per_call=16)


def read(metric, run):
    return cells.load_reader(metric)(run)


def test_rate_and_tail_of_a_steady_window():
    run = closed_loop([40.0] * 400)
    assert read('frames_per_s', run) == pytest.approx(400.0)
    assert read('batch_p95_ms', run) == pytest.approx(40.0)
    assert read('batch_p50_ms', run) == pytest.approx(40.0)


def test_a_stall_inside_the_window_moves_the_rate_and_the_tail():
    steady = closed_loop([40.0] * 400)
    # 30 calls stalled by 200 ms each: the p95 is one of them, and the
    # rate pays for all the stalled time
    stalled = closed_loop([40.0] * 370 + [240.0] * 30)
    assert read('frames_per_s', stalled) == pytest.approx(
        16 * 400 / (400 * 0.04 + 30 * 0.2))
    assert read('batch_p95_ms', stalled) == pytest.approx(240.0)
    assert read('batch_p50_ms', stalled) == pytest.approx(40.0)
    # one stall of 2 s moves the rate though no percentile sees it
    one = closed_loop([40.0] * 400, stall_at=200, stall_ms=2000.0)
    assert read('frames_per_s', one) < 0.9 * read('frames_per_s', steady)


def test_quantile_interpolates():
    assert quantile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.5
    assert quantile(list(range(101)), 0.95) == pytest.approx(95.0)


def test_failed_items_are_not_completed():
    run = closed_loop([100.0] * 10)
    run.failed = 16
    assert read('frames_per_s', run) == pytest.approx(9 * 16 / 1.0)


def test_idle_share_and_a_lost_profile():
    # 60 ms busy in a profiled slice of 100 ms; the untraced window's
    # calls do not enter the share
    t = trace.DeviceTrace(calls=2, window_s=0.1, busy_s=0.06, launches=10,
                          kernels=10, by_name={}, gaps={})
    run = closed_loop([40.0] * 4)
    run.device_trace = t
    assert read('idle_share.infer', run) == pytest.approx(40.0)
    t.kernels = 9
    assert read('idle_share.infer', run) is None


def test_union_of_device_intervals():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_small_kernel_bounds_at_b8_match_the_kernel_table():
    ms, by = yardstick.mask_assembly(8, 100, 138, 138, 32)
    assert ms * 1e6 == pytest.approx(24.0, abs=0.05) and by == 'bytes'
    us, by = yardstick.nms_iou_max(8 * 80, 200)
    assert us * 1e6 == pytest.approx(2.47, abs=0.005) and by == 'operations'
    s, by = yardstick.stem_s2d(8, 275, 275, 'bfloat16')
    assert s * 1e6 == pytest.approx(27.5, abs=0.05) and by == 'bytes'


def test_roofline_reads_the_bound_over_kernel_time():
    t = trace.DeviceTrace(calls=4, window_s=1.0, busy_s=0.5, launches=8,
                          kernels=8, gaps={},
                          by_name={'void mask_assembly_kernel<>(...)':
                                   (4 * 48e-6, 4)})
    run = closed_loop([40.0] * 4)
    run.device_trace = t
    run.kernel_bounds = {'mask_assembly_kernel': 24e-6}
    run.kernel_launches = {'mask_assembly_kernel': 1}
    assert read('mask_assembly_roofline.infer', run) == pytest.approx(50.0)
    # a profile that kept 3 of its 4 events gives no number
    t.by_name = {'mask_assembly_kernel': (3 * 48e-6, 3)}
    assert read('mask_assembly_roofline.infer', run) is None
    # a kernel the path does not launch gives none
    run.kernel_launches = {'mask_assembly_kernel': 0}
    assert read('mask_assembly_roofline.infer', run) is None


def test_mfu_from_the_frozen_count():
    run = closed_loop([40.0] * 100)
    run.flops_per_item = 989e9
    # 400 frames/s of 989 GFLOP each: 40% of 989 TFLOP/s
    assert read('mfu.infer', run) == pytest.approx(40.0)


def test_a_slice_that_lost_events_is_profiled_again(monkeypatch):
    # the CUDA-only passes lose 2 kernel events, then none; the pass with
    # the host's operators only names the gaps
    passes = []

    def fake_pass(call, calls, cpu):
        passes.append(cpu)
        kept = 10 if cpu or len(passes) > 1 else 8
        return trace.DeviceTrace(calls=calls, window_s=0.1 + cpu,
                                 busy_s=0.06, launches=10, kernels=kept,
                                 by_name={}, gaps={'host' if cpu else 'x': 1})
    monkeypatch.setattr(trace, '_pass', fake_pass)
    t = trace.profile(lambda: None, 2)
    assert passes == [False, False, True]
    assert not t.lost and t.window_s == 0.1 and t.gaps == {'host': 1}
