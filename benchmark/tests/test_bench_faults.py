"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``run.measure``: set-up, window, metrics, check) on the CPU, on a
small copy of a cell (the same configuration at 128² or 256² and a
batch of two or four, where the port runs its kernels' plain versions),
once sound and once with a fault planted under the timed entry.  For
inference, under ``Pipeline.__call__``: a call that returns the previous
call's answers, half of the batch left out, an answer altered where it is
produced.  For training, under ``train_step`` (``modes/train.py:
planted``): a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, a loss letter left out where
the loss is produced.  For a cell with the YOLACT++ mask scorer, the
scorer left out (each mask score the detection's score) and the mask
scores missing from the answer.
The limits are the cell's own.
"""

import pytest
import torch

from benchmark import cells, run


def small_cell(name):
    cell = cells.load_cell(name)
    size = 256 if cell.config['config']['use_maskiou'] else 128
    cell.config['overrides'] = {'max_size': size}
    cell.config['config'] = dict(cell.config['config'], max_size=size)
    cell.config['weights'] = dict(cell.config['weights'],
                                  candidates_per_image=40)
    cell.traffic.update(batch=2, frame_hw=[size * 3 // 4, size],
                        pool_frames=4, warmup_calls=1, judge_from=2,
                        judged_calls=2, trace_calls=1)
    return cell


def measure(cell):
    bench = cells.benchmark_json()
    metrics = cells.cell_metrics(bench, cell.name, False)
    readers = {m['name']: cells.load_reader(m['name']) for m in metrics}
    return run.measure(cell, cells.load_mode(cell.mode), readers, metrics,
                       seed=2 ** 31 + 11, seconds=0.2, trace=False, chips=1,
                       device='cpu')


def stale(fn):
    last = []

    def broken(*a, **k):
        out = fn(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return broken


def half_batch(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        valid = out.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return out._replace(valid=valid)
    return broken


def altered(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        classes = out.classes.clone()
        classes[:, 0] = (classes[:, 0] + 1) % (a[0].num_classes - 1)
        return out._replace(classes=classes)
    return broken


def no_maskiou(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        return out._replace(mask_scores=out.scores)
    return broken


def no_mask_scores(fn):
    def broken(*a, **k):
        return fn(*a, **k)._replace(mask_scores=None)
    return broken


NAMES = cells.names('workloads')
INFER = [n for n in NAMES if cells.load_cell(n).mode == 'infer']
TRAIN = [n for n in NAMES if cells.load_cell(n).mode == 'train']
SCORED = [n for n in INFER
          if cells.load_cell(n).config['config'].get('use_maskiou')]


def small_train_cell(name):
    cell = cells.load_cell(name)
    size = 256 if cell.config['config']['use_maskiou'] else 128
    cell.config['overrides'] = dict(cell.config['overrides'], max_size=size)
    cell.config['config'] = dict(cell.config['config'], max_size=size)
    cell.traffic.update(batch=4, frames=12, workers=2, max_gt=8,
                        warmup_steps=1,
                        frame_hws=[[size * 3 // 4, size],
                                   [size, size * 3 // 4]])
    return cell


@pytest.mark.parametrize('name', INFER)
@pytest.mark.parametrize('fault', [None, stale, half_batch, altered])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    torch.manual_seed(0)
    if fault is not None:
        import yolact_tpu_torch.infer as infer
        monkeypatch.setattr(infer, 'forward_and_detect',
                            fault(infer.forward_and_detect))
    result = measure(small_cell(name))
    assert result['compared']['no_detections']['value'] == 0
    assert result['correct'] is (fault is None), result['compared']


@pytest.mark.parametrize('name', SCORED)
@pytest.mark.parametrize('fault', [no_maskiou, no_mask_scores])
def test_a_mask_scorer_left_out_is_not_correct(name, fault, monkeypatch):
    import yolact_tpu_torch.infer as infer
    torch.manual_seed(0)
    monkeypatch.setattr(infer, 'forward_and_detect',
                        fault(infer.forward_and_detect))
    result = measure(small_cell(name))
    assert result['compared']['no_detections']['value'] == 0
    assert result['correct'] is False, result['compared']


@pytest.mark.parametrize('name', TRAIN)
@pytest.mark.parametrize('fault', [None, 'unchanged', 'half_batch',
                                   'loss_letter_dropped'])
def test_a_broken_train_step_is_not_correct(name, fault):
    from benchmark.modes.train import planted
    torch.manual_seed(0)
    with planted(fault):
        result = measure(small_train_cell(name))
    assert result['correct'] is (fault is None), result['compared']
