"""Cells, configurations, mixes and metrics are found by name, and a new
one is a new file."""

import json
import os
import re
import shutil

import pytest

from benchmark import cells

ROOT = os.path.dirname(cells.HERE)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\t\n]{1,200}$')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('name', cells.names('workloads'))
def test_every_workload_file_loads(name):
    cell = cells.load_cell(name)
    assert cell.config_name in cells.names('configs')
    assert cell.traffic_name in cells.names('traffic')
    assert cell.mode in cells.names('modes')
    assert cell.limits


@pytest.mark.parametrize('kind,name', [
    ('workloads', 'no_such_cell'), ('workloads', 'bad name/x'),
    ('metrics', 'no_such_metric'), ('modes', 'no_such_mode')])
def test_unknown_name_fails(kind, name):
    with pytest.raises(cells.UnknownName):
        if kind == 'workloads':
            cells.load_cell(name)
        elif kind == 'metrics':
            cells.load_reader(name)
        else:
            cells.load_mode(name)


def test_added_files_are_found_without_a_code_edit(tmp_path):
    """A configuration, a mix, a metric and a cell added as files in a copy
    of the benchmark are picked up by name."""
    root = tmp_path / 'benchmark'
    shutil.copytree(cells.HERE, root,
                    ignore=shutil.ignore_patterns('__pycache__'))
    base = json.loads((root / 'configs' / 'yolact_base.json').read_text())
    (root / 'configs' / 'new_config.json').write_text(json.dumps(base))
    mix = json.loads((root / 'traffic' / 'infer_b16.json').read_text())
    mix['batch'] = 8
    (root / 'traffic' / 'infer_b8.json').write_text(json.dumps(mix))
    (root / 'workloads' / 'new_config.infer_b8.json').write_text(json.dumps(
        {'config': 'new_config', 'traffic': 'infer_b8', 'why': 'a test',
         'limits': {'unmatched_share': 0.1}}))
    (root / 'metrics' / 'calls_counted.py').write_text(
        'def read(run):\n    return float(len(run.calls))\n')
    assert 'new_config.infer_b8' in cells.names('workloads', str(root))
    cell = cells.load_cell('new_config.infer_b8', str(root))
    assert cell.traffic['batch'] == 8 and cell.mode == 'infer'
    from benchmark.record import Run
    run = Run(cell=cell.name, mode='infer', seed=0, seconds=1, trace=False,
              t0=0.0, calls=[(0.0, 1.0), (1.0, 2.0)])
    assert cells.load_reader('calls_counted', str(root))(run) == 2.0
    assert 'new_config.infer_b8' not in cells.names('workloads')


def test_benchmark_json_names_and_units():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    seen = set()
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in b[group]:
            assert NAME.match(entry['name']), entry['name']
            assert entry['name'] not in seen
            seen.add(entry['name'])
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert os.path.isfile(os.path.join(cells.HERE, 'metrics',
                                           m['name'] + '.py'))
    for m in b['per_layer']:
        assert LINE.match(m['layer'])
        assert m['moves'] in {e['name'] for e in b['end_to_end']}
    for w in b['workloads']:
        assert LINE.match(w['why']) and w['chips'] in (1, 4)
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        cell = cells.load_cell(w['name'])
        assert (cell.config_name, cell.traffic_name) == (w['config'],
                                                          w['traffic'])
    for c in b['configs']:
        assert os.path.isfile(os.path.join(ROOT, c['file']))
        assert all(NAME.match(k) for k in c['reduced'])
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = bench()
    for w in b['workloads']:
        e2e = [m['name'] for m in cells.cell_metrics(b, w['name'], False)]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert cells.cell_metrics(b, w['name'], True)
