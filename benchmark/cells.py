"""Find a cell, its configuration, its traffic mix and its metrics by name.

No table of cells lives in code: a cell is ``workloads/<name>.json``,
which names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); a mix names its loop (``modes/<mode>.py``); a
metric is ``metrics/<name>.py``, listed in ``BENCHMARK.json`` at the root
of the checkout.  An unknown name raises :class:`UnknownName`.

A configuration joins as new files alone, each found by name:

* ``configs/<config>.json``: the sizes as run, the ``port_config`` that
  names it in the port and in the reference, its FLOPs an image
  (``yardstick.forward_flops``) and its weight shaping;
* ``workloads/<config>.<mix>.json``: the cell, with its limits;
* ``reference/configs/<port_config>.py``: the reference's config, a
  ``CONFIG`` of that name (``reference/config.py:get_config``);
* ``reference/models/<type>.py``, where its backbone ``type`` is a family
  the reference lacks: ``build_backbone``, ``out_channels`` and
  ``feature_sizes_1d`` (``reference/config.py:backbone_family``);
* ``metrics/<name>.py`` for a metric that it reads and no file reads yet;
* its entries in ``BENCHMARK.json``: the configuration, the cell, and the
  cell's name in the ``workloads`` of each metric that reads it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


class UnknownName(LookupError):
    """A cell, configuration, mix, mode or metric with no file."""


def _path(kind: str, name: str, ext: str, root: str) -> str:
    if not NAME.match(name):
        raise UnknownName(f'{kind} name {name!r} is not a valid name')
    path = os.path.join(root, kind, name + ext)
    if not os.path.isfile(path):
        known = sorted(f[:-len(ext)] for f in os.listdir(
            os.path.join(root, kind)) if f.endswith(ext))
        raise UnknownName(f'no {kind[:-1] if kind.endswith("s") else kind} '
                          f'named {name!r} ({path}); known: {known}')
    return path


def _json(kind: str, name: str, root: str) -> Dict[str, Any]:
    with open(_path(kind, name, '.json', root)) as f:
        return json.load(f)


def names(kind: str, root: str = HERE) -> List[str]:
    """Every name of `kind` ('workloads', 'configs', 'traffic', 'metrics',
    'modes') that has a file."""
    ext = '.py' if kind in ('metrics', 'modes') else '.json'
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(root, kind))
                  if f.endswith(ext) and not f.startswith('_'))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    workload: Dict[str, Any]

    @property
    def mode(self) -> str:
        return self.traffic['mode']

    @property
    def limits(self) -> Dict[str, float]:
        """The limits of the numbers the correctness check compares."""
        return self.workload['limits']


def load_cell(name: str, root: str = HERE) -> Cell:
    workload = _json('workloads', name, root)
    config = _json('configs', workload['config'], root)
    traffic = _json('traffic', workload['traffic'], root)
    _path('modes', traffic['mode'], '.py', root)
    return Cell(name, workload['config'], workload['traffic'], config,
                traffic, workload)


def load_mode(name: str, root: str = HERE):
    """The loop module ``modes/<name>.py``: ``setup``, ``window``,
    ``check``."""
    _path('modes', name, '.py', root)
    if root == HERE:
        return importlib.import_module(f'benchmark.modes.{name}')
    return _load_file(f'benchmark_mode_{name}',
                      os.path.join(root, 'modes', name + '.py'))


def _load_file(module_name: str, path: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: str = HERE):
    """The reader ``metrics/<metric>.py`` (its ``read(run)``: the number,
    or None where the run has nothing to read)."""
    path = _path('metrics', metric, '.py', root)
    return _load_file('benchmark_metric_' + metric.replace('.', '_')
                      .replace('-', '_'), path).read


def benchmark_json(checkout: Optional[str] = None) -> Dict[str, Any]:
    """``BENCHMARK.json`` at the root of the checkout (the parent of this
    package)."""
    checkout = checkout or os.path.dirname(HERE)
    with open(os.path.join(checkout, 'BENCHMARK.json')) as f:
        return json.load(f)


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of `cell` reports: the end-to-end ones without
    `trace`, the per-layer ones with it; a metric with a ``workloads`` key
    only in the cells it lists."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group if cell in m.get('workloads', (cell,))]
