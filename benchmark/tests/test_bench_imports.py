"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (``yolact_tpu_torch`` begins with ``yolact_tpu``)."""

import json
import os
import pkgutil
import subprocess
import sys

from benchmark import cells

ROOT = os.path.dirname(cells.HERE)
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'yolact_tpu'}


def loaded_after(imports):
    code = ('import importlib, json, sys\n'
            f'for m in {imports!r}:\n'
            '    importlib.import_module(m)\n'
            'print(json.dumps(sorted({m.split(".")[0] '
            'for m in sys.modules})))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_imports_no_jax():
    modes = [f'benchmark.modes.{m}' for m in cells.names('modes')]
    top = loaded_after(['benchmark.run', 'benchmark.calibrate', *modes,
                        'yolact_tpu_torch.infer',
                        'yolact_tpu_torch.train.step',
                        'yolact_tpu_torch.data.loader'])
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert 'yolact_tpu_torch' in top


def reference_modules(package):
    """``benchmark.reference.<package>`` and every module in it: the
    config modules and backbone families that ``get_config`` and
    ``backbone_family`` import by name."""
    where = os.path.join(cells.HERE, 'reference', package)
    return [f'benchmark.reference.{package}'] + [
        f'benchmark.reference.{package}.{m.name}'
        for m in pkgutil.iter_modules([where])]


def test_the_reference_imports_nothing_of_the_port():
    top = loaded_after(['benchmark.reference.infer', 'benchmark.judge',
                        'benchmark.reference.train.step',
                        'benchmark.reference.data.batch',
                        'benchmark.yardstick', 'benchmark.weights',
                        *reference_modules('configs'),
                        *reference_modules('models')])
    assert not top & (FORBIDDEN | {'yolact_tpu_torch'}), top


def test_without_a_card_the_run_exits_with_its_message():
    out = subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload',
         cells.names('workloads')[0], '--seed', '3000000000', '--seconds',
         '1', '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert 'no CUDA device' in out.stderr
    assert out.stdout.strip() == ''
