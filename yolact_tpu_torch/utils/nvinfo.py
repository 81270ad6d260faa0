"""GPU telemetry: the counterpart of ``yolact_tpu/utils/tpuinfo.py`` (the
reference's ``utils/nvinfo.py``).

:func:`device_info` gives one dict per visible CUDA device from
``torch.cuda`` (name, this process's allocated and peak memory, the card's
total memory) and, with ``nvml=True``, what NVML reports through
``nvidia-smi`` for the card as a whole (memory used by every process,
utilization, power draw and limit).  :func:`visible_devices` gives the
physical indices behind ``CUDA_VISIBLE_DEVICES``; :func:`format_table`
prints them.  Without a card every function returns an empty result.

    python -m yolact_tpu_torch.utils.nvinfo
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional

import torch

# nvidia-smi --query-gpu fields, by the key device_info gives each
_NVML_FIELDS = {'uuid': 'uuid', 'memory_used_mib': 'memory.used',
                'utilization_pct': 'utilization.gpu',
                'power_draw_w': 'power.draw', 'power_limit_w': 'power.limit'}


def visible_devices() -> List[int]:
    """The physical indices of the devices torch sees (in its order)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    env = os.environ.get('CUDA_VISIBLE_DEVICES')
    if env is None:
        return list(range(n))
    ids = [v.strip() for v in env.split(',') if v.strip()]
    return [int(v) if v.isdigit() else i for i, v in enumerate(ids[:n])]


def nvml_query() -> Dict[int, Dict[str, object]]:
    """NVML's view of every card through nvidia-smi, by physical index
    (empty where nvidia-smi is missing or fails)."""
    exe = shutil.which('nvidia-smi')
    if exe is None:
        return {}
    fields = ['index'] + list(_NVML_FIELDS.values())
    try:
        proc = subprocess.run(
            [exe, '--query-gpu=' + ','.join(fields),
             '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    out = {}
    for line in proc.stdout.strip().splitlines():
        values = [v.strip() for v in line.split(',')]
        if len(values) != len(fields) or not values[0].isdigit():
            continue
        row = {}
        for key, value in zip(_NVML_FIELDS, values[1:]):
            try:
                row[key] = value if key == 'uuid' else float(value)
            except ValueError:        # '[N/A]', '[Not Supported]'
                row[key] = None
        out[int(values[0])] = row
    return out


def name_and_power_limit() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    tag every measurement carries), or None where nvidia-smi is missing or
    fails."""
    exe = shutil.which('nvidia-smi')
    if exe is None:
        return None
    try:
        proc = subprocess.run(
            [exe, '--query-gpu=name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info(nvml: bool = True) -> List[Dict[str, object]]:
    """One dict per visible CUDA device: ``id`` (torch's index),
    ``physical_id``, ``platform`` ('gpu'), ``kind`` (the name),
    ``memory_allocated`` and ``max_memory_allocated`` (this process, bytes),
    ``memory_total`` (bytes) and, with ``nvml``, the card-wide
    ``_NVML_FIELDS``."""
    if not torch.cuda.is_available():
        return []
    smi = nvml_query() if nvml else {}
    out = []
    for i, phys in enumerate(visible_devices()):
        info = {'id': i, 'physical_id': phys, 'platform': 'gpu',
                'kind': torch.cuda.get_device_name(i),
                'memory_allocated': torch.cuda.memory_allocated(i),
                'max_memory_allocated': torch.cuda.max_memory_allocated(i),
                'memory_total': torch.cuda.get_device_properties(i)
                .total_memory}
        info.update(smi.get(phys, {}))
        out.append(info)
    return out


def format_table() -> str:
    def gib(b):
        return f'{b / 2 ** 30:.2f}G' if isinstance(b, int) else '-'

    def num(v, unit):
        return f'{v:.0f}{unit}' if isinstance(v, float) else '-'

    lines = [f'{"id":>3} | {"kind":>24} | {"alloc":>8} | {"total":>8} | '
             f'{"util":>5} | {"power":>11}']
    lines.append('-' * len(lines[0]))
    for r in device_info():
        power = f'{num(r.get("power_draw_w"), "")}/' \
                f'{num(r.get("power_limit_w"), "W")}'
        lines.append(f'{r["id"]:>3} | {r["kind"][:24]:>24} | '
                     f'{gib(r["memory_allocated"]):>8} | '
                     f'{gib(r["memory_total"]):>8} | '
                     f'{num(r.get("utilization_pct"), "%"):>5} | '
                     f'{power:>11}')
    return '\n'.join(lines)


if __name__ == '__main__':
    print(format_table())
