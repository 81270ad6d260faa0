"""utils/nvinfo.py, the port's counterpart of utils/tpuinfo.py: its NVML
parse of nvidia-smi's CSV, the physical indices behind
CUDA_VISIBLE_DEVICES, and the empty answers without a card."""

import subprocess

import pytest
import torch

from yolact_tpu_torch.utils import logger, nvinfo

CSV = ('0, GPU-aaaa, 1234, 17, 101.50, 700.00\n'
       '1, GPU-bbbb, 0, [N/A], 60.25, 500.00\n')


def test_nvml_query_parses_nvidia_smi(monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=CSV, stderr='')

    monkeypatch.setattr(nvinfo.shutil, 'which', lambda name: '/bin/smi')
    monkeypatch.setattr(nvinfo.subprocess, 'run', run)
    got = nvinfo.nvml_query()
    assert calls[0][0] == '/bin/smi'
    assert calls[0][1].startswith('--query-gpu=index,uuid,memory.used')
    assert got == {
        0: {'uuid': 'GPU-aaaa', 'memory_used_mib': 1234.0,
            'utilization_pct': 17.0, 'power_draw_w': 101.5,
            'power_limit_w': 700.0},
        1: {'uuid': 'GPU-bbbb', 'memory_used_mib': 0.0,
            'utilization_pct': None, 'power_draw_w': 60.25,
            'power_limit_w': 500.0}}


@pytest.mark.parametrize('failure', ['missing', 'error'])
def test_nvml_query_without_nvidia_smi(monkeypatch, failure):
    if failure == 'missing':
        monkeypatch.setattr(nvinfo.shutil, 'which', lambda name: None)
    else:
        def run(cmd, **kw):
            raise subprocess.CalledProcessError(9, cmd)
        monkeypatch.setattr(nvinfo.shutil, 'which', lambda name: 'smi')
        monkeypatch.setattr(nvinfo.subprocess, 'run', run)
    assert nvinfo.nvml_query() == {}


def test_visible_devices_follow_cuda_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '3,1,5')
    assert nvinfo.visible_devices() == [3, 1]
    monkeypatch.delenv('CUDA_VISIBLE_DEVICES')
    assert nvinfo.visible_devices() == [0, 1]


def test_no_card_gives_empty_answers(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; this checks the machine without one')
    assert nvinfo.device_info() == [] and nvinfo.visible_devices() == []
    assert nvinfo.format_table().splitlines()[0].split() == [
        'id', '|', 'kind', '|', 'alloc', '|', 'total', '|', 'util', '|',
        'power']
    log = logger.Log('gpu', str(tmp_path), {}, log_gpu_stats=True)
    log.log('train', iter=1)
    assert logger.Log._device_info() == logger.Log._memory_info() == []
