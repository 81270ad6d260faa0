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


@pytest.mark.parametrize('failure', [None, 'missing', 'error'])
def test_name_and_power_limit(monkeypatch, failure):
    """nvidia-smi's first line of name and power limit, as every
    measurement is tagged; None without nvidia-smi or when it fails."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if failure == 'error':
            raise subprocess.CalledProcessError(9, cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout='NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 '
            '80GB HBM3, 500.00 W\n', stderr='')

    monkeypatch.setattr(nvinfo.shutil, 'which',
                        lambda name: None if failure == 'missing'
                        else '/bin/smi')
    monkeypatch.setattr(nvinfo.subprocess, 'run', run)
    got = nvinfo.name_and_power_limit()
    if failure:
        assert got is None
    else:
        assert got == 'NVIDIA H100 80GB HBM3, 700.00 W'
        assert calls == [['/bin/smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader']]


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
