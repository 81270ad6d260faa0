"""The port's FLOP counter (yolact_tpu_torch/scripts/flops.py) against the
JAX package's scripts/flops.py, on tiny configs on the CPU.

The two counts are not the same count.  The port's FlopCounterMode counts
convolutions and matrix products only, every tap of a padded window
included; XLA's cost_analysis, which JAX's script reads, also counts
elementwise work but counts a padded convolution's valid taps only (a
3x3 conv padded 1 over a 4x4 map: 200 FLOPs, not 288).  At the tiny
configs' 128 px the padding weighs more than the elementwise work in the
forward pass, so the port counts more there.  Measured port / JAX here:
tiny base inference 1.021, train-mode forward 1.010, tiny plus 0.990;
the tiny base train step (b1, 2 gts) 0.979.  Held to RATIO; the parameter
counts are equal, and the train step counts more than the forward."""

import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from scripts import flops as jax_flops
from yolact_tpu.config import register_config as jax_register
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.from_jax import config_from_jax
from yolact_tpu_torch.scripts import flops

torch.set_num_threads(2)

# port / JAX bounds around the measured ratios above
RATIO = (0.95, 1.05)
CONFIGS = {'tinyportflops_base': tiny_resnet_config,
           'tinyportflops_plus': tiny_plus_config}


@pytest.fixture(scope='module', autouse=True)
def registered():
    for name, make in CONFIGS.items():
        cfg = make().copy(name=name)
        jax_register(cfg)
        register_config(config_from_jax(cfg))


def _close(got, want, key):
    ratio = got[key] / want[key]
    print(f'{got["config"]} {got["mode"]}: port {got[key]} GF, JAX '
          f'{want[key]} GF, ratio {ratio:.4f}')
    assert RATIO[0] <= ratio <= RATIO[1], ratio
    assert got['params_m'] == want['params_m']


@pytest.mark.parametrize('name,batch,train', [
    ('tinyportflops_base', 1, False), ('tinyportflops_base', 2, True),
    ('tinyportflops_plus', 1, False), ('tinyportflops_plus', 2, True)])
def test_forward_flops_near_jax(name, batch, train):
    got = flops.forward_flops(name, batch, train, device='cpu')
    want = jax_flops.forward_flops(name, batch, train)
    for key in ('config', 'img_size', 'batch', 'mode'):
        assert got[key] == want[key]
    assert got['counter'] == flops.COUNTER and got['bytes_accessed_gb'] is None
    _close(got, want, 'flops_per_image_g')


def test_train_step_flops_near_jax_and_above_the_forward():
    got = flops.train_step_flops('tinyportflops_base', 1, 2, device='cpu')
    want = jax_flops.train_step_flops('tinyportflops_base', 1, 2)
    assert got['mode'] == want['mode'] == 'train_step'
    _close(got, want, 'flops_per_step_g')
    forward = flops.forward_flops('tinyportflops_base', 1, True,
                                  device='cpu')
    assert got['flops_per_image_g'] > 2 * forward['flops_per_image_g']


def test_cli_rows_and_mfu(capsys):
    rows = flops.main(['tinyportflops_base', '--cuda', 'False', '--fps',
                       '100', '--dtype', 'float32'])
    row = rows[0]
    sustained = row['flops_per_image_g'] * 1e9 * 100
    assert row['mfu_pct'] == round(sustained / 989e12 * 100, 2)
    assert row['mfu_pct_tf32'] == round(sustained / 494.7e12 * 100, 2)
    assert row['mfu_pct_float32'] == round(sustained / 67e12 * 100, 2)
    assert 'card' not in row
    assert '"flops_per_image_g"' in capsys.readouterr().out
