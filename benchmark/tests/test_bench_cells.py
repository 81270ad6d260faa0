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


# A backbone family and a config that the reference lacks, as the files a
# later configuration adds: a toy trunk of stride-2 3x3 conv, batch norm and
# leaky ReLU stages, and a small yolact_base on it at 64 pixels.
TOY_FAMILY = '''
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models.layers import BatchNorm2d, Conv2d
from benchmark.reference.ops.anchors import conv_out


class ToyTrunk(nn.Module):
    def __init__(self, widths):
        super().__init__()
        ins = (3,) + widths[:-1]
        self.convs = nn.ModuleList(
            Conv2d(i, o, 3, stride=2, padding=1, bias=False)
            for i, o in zip(ins, widths))
        self.bns = nn.ModuleList(BatchNorm2d(o) for o in widths)

    def forward(self, x, use_kernels=True, bn_train=False, remat='none'):
        outs = []
        for conv, bn in zip(self.convs, self.bns):
            x = F.leaky_relu(bn(conv(x), bn_train), 0.1)
            outs.append(x)
        return tuple(outs)


def build_backbone(cfg):
    return ToyTrunk(tuple(cfg.backbone.args[0]))


def out_channels(bb):
    return tuple(bb.args[0])


def feature_sizes_1d(cfg, img):
    sizes = []
    for _ in cfg.backbone.args[0]:
        img = conv_out(img, 3, 2, 1)
        sizes.append(img)
    return sizes
'''

TOY_CONFIG = '''
from benchmark.reference.config import (FPN_BASE, YOLACT_BASE_CONFIG,
                                        TransformConfig)

CONFIG = YOLACT_BASE_CONFIG.copy(
    name='toy_family_base',
    max_size=64,
    backbone=YOLACT_BASE_CONFIG.backbone.copy(
        name='ToyTrunk', type='toy_family', args=((8, 16, 32, 64),),
        transform=TransformConfig(normalize=False, to_float=True)),
    fpn=FPN_BASE.copy(num_features=16, use_conv_downsample=True,
                      num_downsample=2),
    mask_proto_net=((16, 3, (('padding', 1),)), (None, -2, ()),
                    (8, 1, ())),
    extra_head_net=((16, 3, (('padding', 1),)),))
'''


@pytest.fixture
def planted(tmp_path, monkeypatch):
    """The toy family and config as files in a directory of their own,
    put on the import path of the reference's ``models`` and ``configs``
    packages; the tree is left as it is."""
    import sys

    from benchmark.reference import configs, models
    (tmp_path / 'models').mkdir()
    (tmp_path / 'configs').mkdir()
    (tmp_path / 'models' / 'toy_family.py').write_text(TOY_FAMILY)
    (tmp_path / 'configs' / 'toy_family_base.py').write_text(TOY_CONFIG)
    monkeypatch.setattr(models, '__path__',
                        [*models.__path__, str(tmp_path / 'models')])
    monkeypatch.setattr(configs, '__path__',
                        [*configs.__path__, str(tmp_path / 'configs')])
    names = ('benchmark.reference.models.toy_family',
             'benchmark.reference.configs.toy_family_base')
    yield
    for name in names:
        sys.modules.pop(name, None)


def test_a_config_and_a_backbone_family_join_as_files(planted):
    """A config module and a backbone family module that the reference
    lacks are found by name: the config, the model, its FLOPs, priors and
    channels, the seeded weights and a forward through detection."""
    import torch

    from benchmark import weights, yardstick
    from benchmark.reference.config import backbone_channels, get_config
    from benchmark.reference.infer import forward_and_detect, load_model
    from benchmark.reference.models.resnet import DCNLayer
    from benchmark.reference.ops.anchors import generate_priors
    cfg = get_config('toy_family_base')
    assert get_config('toy_family_base_config') is cfg
    assert cfg.backbone.type == 'toy_family'
    assert backbone_channels(cfg.backbone) == (8, 16, 32, 64)
    # stages of 32, 16, 8, 4 pixels: levels 16, 8, 4 and the FPN's 2, 1
    priors = generate_priors(cfg)
    assert priors.shape == ((16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2 + 1) * 3, 4)
    assert type(yardstick.reference_model(cfg).backbone).__name__ \
        == 'ToyTrunk'
    # the trunk's convolutions, 2 FLOPs a multiply-add, are in the count
    trunk = sum(2 * 9 * i * o * s * s for i, o, s in
                zip((3, 8, 16, 32), (8, 16, 32, 64), (32, 16, 8, 4)))
    assert yardstick.forward_flops(cfg) > trunk
    model = yardstick.reference_model(cfg, device='cpu')
    sd = weights.init_state_dict(model, torch.Generator().manual_seed(0),
                                 DCNLayer, torch.device('cpu'))
    assert list(sd) == list(model.state_dict())
    assert sd['backbone.convs.3.weight'].abs().max() > 0
    model = load_model(cfg, sd, torch.device('cpu'), 'float32')
    frames = torch.randint(0, 256, (2, 48, 80, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        preds = model(torch.zeros(2, 3, 64, 64))
        out = forward_and_detect(cfg, model, frames, use_kernels=False)
    assert preds['loc'].shape == (2, priors.shape[0], 4)
    assert preds['proto'].shape == (2, 32, 32, 8)
    assert out.boxes.shape == (2, cfg.max_num_detections, 4)
    assert out.masks.shape[2:] == (32, 32)


def test_unknown_config_and_backbone_type_fail(planted):
    """An unknown config name is a KeyError that lists the built-in
    configs and the modules found; an unknown backbone type, or one whose
    module is no family, fails at each of the family's call sites with
    the exception each raised before."""
    from benchmark import yardstick
    from benchmark.reference.config import (UnknownBackbone,
                                            backbone_channels, get_config)
    from benchmark.reference.ops.anchors import generate_priors
    for name in ('no_such_config', 'bad name/x'):
        with pytest.raises(KeyError) as e:
            get_config(name)
        assert 'yolact_base' in str(e.value)
        assert 'toy_family_base' in str(e.value)
    toy = get_config('toy_family_base')
    for bb_type in ('no_such_family', 'fpn', '../resnet'):
        cfg = toy.copy(backbone=toy.backbone.copy(type=bb_type))
        with pytest.raises(NotImplementedError):
            yardstick.reference_model(cfg)
        with pytest.raises(ValueError):
            generate_priors(cfg)
        with pytest.raises(UnknownBackbone):
            backbone_channels(cfg.backbone)
