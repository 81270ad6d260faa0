"""The port's own configuration module (yolact_tpu_torch.config) against the
JAX package's (yolact_tpu.config): every registered config equal field for
field, config_from_jax on the tiny test configs, and two registries that
do not share entries.  Exact equality throughout: the port's module is a
copy, and MaskType's members are the same integers in both."""

import dataclasses

import pytest

import _tiny
import test_torch_inputs as port_tiny
from yolact_tpu import config as J
from yolact_tpu_torch import config as C
from yolact_tpu_torch.convert.from_jax import config_from_jax


def _fields(value):
    """A config as nested (class name, {field: value}) tuples, so configs
    of the two packages compare field by field."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: _fields(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(_fields(v) for v in value)
    return value


def _port_classes_only(value):
    """Every nested config dataclass of `value` is the port's class."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        assert type(value) is getattr(C, type(value).__name__)
        for f in dataclasses.fields(value):
            _port_classes_only(getattr(value, f.name))
    elif isinstance(value, tuple):
        for v in value:
            _port_classes_only(v)


def test_same_config_and_dataset_names():
    assert C.config_names() == J.config_names()
    assert sorted(C._DATASET_REGISTRY) == sorted(J._DATASET_REGISTRY)


@pytest.mark.parametrize('name', J.config_names())
def test_registered_config_equals_jax(name):
    port, jax_cfg = C.get_config(name), J.get_config(name)
    assert _fields(port) == _fields(jax_cfg)
    _port_classes_only(port)
    assert config_from_jax(jax_cfg) == port


@pytest.mark.parametrize('name', sorted(J._DATASET_REGISTRY))
def test_registered_dataset_equals_jax(name):
    assert _fields(C.get_dataset(name)) == _fields(J.get_dataset(name))


def test_constants_and_derived_values_equal_jax():
    assert (C.MEANS, C.STD, C.COLORS) == (J.MEANS, J.STD, J.COLORS)
    assert (C.MaskType.DIRECT, C.MaskType.LINCOMB) == \
        (J.MaskType.DIRECT, J.MaskType.LINCOMB)
    for name in J.config_names():
        cfg = J.get_config(name)
        if cfg.backbone is not None:
            assert C.backbone_channels(C.get_config(name).backbone) == \
                J.backbone_channels(cfg.backbone)
    assert C.config_from_model_path('w/yolact_plus_base_3_90.pth') == \
        C.get_config('yolact_plus_base')


@pytest.mark.parametrize('make', ['tiny_resnet_config', 'tiny_plus_config'])
@pytest.mark.parametrize('overrides', [{}, {'stem_s2d': True,
                                            'nms_candidates': 256}])
def test_config_from_jax_on_tiny_configs(make, overrides):
    """config_from_jax rebuilds the tiny configs in the port's classes, and
    test_torch_inputs.py's port-side copies of them are the same configs."""
    jax_cfg = getattr(_tiny, make)(**overrides)
    port = config_from_jax(jax_cfg)
    _port_classes_only(port)
    assert _fields(port) == _fields(jax_cfg)
    assert getattr(port_tiny, make)(**overrides) == port


def test_config_from_jax_on_darknet_and_copies():
    jax_cfg = _tiny.tiny_darknet_config(mask_type=J.MaskType.DIRECT)
    port = config_from_jax(jax_cfg)
    assert port.mask_type == C.MaskType.DIRECT
    assert _fields(port) == _fields(jax_cfg)
    assert port.copy(max_size=64).max_size == 64
    with pytest.raises(TypeError):
        config_from_jax(jax_cfg.backbone)


def test_registries_are_separate():
    cfg = C.get_config('yolact_base').copy(name='tinyportonly')
    C.register_config(cfg)
    try:
        assert C.get_config('tinyportonly') is cfg
        with pytest.raises(KeyError):
            J.get_config('tinyportonly')
    finally:
        del C._CONFIG_REGISTRY['tinyportonly']
