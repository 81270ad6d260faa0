"""The frozen FLOP counts in the configuration files are the reference's
(and the port's own FlopCounterMode count: 164.68 and 187.33 GF an image)."""

import pytest

from benchmark import cells, yardstick
from benchmark.reference.config import get_config


@pytest.mark.parametrize('name', cells.names('configs'))
def test_config_flops_are_the_reference_count(name):
    cell_config = cells._json('configs', name, cells.HERE)
    # the count is of the plain 7x7/s2 stem, whichever stem a cell runs
    cfg = get_config(cell_config['port_config']).copy(
        **dict(cell_config.get('overrides', {}), stem_s2d=False))
    assert cell_config['flops_per_image'] == yardstick.forward_flops(cfg)


def test_dcn_shapes_of_yolact_plus_base():
    shapes = yardstick.dcn_shapes(get_config('yolact_plus_base'))
    assert len(shapes) == 11
    assert shapes[0] == (128, 138, 138, 69, 69)
    assert shapes[-1] == (512, 35, 35, 18, 18)
    assert yardstick.dcn_shapes(get_config('yolact_base')) == []
