"""The port's DarkNet-53 family (``yolact_tpu_torch/models/darknet.py``) and
its ``yolact_darknet53`` inference against the benchmark's frozen plain
reference (``benchmark/reference/models/darknet.py``,
``benchmark/reference/configs/yolact_darknet53.py``), which decides the
``yolact_darknet53.infer_b16`` cell's ``correct`` on the card: float32 on
the CPU, seeded random weights, one state dict loaded into both."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import cells, judge
from benchmark.modes.infer import make_weights
from benchmark.reference import config as RC
from benchmark.reference.infer import load_model as ref_load_model
from benchmark.reference.models import darknet as ref_darknet
from benchmark.reference.models.yolact import Yolact as RefYolact
from benchmark.reference.ops import anchors as ref_anchors
from test_torch_inputs import tiny_darknet_config
from yolact_tpu_torch import config as PC
from yolact_tpu_torch.infer import forward_and_detect, load_model
from yolact_tpu_torch.models.darknet import DarkNetBackbone
from yolact_tpu_torch.models.yolact import Yolact
from yolact_tpu_torch.ops import anchors

torch.set_num_threads(2)

# (blocks a stage, stages): the published trunk, and one block a stage
# with two of add_layer's stages past the fifth
TRUNKS = {'darknet53': ((1, 2, 8, 8, 4), 5), 'extra_stages': ((1,) * 5, 7)}
# one square input and one that is not, with odd sizes along the way
SIZES = [(64, 64), (48, 80)]


def random_trunk(layers, num_stages, seed):
    """The reference's trunk with torch's default conv init and batch norm
    made far from the identity (seeded), and the port's with its state
    dict."""
    torch.manual_seed(seed)
    ref = ref_darknet.DarkNetBackbone(layers, num_stages)
    sd = ref.state_dict()
    g = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith(('1.weight', '1.running_var')):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(('1.bias', '1.running_mean')):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    ref.load_state_dict(sd)
    port = DarkNetBackbone(layers, num_stages)
    port.load_state_dict(sd, strict=True)
    return port.eval(), ref.eval()


@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('trunk', sorted(TRUNKS))
def test_each_stage_matches_the_reference(trunk, size):
    """Each stage's map within 1e-5 of its largest magnitude: both sides
    run the same float32 convs, batch norms and activations in the same
    order, and differ only where the port's channels_last convs sum in
    another order (a few float32 ulps a layer over 52 layers)."""
    layers, num_stages = TRUNKS[trunk]
    port, ref = random_trunk(layers, num_stages, seed=3)
    x = torch.randn(2, 3, *size, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = port(x.contiguous(memory_format=torch.channels_last))
        want = ref(x)
    assert len(got) == len(want) == num_stages
    h, w = size
    for i, (a, b) in enumerate(zip(got, want)):
        h, w = (h + 1) // 2, (w + 1) // 2
        assert a.shape == b.shape == (2, ref_darknet.out_channels(
            RC.BackboneConfig(selected_layers=(num_stages - 1,)))[i], h, w)
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), i


def reference_tiny_darknet_config(**kw):
    """``test_torch_inputs.tiny_darknet_config`` in the reference's config
    module: the same changes to ``yolact_darknet53``."""
    cfg = RC.get_config('yolact_darknet53')
    return cfg.copy(
        max_size=128, num_classes=5,
        backbone=cfg.backbone.copy(
            args=((1, 1, 1, 1, 1),),
            pred_scales=((6,), (12,), (24,), (48,), (96,))),
        mask_proto_net=((8, 3, (('padding', 1),)), (None, -2, ()),
                        (8, 1, ())),
        extra_head_net=((16, 3, (('padding', 1),)),),
        fpn=cfg.fpn.copy(num_features=16), **kw)


def as_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_the_tiny_configs_are_equal():
    """The two tiny configs hold the same value in every field (the nested
    configs compared field by field)."""
    port, ref = as_dict(tiny_darknet_config()), as_dict(
        reference_tiny_darknet_config())
    assert set(port) == set(ref)
    for k in port:
        a, b = port[k], ref[k]
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, k


@pytest.mark.parametrize('seed', [2 ** 31 + 5, 2 ** 32 + 17])
def test_forward_and_detect_matches_the_reference(seed):
    """The port's ``forward_and_detect`` (plain kernels, float32) on two
    128-pixel-resized frames against the reference's, judged as the
    benchmark judges a run (``benchmark/judge.py``), on the benchmark's own
    seeded weights with the conf head shaped for 16 candidates an image.

    * Every detection of either side is matched on the other (same image
      and class, every box coordinate within ``judge.MATCH_TOL``), with no
      NMS decision turned: float32 on both sides moves a score by about
      1e-7, far from any threshold's turn.
    * Boxes, scores and each mask's largest pixel within 1e-5 of the
      reference prior that explains the detection best: the same float32
      arithmetic, up to the summation order of the convs (the backbone
      test above), through decode, softmax and the sigmoid of the mask
      product, none of which amplifies an error past a few ulps."""
    ref_cfg = reference_tiny_darknet_config()
    cfg = tiny_darknet_config()
    dev = torch.device('cpu')
    g = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (2, 96, 128, 3), generator=g,
                           dtype=torch.uint8)
    sd = make_weights(ref_cfg, {'weights': dict(
        cells.load_cell('yolact_darknet53.infer_b16').config['weights'],
        candidates_per_image=16)}, g, dev, frames)
    model = load_model(cfg, sd, dev, 'float32')
    with torch.inference_mode():
        out = forward_and_detect(cfg, model, frames, use_kernels=False)
    ref_model = ref_load_model(ref_cfg, sd, dev, 'float32')
    gaps, counts = judge.new_readings()
    tables = judge.ReferenceTables(ref_cfg, ref_model, frames)
    judge.judge_batch(out, tables, gaps, counts)
    numbers = judge.summary(gaps, counts)
    assert numbers['detections'] >= 8, numbers
    assert counts['unmatched'] == counts['nms_flips'] == 0, numbers
    assert int(out.valid.sum()) == int(tables.dets.valid.sum())
    for name in ('box_gap_max', 'score_gap_max', 'mask_px_gap_max'):
        assert numbers[name] <= 1e-5, (name, numbers)


def frame_change(seed):
    """The last stage's mean change between two random frames over its
    spread, for the reference's DarkNet-53 on the benchmark's seeded
    weights (``weights.init_state_dict``: xavier convs, each batch norm
    as the module starts it), at 128x128."""
    from benchmark import weights
    from benchmark.reference.models.resnet import DCNLayer
    trunk = ref_darknet.DarkNetBackbone((1, 2, 8, 8, 4)).eval()
    g = torch.Generator().manual_seed(seed)
    trunk.load_state_dict(weights.init_state_dict(trunk, g, DCNLayer,
                                                  torch.device('cpu')))
    frames = torch.randint(0, 256, (2, 3, 128, 128), generator=g) / 255
    with torch.no_grad():
        out = trunk(frames)[-1]
    return float((out[0] - out[1]).abs().mean() / out[0].std())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_seeded_darknet_answers_depend_on_the_frame(seed, monkeypatch):
    """The residual branches' batch norms start at RESIDUAL_BN_INIT, so the
    seeded trunk's output moves with its frame (0.11-0.16 of its spread
    on these seeds), and a stale answer or a dropped frame shows in the
    benchmark's judge.  Started at 1, as torch's batch norm, the 23
    branches pile up and it moves by 0.035-0.05."""
    assert frame_change(seed) > 0.08
    monkeypatch.setattr(ref_darknet, 'RESIDUAL_BN_INIT', 1.0)
    assert frame_change(seed) < 0.06


@pytest.mark.parametrize('size', [550, (480, 640)], ids=['550', '480x640'])
def test_priors_equal_the_ports(size):
    """yolact_darknet53's priors (pixel scales, square anchors) equal the
    port's bit for bit: 19,248 at 550, as yolact_base's."""
    want = anchors.generate_priors(PC.get_config('yolact_darknet53'), size)
    got = ref_anchors.generate_priors(RC.get_config('yolact_darknet53'),
                                      size)
    assert np.array_equal(got, want)
    if size == 550:
        assert got.shape == (19248, 4)


@pytest.mark.parametrize('name', ['yolact_darknet53', 'tiny'])
def test_state_dicts_have_the_same_keys_and_shapes(name):
    """One state dict loads into both models: the same keys, in the same
    order, of the same shapes (the reference's DarkNet names,
    ``_preconv.{0,1}``, ``layers.{s}.0.{0,1}``,
    ``layers.{s}.{b}.conv{1,2}.{0,1}``)."""
    if name == 'tiny':
        cfg, ref_cfg = tiny_darknet_config(), reference_tiny_darknet_config()
    else:
        cfg, ref_cfg = (PC.get_config(name), RC.get_config(name))
    with torch.device('meta'):
        port = Yolact(cfg).state_dict()
        ref = RefYolact(ref_cfg).state_dict()
    assert [(k, tuple(v.shape)) for k, v in port.items()] \
        == [(k, tuple(v.shape)) for k, v in ref.items()]
    if name == 'yolact_darknet53':
        assert 'backbone.layers.3.8.conv2.1.running_var' in ref
        assert sum(k.endswith('.0.weight') and 'backbone' in k
                   for k in ref) == 52


@pytest.mark.parametrize('img', [550, 301])
def test_channels_and_sizes_equal_the_ports(img):
    """Each stage's channels and each prediction level's size, at 550 and
    at an odd size."""
    cfg, ref_cfg = (PC.get_config('yolact_darknet53'),
                    RC.get_config('yolact_darknet53'))
    assert RC.backbone_channels(ref_cfg.backbone) \
        == PC.backbone_channels(cfg.backbone) == (64, 128, 256, 512, 1024)
    assert ref_anchors.feature_map_sizes(ref_cfg, img) \
        == anchors.feature_map_sizes(cfg, img)
