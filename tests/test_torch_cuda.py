"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without one.  The
file imports no JAX, so it runs on the GPU machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: mask assembly 1e-5 (a K-term float32 dot product summed in
another order, then a sigmoid), IoU max exact (the same float operations,
built with --fmad=false), DCN columns exact in float32 and within 1 ulp in
bfloat16 (the same float operations, rounded at the same points, NaN where
the plain version has NaN); the tiny pipelines' kernel and plain paths
agree like chip_smoke.py's main paths (identical classes and validity,
scores and boxes within 1e-5, masks and mask_scores within 1e-4)."""

import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import (dcn_inputs, seed_offsets_state_dict,
                               ulp_distance)
from yolact_tpu_torch.infer import Pipeline, random_state_dict
from yolact_tpu_torch.kernels import dcn, mask_assembly, nms

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the GPU machine)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _mask_inputs(gen, dev, b, d, hw, md):
    proto = torch.rand(b, hw, hw, md, generator=gen)
    coeffs = torch.tanh(torch.randn(b, d, md, generator=gen))
    xy1 = torch.rand(b, d, 2, generator=gen) * 0.6
    wh = torch.rand(b, d, 2, generator=gen) * 0.4 + 0.02
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 0] = boxes[:, 0, [2, 3, 0, 1]]               # inverted
    boxes[:, 1] = torch.tensor([-0.3, -0.2, 1.4, 1.1])    # outside [0, 1]
    boxes[:, 2] = 0.5                                     # zero area
    boxes[:, 3] = torch.tensor([2, 3, 9, 7]) / hw          # on pixel edges
    return [t.to(dev) for t in (proto, coeffs, boxes)]


def _iou_inputs(gen, dev, n, k):
    xy1 = torch.rand(n, k, 2, generator=gen) * 0.6
    wh = torch.rand(n, k, 2, generator=gen) * 0.3 + 0.02
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 1] = boxes[:, 0]                             # IoU exactly 1
    boxes[:, 2, 2:] = boxes[:, 2, :2]                     # zero area
    inf, nan = float('inf'), float('nan')
    boxes[:, 3] = torch.tensor([0.1, 0.1, inf, inf])
    boxes[:, 4] = torch.tensor([-inf, 0.2, inf, 0.4])
    boxes[:, 5] = torch.tensor([nan, 0.1, 0.3, 0.3])
    return boxes.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize('b,d,hw,md', [(2, 37, 16, 8), (2, 100, 138, 32),
                                       (1, 5, 7, 3)])
def test_mask_assembly_kernel_matches_plain(cuda, b, d, hw, md):
    args = _mask_inputs(torch.Generator().manual_seed(d), cuda, b, d, hw, md)
    n0 = mask_assembly.launches
    got = mask_assembly.assemble_masks(*args)
    torch.cuda.synchronize()
    assert mask_assembly.launches == n0 + 1
    want = mask_assembly.assemble_masks_plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got == 0, want == 0)


@pytest.mark.cuda
@pytest.mark.parametrize('n,k', [(6, 37), (640, 200), (3, 1), (2, 1100)])
def test_iou_max_kernel_matches_plain(cuda, n, k):
    boxes = _iou_inputs(torch.Generator().manual_seed(k), cuda, n, max(k, 6))
    boxes = boxes[:, :k].contiguous()
    n0 = nms.launches
    got = nms.nms_iou_max(boxes)
    torch.cuda.synchronize()
    assert nms.launches == n0 + 1
    assert torch.equal(got, nms.nms_iou_max_plain(boxes))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_shapes(cuda):
    with pytest.raises(ValueError):
        nms.nms_iou_max(torch.zeros(2, 5, 3, device=cuda))
    with pytest.raises(ValueError):
        mask_assembly.assemble_masks(torch.zeros(1, 4, 4, 8, device=cuda),
                                     torch.zeros(1, 3, 7, device=cuda),
                                     torch.zeros(1, 3, 4, device=cuda))


@pytest.mark.cuda
def test_tiny_pipeline_kernels_match_plain(cuda):
    cfg = tiny_resnet_config()
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, 128, 128, 3),
                           generator=torch.Generator().manual_seed(1)
                           ).float().to(cuda)
    want = Pipeline(cfg, sd, cuda, use_kernels=False)(frames)
    n0, m0 = nms.launches, mask_assembly.launches
    got = Pipeline(cfg, sd, cuda)(frames)
    torch.cuda.synchronize()
    assert nms.launches > n0 and mask_assembly.launches > m0
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.classes, want.classes)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.masks, want.masks, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('b,cin,h,stride', [
    (2, 5, 9, 1), (1, 3, 7, 2),                      # tiny
    (1, 128, 138, 2), (1, 128, 69, 1), (1, 256, 69, 2), (2, 256, 35, 1),
    (1, 512, 35, 2),                                 # yolact_plus_base 550
])
def test_dcn_kernel_matches_plain(cuda, dtype, b, cin, h, stride):
    x, offset, mask = dcn_inputs(torch.Generator().manual_seed(cin * h),
                                 cuda, b, cin, h, stride, dtype)
    n0 = dcn.launches
    got = dcn.dcn_columns(x, offset, mask, 3, stride)
    torch.cuda.synchronize()
    assert dcn.launches == n0 + 1
    want = dcn.dcn_columns_plain(x, offset, mask, 3, stride)
    assert got.dtype == want.dtype == dtype
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    if dtype == torch.float32:
        assert torch.equal(got[~nan], want[~nan])
    else:
        assert ulp_distance(got[~nan], want[~nan]) <= 1


@pytest.mark.cuda
def test_dcn_wrapper_rejects_bad_inputs(cuda):
    x = torch.zeros(1, 4, 6, 6, device=cuda)
    offset = torch.zeros(1, 18, 6, 6, device=cuda)
    mask = torch.zeros(1, 9, 6, 6, device=cuda)
    bad = [
        (x.half(), offset, mask),                         # dtype
        (x, offset.bfloat16(), mask),                     # offset dtype
        (x, offset[:, :, :5], mask),                      # shape
        (x, offset, mask[:, :8]),                         # mask shape
        (torch.zeros(1, 6, 6, 4, device=cuda).permute(0, 3, 1, 2), offset,
         mask),                                           # not contiguous
        (x, offset.cpu(), mask),                          # devices
    ]
    n0 = dcn.launches
    for args in bad:
        with pytest.raises(ValueError):
            dcn.dcn_columns(*args)
    assert dcn.launches == n0


@pytest.mark.cuda
def test_tiny_plus_pipeline_kernels_match_plain(cuda):
    cfg = tiny_plus_config()
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    sd = seed_offsets_state_dict(sd, torch.Generator().manual_seed(2), 0.5,
                                 4.0)
    frames = torch.randint(0, 256, (2, 128, 128, 3),
                           generator=torch.Generator().manual_seed(1)
                           ).float().to(cuda)
    want = Pipeline(cfg, sd, cuda, 'float32', use_kernels=False)(frames)
    n0, m0, d0 = nms.launches, mask_assembly.launches, dcn.launches
    got = Pipeline(cfg, sd, cuda, 'float32')(frames)
    torch.cuda.synchronize()
    assert nms.launches > n0 and mask_assembly.launches > m0
    assert dcn.launches == d0 + 3                  # one per DCN block
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.classes, want.classes)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.masks, want.masks, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.mask_scores, want.mask_scores, rtol=0,
                               atol=1e-4)
