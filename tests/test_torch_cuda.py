"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without one.  The
file imports nothing of JAX or of the JAX package (its tiny configs are
test_torch_inputs.py's, built with the port's config), so it runs on the
GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: mask assembly 1e-5 with the same zero pattern and NaNs (the
kernel sums the K products on the tensor cores in split TF32, ~2^-21
relative per product, in another order than the float32 plain version,
then an approximate sigmoid), IoU max bit for bit (the same IoU operands,
built with --fmad=false, compared as exact fractions and divided once), DCN columns exact in float32 and bfloat16 (the
same float operations, rounded at the same points, NaN where the plain
version has NaN); the tiny pipelines' kernel and plain paths agree like
chip_smoke.py's main paths (identical classes and validity, scores and
boxes within 1e-5, masks and mask_scores within 1e-4).  The s2d stem kernel
against its plain version (cuDNN's float32 conv, TF32 off, rounded once):
within 1e-5 of max|out| in float32 (cuDNN may sum the 192 products in
another order), and in bfloat16 within one bf16 ulp of |plain| plus 1e-5 of
max|plain| (the tensor cores sum the exact products in another order; the
absolute term covers outputs near zero after cancellation)."""

import pytest
import torch

from test_torch_inputs import (SyntheticEvalSet, bf16_ulp, dcn_inputs,
                               near_tie_boxes, seed_offsets_state_dict,
                               tiny_plus_config, tiny_resnet_config,
                               ulp_distance)
from yolact_tpu_torch.eval.evaluate import evaluate_dataset
from yolact_tpu_torch.infer import (Pipeline, forward_and_detect, load_model,
                                    random_state_dict)
from yolact_tpu_torch.kernels import dcn, mask_assembly, nms, stem

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the GPU machine)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _mask_inputs(gen, dev, b, d, hw, md):
    n = max(d, 4)
    proto = torch.rand(b, hw, hw, md, generator=gen)
    coeffs = torch.tanh(torch.randn(b, n, md, generator=gen))
    xy1 = torch.rand(b, n, 2, generator=gen) * 0.6
    wh = torch.rand(b, n, 2, generator=gen) * 0.4 + 0.02
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 0] = boxes[:, 0, [2, 3, 0, 1]]               # inverted
    boxes[:, 1] = torch.tensor([-0.3, -0.2, 1.4, 1.1])    # outside [0, 1]
    boxes[:, 2] = 0.5                                     # zero area
    boxes[:, 3] = torch.tensor([2, 3, 9, 7]) / hw          # on pixel edges
    # D = 1 keeps the inverted box; D < 4 drops some special rows
    return [proto.to(dev), coeffs[:, :d].contiguous().to(dev),
            boxes[:, :d].contiguous().to(dev)]


def _assert_masks_match(got, want):
    """Within 1e-5, zeros where the plain version has zeros (the crop),
    NaN where it has NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5, equal_nan=True)
    assert torch.equal(got == 0, want == 0)
    assert torch.equal(got.isnan(), want.isnan())


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
@pytest.mark.parametrize('b,d,hw,md', [
    (2, 37, 16, 8), (2, 100, 138, 32), (1, 5, 7, 3),
    (8, 100, 138, 32), (1, 100, 138, 32),         # yolact_base b8, b1
    (2, 1, 16, 8), (2, 113, 16, 40),              # D = 1; two D passes
    (1, 37, 69, 8), (2, 37, 7, 40),               # Hp*Wp % 4 != 0
])
def test_mask_assembly_kernel_matches_plain(cuda, b, d, hw, md):
    args = _mask_inputs(torch.Generator().manual_seed(d), cuda, b, d, hw, md)
    n0 = mask_assembly.launches
    got = mask_assembly.assemble_masks(*args)
    torch.cuda.synchronize()
    assert mask_assembly.launches == n0 + 1
    want = mask_assembly.assemble_masks_plain(*args)
    _assert_masks_match(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('md', [3, 32])
def test_mask_assembly_kernel_nan_coefficients(cuda, md):
    """A NaN coefficient makes its whole mask NaN (the plain version's
    NaN * 0 outside the crop); the other masks are untouched."""
    proto, coeffs, boxes = _mask_inputs(torch.Generator().manual_seed(md),
                                        cuda, 2, 70, 138, md)
    coeffs[1, 66, md // 2] = float('nan')
    got = mask_assembly.assemble_masks(proto, coeffs, boxes)
    want = mask_assembly.assemble_masks_plain(proto, coeffs, boxes)
    assert bool(want[1, 66].isnan().all())
    _assert_masks_match(got, want)


@pytest.mark.cuda
def test_mask_assembly_rejects_what_it_cannot_take(cuda):
    n0 = mask_assembly.launches
    for d, md in ((4, mask_assembly.MAX_MD + 1), (400, 64)):
        assert (md > mask_assembly.MAX_MD
                or mask_assembly.smem_bytes(d, md) > mask_assembly.MAX_SMEM)
        with pytest.raises(ValueError):
            mask_assembly.assemble_masks(torch.zeros(1, 4, 4, md, device=cuda),
                                         torch.zeros(1, d, md, device=cuda),
                                         torch.zeros(1, d, 4, device=cuda))
    assert mask_assembly.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize('n,k', [(6, 37), (640, 200), (3, 1), (2, 1100),
                                 (80, 200)])
def test_iou_max_kernel_matches_plain(cuda, n, k):
    boxes = _iou_inputs(torch.Generator().manual_seed(k), cuda, n, max(k, 6))
    boxes = boxes[:, :k].contiguous()
    n0 = nms.launches
    got = nms.nms_iou_max(boxes)
    torch.cuda.synchronize()
    assert nms.launches == n0 + 1
    assert torch.equal(got, nms.nms_iou_max_plain(boxes))


@pytest.mark.cuda
@pytest.mark.parametrize('rows', ['near_ties', 'identical', 'nonfinite'])
def test_iou_max_kernel_is_bit_equal_on_adversarial_rows(cuda, rows):
    """IoUs equal from different fractions, one ulp apart or with equal
    float32 cross products (the kernel's exact tie test); rows of one
    repeated box; infinite and NaN coordinates."""
    if rows == 'near_ties':
        boxes = torch.from_numpy(near_tie_boxes(80, 200))
    elif rows == 'identical':
        boxes = torch.tensor([0.1, 0.2, 0.4, 0.7]).expand(16, 200, 4)
    else:
        inf, nan = float('inf'), float('nan')
        boxes = _iou_inputs(torch.Generator().manual_seed(5), 'cpu', 80, 200)
        boxes[:, 7:9] = torch.tensor([[0.0, 0.0, inf, inf],
                                      [nan, nan, nan, nan]])
    boxes = boxes.contiguous().to(cuda)
    got = nms.nms_iou_max(boxes)
    want = nms.nms_iou_max_plain(boxes)
    assert torch.equal(got, want)
    if rows == 'near_ties':
        assert bool((want[:, -1] > 0).all())


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
    """The plain 7x7/s2 stem (load_model + forward_and_detect: Pipeline
    takes the s2d stem for raw frames)."""
    cfg = tiny_resnet_config()
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, 128, 128, 3),
                           generator=torch.Generator().manual_seed(1)
                           ).float().to(cuda)
    model = load_model(cfg, sd, cuda)
    with torch.inference_mode():
        want = forward_and_detect(cfg, model, frames, use_kernels=False)
        n0, m0, s0 = nms.launches, mask_assembly.launches, stem.launches
        got = forward_and_detect(cfg, model, frames)
    torch.cuda.synchronize()
    assert nms.launches > n0 and mask_assembly.launches > m0
    assert stem.launches == s0
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
    (8, 60, 35, 1),                                  # Cin % 8 != 0 at b8
])
def test_dcn_kernel_matches_plain(cuda, dtype, b, cin, h, stride):
    """JAX's [B*Ho*Wo, K*K*Cin] columns, bit-equal to the plain version,
    from an NCHW x and from a channels_last one."""
    x, offset, mask = dcn_inputs(torch.Generator().manual_seed(cin * h),
                                 cuda, b, cin, h, stride, dtype)
    n0 = dcn.launches
    got = dcn.dcn_columns(x, offset, mask, 3, stride)
    torch.cuda.synchronize()
    assert dcn.launches == n0 + 1
    want = dcn.dcn_columns_plain(x, offset, mask, 3, stride)
    ho = dcn.out_size(h, 3, stride, 1, 1)
    assert got.shape == want.shape == (b * ho * ho, 9 * cin)
    assert got.dtype == want.dtype == dtype
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])
    cl = dcn.dcn_columns(x.contiguous(memory_format=torch.channels_last),
                         offset, mask, 3, stride)
    assert torch.equal(cl.nan_to_num(), got.nan_to_num())


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
        (torch.zeros(1, 4, 6, 12, device=cuda)[..., ::2], offset,
         mask),                                # neither NCHW nor NHWC
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


def _rel_err(got, want):
    """Largest abs difference over the largest |want| (float32)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(1, 12, 275, 275), (8, 12, 275, 275),
                                   (2, 12, 37, 41), (1, 12, 3, 5)])
def test_stem_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(dtype).to(cuda)
    w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dtype).to(cuda)
    n0 = stem.launches
    got = stem.stem_conv_s2d(x, w2)
    torch.cuda.synchronize()
    assert stem.launches == n0 + 1
    want = stem.stem_conv_s2d_plain(x, w2)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        assert _rel_err(got, want) <= 1e-5
    else:
        top = want.float().abs().max()
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= bf16_ulp(want) + 1e-5 * top).all())
        big = want.float().abs() >= 1e-3 * top
        assert ulp_distance(got[big], want[big]) <= 1


@pytest.mark.cuda
def test_stem_wrapper_rejects_bad_inputs(cuda):
    x = torch.zeros(1, 12, 8, 8, device=cuda)
    w2 = torch.zeros(64, 12, 4, 4, device=cuda)
    bad = [
        (x[:, :4], w2),                                   # channels
        (x, w2[:32]),                                     # weight shape
        (x.bfloat16(), w2),                               # dtypes differ
        (x.half(), w2.half()),                            # dtype
        (x.transpose(2, 3), w2),                          # not contiguous
        (x, w2.cpu()),                                    # devices
    ]
    n0 = stem.launches
    for args in bad:
        with pytest.raises(ValueError):
            stem.stem_conv_s2d(*args)
    assert stem.launches == n0


@pytest.mark.cuda
def test_tiny_s2d_pipeline_kernels_match_plain(cuda):
    cfg = tiny_resnet_config(stem_s2d=True)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, 128, 128, 3),
                           generator=torch.Generator().manual_seed(1)
                           ).float().to(cuda)
    want = Pipeline(cfg, sd, cuda, 'float32', use_kernels=False)(frames)
    s0 = stem.launches
    got = Pipeline(cfg, sd, cuda, 'float32')(frames)
    torch.cuda.synchronize()
    assert stem.launches == s0 + 1
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.classes, want.classes)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.masks, want.masks, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('fast_nms,stem_s2d', [(True, True), (False, False)],
                         ids=['fast_s2d', 'traditional'])
def test_evaluate_dataset_on_cuda(cuda, fast_nms, stem_s2d):
    """The eval loop on the card, with the kernels and with their plain
    versions: the same mAP table, and the kernels were launched."""
    cfg = tiny_resnet_config(stem_s2d=stem_s2d)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    data = SyntheticEvalSet(5, cfg.max_size, cfg.num_classes, seed=3)
    kw = dict(compute_dtype='float32', eval_batch_size=2, fast_nms=fast_nms,
              quiet=True)
    want = evaluate_dataset(cfg, sd, data, cuda, use_kernels=False, **kw)
    counts = (stem.launches, nms.launches, mask_assembly.launches)
    got = evaluate_dataset(cfg, sd, data, cuda, **kw)
    torch.cuda.synchronize()
    assert got == want and set(got) == {'box', 'mask'}
    ran = [now > before for now, before in zip(
        (stem.launches, nms.launches, mask_assembly.launches), counts)]
    assert ran == [stem_s2d, fast_nms, fast_nms]
