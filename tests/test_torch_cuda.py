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
absolute term covers outputs near zero after cancellation).  The DCN
backward kernel against autograd through the plain columns: the offset and
mask gradients and, in float32, grad_x within 1e-5 of each one's largest
entry (float32 sums over the channels and atomics in another order), NaN
where the plain version has NaN; in bfloat16 all three within one bf16 ulp
plus 1e-2 of the largest entry (the plain version rounds every product and
sum to bfloat16 and scatters in bfloat16, the kernel sums in float32 and
rounds once).  The stem's autograd.Function
against autograd through the plain stem within 1e-5 of the largest entry.
Tiny train steps with the kernels against the plain versions: losses
within 1e-4 relative, updated weights within 1e-6; for the s2d stem under
batch statistics within TINY_STEM_BATCH_STATS_ATOL, a limit checked in the
same test against two readings of the plain path (see there)."""

import pytest
import torch

import numpy as np

from test_torch_inputs import (SyntheticEvalSet, bf16_ulp, dcn_inputs,
                               make_train_batch, near_tie_boxes,
                               seed_offsets_state_dict, tiny_option_overrides,
                               tiny_plus_config, tiny_resnet_config,
                               ulp_distance, write_grid)
from yolact_tpu_torch.config import MaskType
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
    (8, 100, 70, 33), (1, 100, 70, 33),           # the options path, Md 33
    (2, 37, 16, 33), (2, 113, 16, 9),             # Md % 4 != 0, ragged D
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
@pytest.mark.parametrize('wide', [False, True], ids=['randn', 'wide'])
def test_stem_kernel_matches_plain(cuda, dtype, shape, wide):
    """`wide`: inputs 1 + k * 2^-15 (k < 2^12), whose low bits only the
    float32 kernel's split-TF32 lo halves carry."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = (1 + torch.randint(0, 1 << 12, shape, generator=gen).float()
         * 2.0 ** -15 if wide else torch.randn(shape, generator=gen))
    x = x.to(dtype).to(cuda)
    w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dtype).to(cuda)
    n0 = stem.launches
    got = stem.stem_conv_s2d(x, w2)
    torch.cuda.synchronize()
    assert stem.launches == n0 + 1
    want = stem.stem_conv_s2d_plain(x, w2)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    # NHWC storage, as the plain version's and the op's fake's
    b, _, h, w = shape
    assert got.stride() == want.stride() == (h * w * 64, 1, w * 64, 64)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = torch.ops.yolact_tpu_torch.stem_s2d(mode.from_tensor(x),
                                                   mode.from_tensor(w2))
    assert fake.stride() == got.stride()
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


def _assert_grads_match(got, want, dtype):
    """(grad_x, grad_offset, grad_mask) of the backward kernel against the
    plain version's; see the module docstring for the tolerances."""
    for name, g, w in zip(('x', 'offset', 'mask'), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g.isnan(), w.isnan()), name
        ok = ~w.isnan()
        g, w = g[ok].float(), w[ok].float()
        top = float(w.abs().max())
        tol = 1e-5 * top
        if dtype == torch.bfloat16:
            tol = bf16_ulp(w) + 1e-2 * top
        assert bool(((g - w).abs() <= tol).all()), (
            name, float((g - w).abs().max()), top)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('b,cin,h,stride', [(2, 16, 23, 1), (2, 60, 12, 2),
                                            (1, 5, 9, 1), (2, 128, 35, 2),
                                            (8, 256, 35, 1), (8, 60, 35, 1)])
@pytest.mark.parametrize('far', [False, True], ids=['mixed', 'far'])
def test_dcn_col2im_kernel_matches_plain(cuda, dtype, b, cin, h, stride, far):
    """`far`: besides dcn_inputs' NaN and infinite samples (taps 0-3 of the
    first pixel, both coordinates kept), every offset 10 to h / 2 pixels
    away, beyond the kernel's window halo, so the corners that stay in the
    map take its global path."""
    gen = torch.Generator().manual_seed(cin + h)
    x, offset, mask = dcn_inputs(gen, cuda, b, cin, h, stride, dtype)
    ho = offset.shape[-1]
    if far:
        size = 10 + torch.rand(offset.shape, generator=gen) * max(h / 2 - 10,
                                                                  1)
        sign = torch.randint(0, 2, offset.shape, generator=gen) * 2 - 1
        keep = torch.zeros(offset.shape, dtype=torch.bool)
        keep[0, :8, 0, 0] = True
        offset = torch.where(keep.to(cuda), offset, (size * sign).to(cuda))
    g_cols = torch.randn(b * ho * ho, 9 * cin, generator=gen).to(dtype)\
        .to(cuda)
    n0 = dcn.col2im_launches
    got = dcn.dcn_col2im(g_cols, x, offset, mask, 3, stride)
    torch.cuda.synchronize()
    assert dcn.col2im_launches == n0 + 1
    want = dcn.dcn_col2im_plain(g_cols, x, offset, mask, 3, stride)
    assert bool(want[1].isnan().any())           # the NaN offsets' samples
    _assert_grads_match(got, want, dtype)
    # a channels_last x is read as it lies
    again = dcn.dcn_col2im(
        g_cols, x.contiguous(memory_format=torch.channels_last), offset,
        mask, 3, stride)
    _assert_grads_match(again, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('b,cin,h,stride,rows', [
    (2, 16, 23, 1, (9, 17)), (2, 60, 12, 2, (3, 6)),
    (1, 5, 9, 1, (4, 9)), (2, 128, 69, 2, (17, 35)),   # a rank of two
    (8, 256, 35, 1, (18, 35)), (8, 512, 35, 2, (9, 18)),
])
def test_dcn_kernels_from_row0_match_plain(cuda, dtype, b, cin, h, stride,
                                           rows):
    """Both DCN kernels on output rows [r0, r1) of the map (row0 = r0, the
    whole map as x, a spatial rank's call): the columns bit-equal to the
    plain version's and to the whole call's rows; the backward within the
    plain version's tolerances, and grad_x against the whole call with the
    column gradient zero outside the rows."""
    r0, r1 = rows
    gen = torch.Generator().manual_seed(cin + h + r0)
    # finite offsets: a NaN sample outside the rows would put NaN into the
    # whole call's grad_x through its zero column gradient
    x, offset, mask = dcn_inputs(gen, cuda, b, cin, h, stride, dtype,
                                 finite=True)
    ho = offset.shape[-1]
    sub = [t[:, :, r0:r1].contiguous() for t in (offset, mask)]
    n0, c0 = dcn.launches, dcn.col2im_launches
    got = dcn.dcn_columns(x, *sub, 3, stride, 1, 1, r0)
    whole = dcn.dcn_columns(x, offset, mask, 3, stride)
    torch.cuda.synchronize()
    assert dcn.launches == n0 + 2
    want = dcn.dcn_columns_plain(x, *sub, 3, stride, 1, 1, r0)
    assert got.shape == want.shape == (b * (r1 - r0) * ho, 9 * cin)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert torch.equal(got.isnan(), want.isnan())
    rows_of_whole = whole.view(b, ho, ho, -1)[:, r0:r1].reshape(got.shape)
    assert torch.equal(got.nan_to_num(), rows_of_whole.nan_to_num())
    g_cols = torch.randn(b, ho, ho, 9 * cin, generator=gen).to(dtype)\
        .to(cuda)
    g_rows = g_cols[:, r0:r1].reshape(-1, 9 * cin).contiguous()
    grads = dcn.dcn_col2im(g_rows, x, *sub, 3, stride, 1, 1, r0)
    torch.cuda.synchronize()
    assert dcn.col2im_launches == c0 + 1
    _assert_grads_match(grads, dcn.dcn_col2im_plain(
        g_rows, x, *sub, 3, stride, 1, 1, r0), dtype)
    zeroed = torch.zeros_like(g_cols)
    zeroed[:, r0:r1] = g_cols[:, r0:r1]
    full = dcn.dcn_col2im(zeroed.view(-1, 9 * cin), x, offset, mask, 3,
                          stride)
    _assert_grads_match(
        grads, (full[0], full[1][:, :, r0:r1], full[2][:, :, r0:r1]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('stride', [1, 2])
def test_deform_conv2d_gradients_on_the_card(cuda, stride):
    """deform_conv2d on CUDA tensors records its two kernels for autograd:
    the gradients of x, offset, mask, weight and bias equal autograd through
    the plain version within 1e-5 of each one's largest entry."""
    gen = torch.Generator().manual_seed(stride)
    x, offset, mask = dcn_inputs(gen, cuda, 2, 16, 17, stride, torch.float32,
                                 finite=True)
    weight = (torch.randn(8, 16, 3, 3, generator=gen) * 0.1).to(cuda)
    bias = torch.randn(8, generator=gen).to(cuda)
    grads = {}
    n0, m0 = dcn.launches, dcn.col2im_launches
    for name, fn in (('kernel', dcn.deform_conv2d),
                     ('plain', dcn.deform_conv2d_plain)):
        leaves = [t.clone().requires_grad_()
                  for t in (x, offset, mask, weight, bias)]
        out = fn(*leaves, stride, 1, 1)
        assert out.requires_grad
        (out ** 2).sum().backward()
        grads[name] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    assert (dcn.launches, dcn.col2im_launches) == (n0 + 1, m0 + 1)
    for g, w in zip(grads['kernel'], grads['plain']):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    # what needs no gradient gets none, and no backward launch either
    out = dcn.deform_conv2d(x, offset, mask, weight.requires_grad_(), bias,
                            stride, 1, 1)
    out.sum().backward()
    assert dcn.col2im_launches == m0 + 1
    # with no graph to record, the same kernel is launched directly
    n1 = dcn.launches
    with torch.no_grad():
        direct = dcn.deform_conv2d(x, offset, mask, weight, bias, stride, 1,
                                   1)
    assert dcn.launches == n1 + 1 and direct.grad_fn is None
    assert torch.equal(direct, out.detach())


@pytest.mark.cuda
def test_stem_gradients_on_the_card(cuda):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 12, 37, 41, generator=gen).to(cuda)
    w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(cuda)
    grads = {}
    for name, fn in (('kernel', stem.stem_conv_s2d),
                     ('plain', stem.stem_conv_s2d_plain)):
        a, b = x.clone().requires_grad_(), w2.clone().requires_grad_()
        (fn(a, b) ** 2).sum().backward()
        grads[name] = (a.grad, b.grad)
    for g, w in zip(grads['kernel'], grads['plain']):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    # the image needs no gradient: none is computed
    b = w2.clone().requires_grad_()
    out = stem.stem_conv_s2d(x, b)
    out.sum().backward()
    assert b.grad is not None
    # with no graph to record, the same kernel is launched directly
    n0 = stem.launches
    with torch.no_grad():
        direct = stem.stem_conv_s2d(x, b)
    assert stem.launches == n0 + 1 and direct.grad_fn is None
    assert torch.equal(direct, out.detach())


@pytest.mark.cuda
def test_wrappers_without_a_gradient_raise_on_the_card(cuda):
    proto = torch.rand(1, 8, 8, 4, device=cuda)
    coeffs = torch.randn(1, 3, 4, device=cuda, requires_grad=True)
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7]] * 3], device=cuda)
    n0 = mask_assembly.launches
    with pytest.raises(RuntimeError, match='no gradient'):
        mask_assembly.assemble_masks(proto, coeffs, boxes)
    with pytest.raises(RuntimeError, match='no gradient'):
        nms.nms_iou_max(boxes.clone().requires_grad_())
    assert mask_assembly.launches == n0


@pytest.mark.cuda
def test_device_guard_switches_only_for_another_device(cuda):
    from yolact_tpu_torch.kernels import _build
    dev = torch.zeros(1, device=cuda).device         # a tensor's: indexed
    assert dev.index == torch.cuda.current_device()
    assert _build.device_guard(dev) is _build._NO_GUARD
    other = _build.device_guard(torch.device('cuda', dev.index + 1))
    assert isinstance(other, torch.cuda.device)      # built, not entered


# The updated weights' tolerance of the s2d stem's tiny train check under
# batch statistics, instead of 1e-6: there a perturbation of the plain
# stem's float32 output of 1e-7 of its largest value moves the weights
# after two steps by 8e-5 to 1.4e-4 (conv1), and a one-pass TF32 stem
# (2^-11 relative) by 1.4e-3 (a CPU run of the plain path), so 1e-6 holds
# only a stem bit-equal to cuDNN's.  The test takes both readings again on
# the card: the limit must admit the plain path perturbed at the kernel's
# own error level and refuse the one-pass TF32 stem.  With frozen batch
# norm (base_s2d_frozen_bn) the weights are held to 1e-6.
TINY_STEM_BATCH_STATS_ATOL = 5e-4


def _option_config(name, tmp_path, **kw):
    """The tiny direct-mask config, or every lincomb option at once."""
    if name == 'direct':
        return tiny_resnet_config(mask_type=MaskType.DIRECT, **kw)
    return tiny_resnet_config(**kw).copy(**tiny_option_overrides(
        write_grid(tmp_path / 'grid.npy')))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['direct', 'options'])
def test_tiny_option_pipelines_kernels_match_plain(cuda, tmp_path, name):
    """Pipeline (the s2d stem) of the tiny direct config and of the tiny
    config with every lincomb option, f32, with and without the kernels:
    as the other tiny pipelines; the IoU max and the stem launched on both,
    mask assembly on the options path only (9 prototypes: Md % 4 != 0);
    direct masks pasted into their boxes agree on >= 99.9% of pixels."""
    from yolact_tpu_torch.detect.postprocess import finish_masks_direct
    from yolact_tpu_torch.eval.evaluate import sanitize_boxes_np
    cfg = _option_config(name, tmp_path)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, 128, 128, 3),
                           generator=torch.Generator().manual_seed(1)
                           ).float().to(cuda)
    want = Pipeline(cfg, sd, cuda, 'float32', use_kernels=False)(frames)
    counts = (nms.launches, mask_assembly.launches, stem.launches)
    got = Pipeline(cfg, sd, cuda, 'float32')(frames)
    torch.cuda.synchronize()
    counts = [b - a for a, b in zip(counts, (
        nms.launches, mask_assembly.launches, stem.launches))]
    assert counts == [1, 0 if name == 'direct' else 1, 1]
    assert bool(got.valid.any())
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.classes, want.classes)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.masks, want.masks, rtol=0, atol=1e-4)
    if name == 'direct':
        n = int(got.valid[0].sum())
        boxes = sanitize_boxes_np(got.boxes[0, :n].cpu().numpy(), 160, 120)
        a = finish_masks_direct(got.masks[0, :n], boxes, 160, 120)
        b = finish_masks_direct(want.masks[0, :n], boxes, 160, 120)
        assert a.shape == (n, 120, 160) and (a == b).mean() >= 0.999
    else:
        assert got.masks.shape[2:] == (32, 32) and cfg.mask_dim == 9


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['direct', 'options'])
def test_tiny_option_train_steps_kernels_match_plain(cuda, tmp_path, name):
    """Two train steps of the tiny direct and options configs with the s2d
    stem and frozen batch norm (the batch-statistics heads run at full size
    in chip_smoke.py's phase 9), kernels against plain versions as
    test_tiny_train_steps_kernels_match_plain holds base_s2d_frozen_bn."""
    from yolact_tpu_torch.train.step import create_train_state, train_step
    cfg = _option_config(name, tmp_path, stem_s2d=True, freeze_bn=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        _tiny_train_steps(cuda, name, create_train_state, train_step, cfg)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['base_s2d', 'base_s2d_frozen_bn', 'plus',
                                  'plus_no_remat'])
def test_tiny_train_steps_kernels_match_plain(cuda, name):
    """Two train steps of a tiny model on the card with the kernels and with
    their plain versions, from the same weights and draws: the same losses
    and weights, the kernels launched as often as the blocks say.  Under
    PyTorch's deterministic algorithms: the atomics of the library's own
    backward kernels (bilinear upsample, gathers, pooling) otherwise make
    two runs of the same path differ by more than the tolerance."""
    from yolact_tpu_torch.train.step import create_train_state, train_step
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        _tiny_train_steps(cuda, name, create_train_state, train_step)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def _tf32_round(t):
    """`t` rounded as cvt.rna.tf32.f32 rounds, passing its gradient."""
    bits = t.detach().view(torch.int32)
    return t + (((bits + 0x1000) & -0x2000).view(torch.float32) - t).detach()


def _tiny_train_steps(cuda, name, create_train_state, train_step,
                      cfg=None):
    """Two steps of `cfg` (or of the config `name` stands for) with the
    kernels and with their plain versions (see the test above)."""
    atol = 1e-6
    n_dcn = 0
    if cfg is None and name.startswith('base_s2d'):
        cfg = tiny_resnet_config(stem_s2d=True,
                                 freeze_bn=name == 'base_s2d_frozen_bn')
        if name == 'base_s2d':
            atol = TINY_STEM_BATCH_STATS_ATOL
    elif cfg is None:
        # frozen batch norm: the tiny DCN config's last stage would
        # normalise over 8 values per channel, which amplifies the order
        # of the float32 atomics until the two runs part
        cfg = tiny_plus_config(
            train_remat='dcn' if name == 'plus' else 'none', freeze_bn=True)
        n_dcn = 3
    sd = seed_offsets_state_dict(
        random_state_dict(cfg, torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1))
    batch = make_train_batch(np.random.RandomState(0), cfg)
    plain_stem, stem_input = stem.stem_conv_s2d_plain, []

    def run(kernels, conv=plain_stem):
        stem.stem_conv_s2d_plain = conv
        try:
            state = create_train_state(cfg, device=cuda, state_dict=sd)
            gen = torch.Generator(device=cuda).manual_seed(5)
            counts = (stem.launches, dcn.launches, dcn.col2im_launches)
            losses = [train_step(state, batch, gen, use_kernels=kernels)
                      for _ in range(2)]
            torch.cuda.synchronize()
        finally:
            stem.stem_conv_s2d_plain = plain_stem
        counts = [b - a for a, b in zip(counts, (
            stem.launches, dcn.launches, dcn.col2im_launches))]
        fwd = n_dcn * (2 if cfg.train_remat == 'dcn' else 1)
        assert counts == ([2 * cfg.stem_s2d, 2 * fwd, 2 * n_dcn]
                          if kernels else [0, 0, 0])
        assert all(step['finite'] for step in losses)
        return losses, state.model.state_dict()

    def recording(x, w2):
        if not stem_input:
            stem_input.extend((x.detach().clone(), w2.detach().clone()))
        return plain_stem(x, w2)

    def max_diff(got, want):
        return max(float((got[k].float() - want[k].float()).abs().max())
                   for k in got)

    lk, wk = run(True)
    lp, wp = run(False, recording)
    for a, b in zip(lk, lp):
        for k in a:
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-4), k
    for k in wk:
        torch.testing.assert_close(wk[k], wp[k], rtol=0, atol=atol)
    if name == 'base_s2d':
        # the limit's two readings: the plain stem's output with noise of
        # the kernel's rms error on this input, and a one-pass TF32 stem
        x, w2 = stem_input
        sigma = float((stem.stem_conv_s2d(x, w2) - plain_stem(x, w2))
                      .pow(2).mean().sqrt())

        def noisy(x, w2):
            out = plain_stem(x, w2)
            gen = torch.Generator(device=cuda).manual_seed(1)
            return out + sigma * torch.randn(out.shape, device=cuda,
                                             generator=gen)

        low = max_diff(run(False, noisy)[1], wp)
        control = max_diff(run(False, lambda x, w2: plain_stem(
            _tf32_round(x), _tf32_round(w2)))[1], wp)
        print(f'tiny base_s2d batch statistics: updated weights max abs '
              f'diff, kernels {max_diff(wk, wp)!r}, plain stem with noise of '
              f'the kernel\'s rms error ({sigma!r}) {low!r}, one-pass TF32 '
              f'stem {control!r} (limit {atol!r})')
        assert low <= atol < control, (sigma, low, control)


@pytest.mark.cuda
@pytest.mark.parametrize('train_remat', ['dcn', 'none'])
def test_dcn_col2im_on_train_step_inputs(cuda, train_remat):
    """The DCN backward kernel on the inputs a tiny plus train step gives it
    (recorded around the kernel's launch in DCNColumns.backward): its
    gradients against autograd through the plain columns on the same
    inputs."""
    from yolact_tpu_torch.train.step import create_train_state, train_step
    cfg = tiny_plus_config(train_remat=train_remat, freeze_bn=True)
    sd = seed_offsets_state_dict(
        random_state_dict(cfg, torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1))
    state = create_train_state(cfg, device=cuda, state_dict=sd)
    captured, launch = [], dcn._launch_col2im

    def record(g_cols, xh, offset, mask, dims):
        captured.append((g_cols.clone(), xh.clone(), offset.clone(),
                         mask.clone(), dims))
        return launch(g_cols, xh, offset, mask, dims)

    dcn._launch_col2im = record
    try:
        out = train_step(state, make_train_batch(np.random.RandomState(0), cfg),
                         torch.Generator(device=cuda).manual_seed(5))
    finally:
        dcn._launch_col2im = launch
    torch.cuda.synchronize()
    assert out['finite'] and len(captured) == 3
    for g_cols, xh, offset, mask, dims in captured:
        _, _, _, _, _, _, k, stride, pad, dil, row0 = dims
        x = xh.permute(0, 3, 1, 2)
        assert bool((offset.abs() > 0.5).any())
        got = dcn.dcn_col2im(g_cols, x, offset, mask, k, stride, pad, dil,
                             row0)
        want = dcn.dcn_col2im_plain(g_cols, x, offset, mask, k, stride, pad,
                                    dil, row0)
        _assert_grads_match(got, want, x.dtype)


@pytest.mark.cuda
def test_trainer_on_card(cuda, tmp_path):
    """cli/train on the card: the loader hands over pinned batches, a tiny
    bf16 run with the s2d stem over in-memory frames takes its steps with
    the stem kernel, saves, and resumes bit for bit."""
    from test_torch_inputs import SyntheticTrainSet
    from yolact_tpu_torch.cli.train import train
    from yolact_tpu_torch.config import register_config
    from yolact_tpu_torch.data.augmentations import SSDAugmentation
    from yolact_tpu_torch.data.loader import BatchLoader
    from yolact_tpu_torch.train.checkpoint import load_checkpoint
    from yolact_tpu_torch.train.step import create_train_state
    cfg = register_config(tiny_resnet_config().copy(name='cardtrain',
                                                     max_iter=3))
    data = SyntheticTrainSet(4, ((96, 128), (128, 96)), cfg.num_classes,
                             SSDAugmentation(cfg, rng=np.random.RandomState(0)))
    loader = BatchLoader(data, 2, max_gt=8, num_workers=1, pin_memory=True)
    try:
        assert all(v.is_pinned() for v in loader.next_batch().values()
                   if isinstance(v, torch.Tensor))
    finally:
        loader.stop()
    before = stem.launches
    run = train(['--config', 'cardtrain', '--batch_size', '2', '--no_log',
                 '--no_autoscale',
                 '--save_folder', str(tmp_path), '--num_workers', '2',
                 '--validation_epoch', '0', '--stem_s2d', '--max_gt', '8',
                 '--compute_dtype', 'bfloat16'], dataset=data)
    assert stem.launches - before == 3 and run['state'].step == 3
    assert run['state'].model.compute_dtype == torch.bfloat16
    reloaded = create_train_state(run['state'].cfg, device=cuda)
    load_checkpoint(run['path'], reloaded)
    want, got = run['state'].model.state_dict(), reloaded.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
def test_float32_pipeline_runs_without_tf32_under_the_default_flags(cuda):
    """float32 means float32: a float32 Pipeline built under the process's
    default flags (cuDNN's TF32 on; the matmul flag turned on too) turns
    TF32 off itself, and its kernel path matches the plain path run with
    TF32 off by the float32 rule (scores and boxes 1e-5, masks 1e-4)."""
    cfg = tiny_resnet_config()
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, 128, 128, 3),
                           generator=torch.Generator().manual_seed(1)
                           ).float().to(cuda)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    got = Pipeline(cfg, sd, cuda, 'float32')(frames)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    want = Pipeline(cfg, sd, cuda, 'float32', use_kernels=False)(frames)
    torch.cuda.synchronize()
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.classes, want.classes)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.masks, want.masks, rtol=0, atol=1e-4)


CUDA_ROW_OPS = ('group_norm', 'group_norm_1_group', 'conv_transpose_k2_s2',
                'conv_transpose_k3_s2_p1_op1', 'cat')


@pytest.mark.cuda
@pytest.mark.parametrize('space,height', [(2, 11), (3, 2)])
def test_group_norm_and_transposed_rows_on_the_card(cuda, space, height):
    """Group norm's moments over the space ranks, the transposed convs'
    rows and a 'cat' entry (tests/torch_spatial_worker.py:
    config_op_cases) on gloo ranks sharing the card, float32, against the
    whole-map op on the card: outputs and input gradients within 1e-5 of
    their largest entry (the moments and the convs sum in another order);
    on a map of 2 rows over 3 ranks one rank owns none."""
    import torch_spatial_worker as W
    from torch_parallel_worker import run_ranks
    from yolact_tpu_torch.parallel.mesh import own
    ranks = run_ranks(W.cuda_config_ops_run, space, space, height,
                      CUDA_ROW_OPS)
    for name in CUDA_ROW_OPS:
        whole = W.config_op_cases(height)[name][0].to(cuda, torch.float32)
        x = W.whole_map(0, W.map_shape(height)).to(cuda, torch.float32)
        x.requires_grad_(True)
        y = whole(x)
        (y * W.whole_map(1, tuple(y.shape)).to(cuda, torch.float32)
         ).sum().backward()
        y, g = y.detach().cpu().numpy(), x.grad.cpu().numpy()
        for rank, got in enumerate(ranks):
            lo, hi = got[name]['own']
            assert (lo, hi) == own(y.shape[2], rank, space)
            np.testing.assert_allclose(got[name]['y'], y[:, :, lo:hi],
                                       rtol=0, err_msg=name,
                                       atol=1e-5 * np.abs(y).max())
        grad = np.concatenate([r[name]['grad'] for r in ranks], 2)
        np.testing.assert_allclose(grad, g, rtol=0, err_msg=name,
                                   atol=1e-5 * np.abs(g).max())


SPAN_CHILDREN = ('input', 'preprocess', 'backbone', 'fpn', 'heads', 'detect',
                 'masks', 'maskiou')


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['yolact_base', 'yolact_plus_base'])
def test_spans_bracket_kernels_and_cover_the_call(cuda, tmp_path, name):
    """A profiled bfloat16 b16 call at 550² (raw 480x640 frames, random
    weights): every kernel falls inside the GPU user annotation of the
    innermost span (``utils/timer.py``) open when it was launched, within
    1 µs, and the device ms of the call's layer spans sum to within 5% of
    the ``call`` span's (the host's own gaps between them are the rest)."""
    import json
    from yolact_tpu_torch.config import get_config
    from yolact_tpu_torch.utils import timer
    cfg = get_config(name)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    pipe = Pipeline(cfg, sd, cuda, 'bfloat16')
    frames = np.random.default_rng(0).integers(
        0, 256, (16, 480, 640, 3), dtype=np.uint8)
    for _ in range(3):
        pipe(frames)
    torch.cuda.synchronize()
    timer.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pipe(frames)
        torch.cuda.synchronize()
    (root,) = timer.roots()
    children = [s.name for s in root.spans if s.parent is root.spans[0]]
    assert children == [c for c in SPAN_CHILDREN
                        if c != 'maskiou' or cfg.use_maskiou]
    call_ms = root.device_ms('call')
    parts = sum(root.device_ms(c) for c in children)
    assert 0.95 * call_ms <= parts <= call_ms * 1.0001, (parts, call_ms)

    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    spans = {s.name for s in root.spans}
    host = [e for e in events if e.get('cat') == 'user_annotation'
            and e['name'] in spans]
    device = [e for e in events if e.get('cat') == 'gpu_user_annotation'
              and e['name'] in spans]
    kernels = {e['args']['correlation']: e for e in events
               if e.get('cat') == 'kernel'}
    launches = [e for e in events if e.get('cat') in ('cuda_runtime',
                                                      'cuda_driver')
                and e['args'].get('correlation') in kernels]
    assert len(host) == len(root.spans) and kernels and launches
    # a kernel belongs to the innermost span open when it was launched
    # (an enclosing span's annotation on the device is its children's)
    launched_in = {}
    for e in launches:
        around = [h for h in host if h['ts'] <= e['ts'] <= h['ts'] + h['dur']]
        assert around, e['name']
        name = min(around, key=lambda h: h['dur'])['name']
        launched_in.setdefault(name, []).append(
            kernels[e['args']['correlation']])
    assert sum(map(len, launched_in.values())) == len(kernels)
    for name, inside in launched_in.items():
        brackets = [d for d in device if d['name'] == name]
        assert brackets, name
        for k in inside:
            assert any(d['ts'] - 1 <= k['ts'] and
                       k['ts'] + k['dur'] <= d['ts'] + d['dur'] + 1
                       for d in brackets), (name, k['name'])
