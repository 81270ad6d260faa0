"""The port's two kernels (yolact_tpu_torch.kernels): the plain PyTorch
versions against the JAX package's Pallas kernels (interpret mode) and XLA
references on the CPU.  The CUDA kernels are held against the plain
versions in test_torch_cuda.py.

Tolerances: mask assembly 1e-5 (a K-term float32 dot product summed in
another order, then a sigmoid), IoU max 1e-6 (the same float operations).
The CUDA IoU-max kernel's divide-free rule (csrc/fast_nms_iou.cu) is
transcribed in numpy here and held bit-equal to the plain version, since
the kernel itself cannot run on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolact_tpu.detect.detection import _triu_max
from yolact_tpu.kernels.mask_assembly import (assemble_masks_batched_pallas,
                                              assemble_masks_pallas,
                                              assemble_masks_xla)
from yolact_tpu.kernels.nms_pallas import nms_iou_max_pallas
from test_torch_inputs import near_tie_boxes
from yolact_tpu.ops.boxes import jaccard as jax_jaccard
from yolact_tpu_torch.kernels import _build, mask_assembly, nms

torch.set_num_threads(2)


def _mask_inputs(rng, b, hp, wp, md, d):
    proto = rng.rand(b, hp, wp, md).astype(np.float32)
    coeffs = np.tanh(rng.randn(b, d, md)).astype(np.float32)
    xy1 = rng.rand(b, d, 2) * 0.6
    wh = rng.rand(b, d, 2) * 0.4 + 0.02
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    # inverted boxes (x1 > x2, y1 > y2), boxes out of [0, 1], a zero-area
    # box and one on exact pixel edges
    boxes[:, 0] = boxes[:, 0, [2, 3, 0, 1]]
    boxes[:, 1] = [-0.3, -0.2, 1.4, 1.1]
    boxes[:, 2] = [0.5, 0.5, 0.5, 0.5]
    boxes[:, 3] = [2 / wp, 3 / hp, 9 / wp, 7 / hp]
    return proto, coeffs, boxes


def _iou_inputs(rng, n, k):
    xy1 = rng.rand(n, k, 2) * 0.6
    wh = rng.rand(n, k, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                 # duplicate: IoU exactly 1
    boxes[:, 2, 2:] = boxes[:, 2, :2]         # zero-area boxes
    boxes[:, 3] = 0.0
    boxes[:, 4] = 0.0
    return boxes


def _with_nonfinite(boxes):
    boxes = boxes.copy()
    boxes[:, 5] = [0.1, 0.1, np.inf, np.inf]
    boxes[:, 6] = [-np.inf, 0.2, np.inf, 0.4]
    boxes[:, 7] = [np.nan, 0.1, 0.3, 0.3]
    return boxes


@pytest.mark.parametrize('d', [50, 37])
def test_plain_mask_assembly_matches_pallas_and_xla(rng, d):
    proto, coeffs, boxes = _mask_inputs(rng, 2, 16, 12, 8, d)
    got = mask_assembly.assemble_masks_plain(
        torch.from_numpy(proto), torch.from_numpy(coeffs),
        torch.from_numpy(boxes)).numpy()
    assert got.shape == (2, d, 16, 12)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(assemble_masks_batched_pallas(
            jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(boxes)))
        pallas0 = np.asarray(assemble_masks_pallas(
            jnp.asarray(proto[0]), jnp.asarray(coeffs[0]),
            jnp.asarray(boxes[0])))
    xla = np.stack([np.asarray(assemble_masks_xla(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(b)))
        for p, c, b in zip(proto, coeffs, boxes)])
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], pallas0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    # the crop is exact: the same pixels are zero on both sides
    np.testing.assert_array_equal(got == 0, xla == 0)


@pytest.mark.parametrize('d,hp,wp,md', [(37, 16, 12, 40), (1, 16, 12, 8),
                                         (5, 69, 69, 8)],
                         ids=['md40', 'd1', '69x69'])
def test_plain_mask_assembly_matches_pallas_and_xla_shapes(rng, d, hp, wp,
                                                           md):
    """Md beyond a multiple of 32, a single detection, and an odd 69 x 69
    grid (Hp * Wp % 4 != 0, the kernel's 4-byte store path)."""
    proto, coeffs, boxes = _mask_inputs(rng, 2, hp, wp, md, max(d, 4))
    coeffs, boxes = coeffs[:, :d], boxes[:, :d]
    got = mask_assembly.assemble_masks_plain(
        torch.from_numpy(proto), torch.from_numpy(coeffs),
        torch.from_numpy(boxes)).numpy()
    assert got.shape == (2, d, hp, wp)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(assemble_masks_batched_pallas(
            jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(boxes)))
    xla = np.stack([np.asarray(assemble_masks_xla(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(b)))
        for p, c, b in zip(proto, coeffs, boxes)])
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got == 0, pallas == 0)
    np.testing.assert_array_equal(got == 0, xla == 0)


def _greater(ia, ua, ib, ub):
    """csrc/fast_nms_iou.cu:greater on arrays: ia / ua > ib / ub exactly,
    by float32 cross products; on equal products by their exact rounding
    errors (float64 holds a float32 product exactly, so this is fmaf's
    error) where the product is in [2^-100, FLT_MAX], else by float32
    quotients."""
    p1, p2 = ia * ub, ib * ua
    e1 = ia.astype(np.float64) * ub - p1
    e2 = ib.astype(np.float64) * ua - p2
    exact = (p1 >= np.float32(2.0 ** -100)) & (p1 <= np.finfo(np.float32).max)
    tie = np.where(exact, e1 > e2, ia / ua > ib / ub)
    return (p1 > p2) | ((p1 == p2) & tie)


def _iou_max_by_fractions(boxes, plan):
    """The kernel's per-column rule in numpy, following `plan`
    (nms.iou_plan): per split of the columns and per warp's chunk of rows,
    the best pair kept as a float32 fraction (inter, union) of the pairs
    with ix > 0, iy > 0 and union > 0; the warps' fractions merged per
    column by the same rule; one float32 divide per column."""
    n, k, _ = boxes.shape
    splits, cols, rows = plan
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    out = np.empty((n, k), np.float32)
    with np.errstate(all='ignore'):
        for s in range(splits):
            jlo, jhi = cols[s], cols[s + 1]
            j = np.arange(jlo, jhi)
            bj, aj = boxes[:, jlo:jhi], area[:, jlo:jhi]
            parts = []
            for w in range(nms.WARPS):
                bi = np.zeros((n, jhi - jlo), np.float32)
                bu = np.ones((n, jhi - jlo), np.float32)
                for i in range(rows[s][w], min(rows[s][w + 1], jhi)):
                    b = boxes[:, i:i + 1]
                    ix = (np.fmin(b[..., 2], bj[..., 2])
                          - np.fmax(b[..., 0], bj[..., 0]))
                    iy = (np.fmin(b[..., 3], bj[..., 3])
                          - np.fmax(b[..., 1], bj[..., 1]))
                    inter = ix * iy
                    uni = (area[:, i:i + 1] + aj) - inter
                    take = ((i < j) & (ix > 0) & (iy > 0) & (uni > 0)
                            & _greater(inter, uni, bi, bu))
                    bi, bu = np.where(take, inter, bi), np.where(take, uni, bu)
                parts.append((bi, bu))
            bi, bu = parts[0]
            for ci, cu in parts[1:]:
                take = (ci > 0) & _greater(ci, cu, bi, bu)
                bi, bu = np.where(take, ci, bi), np.where(take, cu, bu)
            out[:, jlo:jhi] = bi / bu
    return out


def _adversarial_iou_rows(rng, case):
    if case == 'near_ties':                   # three column splits at K=200
        return near_tie_boxes(12, 200)
    if case == 'identical':
        return np.broadcast_to(np.float32([0.1, 0.2, 0.4, 0.7]),
                               (4, 40, 4)).copy()
    if case == 'nonfinite':
        return _with_nonfinite(_iou_inputs(rng, 3, 16))
    if case == 'b1':
        return _iou_inputs(rng, 80, 200)
    scale = {'tiny': 1e-18, 'huge': 1e17}[case]   # products under / overflow
    return (_iou_inputs(rng, 4, 30) * np.float32(scale)).astype(np.float32)


@pytest.mark.parametrize('case', ['near_ties', 'identical', 'nonfinite', 'b1',
                                  'tiny', 'huge'])
def test_iou_max_fraction_rule_is_bit_equal_to_plain(rng, case):
    """The kernel's divide-free rule (error-free cross products, float64
    standing in for fmaf's exact error, then one float32 divide per
    column) gives the plain version's bits on adversarial rows."""
    boxes = _adversarial_iou_rows(rng, case)
    n, k, _ = boxes.shape
    plan = nms.iou_plan(n, k, 132)
    got = _iou_max_by_fractions(boxes, plan)
    want = nms.nms_iou_max_plain(torch.from_numpy(boxes)).numpy()
    assert np.array_equal(got, want)
    if case == 'near_ties':
        assert plan[0] == 3 and (want[:, -1] > 0).all()


@pytest.mark.parametrize('n,k', [(640, 200), (80, 200), (3, 1), (2, 1100),
                                 (6, 37)])
def test_iou_plan_partitions_and_balances_the_triangle(n, k):
    splits, cols, rows = nms.iou_plan(n, k, 132)
    assert 1 <= splits <= nms.MAX_SPLITS and len(rows) == splits
    assert cols[0] == 0 and cols[-1] == k and list(cols) == sorted(cols)
    if n < 132 and k >= 128:
        assert n * splits >= 132 or splits == nms.MAX_SPLITS
    for (jlo, jhi), bounds in zip(zip(cols, cols[1:]), rows):
        assert len(bounds) == nms.WARPS + 1
        assert bounds[0] == 0 and bounds[-1] == jhi
        assert list(bounds) == sorted(bounds)
        its = [nms.warp_iterations(a, b, jlo, jhi)
               for a, b in zip(bounds, bounds[1:])]
        pairs = sum(max(0, jhi - max(jlo, i + 1)) for i in range(jhi))
        # every pair is run by one lane; no warp runs over a third more
        # than the mean, nor 32 iterations more than it
        assert 32 * sum(its) >= pairs
        assert max(its) <= sum(its) / nms.WARPS * 4 / 3 + 32


def test_plain_iou_max_matches_pallas_and_xla(rng):
    boxes = _iou_inputs(rng, 6, 37)
    got = nms.nms_iou_max_plain(torch.from_numpy(boxes)).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(nms_iou_max_pallas(jnp.asarray(boxes)))
    jb = jnp.asarray(boxes)
    xla = np.asarray(_triu_max(jax_jaccard(jb, jb)))
    assert got.shape == (6, 37)
    assert (got[:, 1] == 1.0).all() and (got[:, 0] == 0.0).all()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)


def test_plain_iou_max_nonfinite_boxes_match_xla(rng):
    """Infinite and NaN coordinates: the guarded IoU maps every NaN
    union to IoU 0, so nothing NaN reaches the max, as in JAX."""
    boxes = _with_nonfinite(_iou_inputs(rng, 3, 16))
    got = nms.nms_iou_max_plain(torch.from_numpy(boxes)).numpy()
    jb = jnp.asarray(boxes)
    want = np.asarray(_triu_max(jax_jaccard(jb, jb)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_wrappers_take_plain_version_on_cpu(rng):
    proto, coeffs, boxes = _mask_inputs(rng, 1, 8, 8, 4, 5)
    n0, m0 = nms.launches, mask_assembly.launches
    t = [torch.from_numpy(a) for a in (proto, coeffs, boxes)]
    assert torch.equal(mask_assembly.assemble_masks(*t),
                       mask_assembly.assemble_masks_plain(*t))
    b = torch.from_numpy(_iou_inputs(rng, 2, 9))
    assert torch.equal(nms.nms_iou_max(b), nms.nms_iou_max_plain(b))
    assert (nms.launches, mask_assembly.launches) == (n0, m0)


def test_build_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; this checks the no-GPU error')
    with pytest.raises(RuntimeError, match='CUDA device'):
        _build.load()


def test_build_key_follows_source_content(tmp_path):
    src = tmp_path / 'k.cu'
    src.write_text('__global__ void k() {}\n')
    before = _build._digest([str(src)])
    assert _build._digest([str(src)]) == before
    src.write_text('__global__ void k() { }\n')
    assert _build._digest([str(src)]) != before


def test_wrappers_without_a_gradient_raise_under_grad_mode(rng):
    """Mask assembly and the IoU max have no gradient (the JAX kernels have
    none): under grad mode an input that requires grad raises instead of
    coming back detached; the check sits before the device branch.  Under
    no_grad, or on detached inputs, they run."""
    proto = torch.rand(1, 8, 8, 4)
    coeffs = torch.randn(1, 3, 4, requires_grad=True)
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7]] * 3])
    with pytest.raises(RuntimeError, match='no gradient'):
        mask_assembly.assemble_masks(proto, coeffs, boxes)
    with pytest.raises(RuntimeError, match='no gradient'):
        nms.nms_iou_max(boxes.clone().requires_grad_())
    with torch.no_grad():
        out = mask_assembly.assemble_masks(proto, coeffs, boxes)
        nms.nms_iou_max(boxes.clone().requires_grad_())
    assert not out.requires_grad
    assert torch.equal(out, mask_assembly.assemble_masks(
        proto, coeffs.detach(), boxes))


def test_differentiable_wrappers_carry_gradients_on_cpu():
    """The stem and DCN wrappers never return a detached result: on the CPU
    autograd runs through their plain versions."""
    from yolact_tpu_torch.kernels import dcn, stem
    x = torch.randn(1, 12, 5, 6)
    w2 = torch.randn(64, 12, 4, 4, requires_grad=True)
    assert stem.stem_conv_s2d(x, w2).requires_grad
    xs = torch.randn(1, 3, 5, 5, requires_grad=True)
    offset = torch.zeros(1, 18, 5, 5, requires_grad=True)
    mask = torch.rand(1, 9, 5, 5, requires_grad=True)
    cols = dcn.dcn_columns(xs, offset, mask)
    cols.sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (xs, offset, mask))


def test_needs_grad_is_what_autograd_would_record():
    """The stem and DCN wrappers launch their kernels directly unless a
    graph is being recorded: grad mode on and an input that requires grad."""
    from yolact_tpu_torch.kernels import _build
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert _build.needs_grad(a, b) and not _build.needs_grad(a, b.detach())
    with torch.no_grad():
        assert not _build.needs_grad(a, b)
    with torch.inference_mode():
        assert not _build.needs_grad(a, b)
