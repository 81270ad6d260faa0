"""The DCN backward kernel's geometry and the host-side diagnostics built
on it (kernels/dcn.py: col2im_geometry, col2im_corners,
col2im_reductions, col2im_vec), on the CPU.

csrc/dcn_col2im.cu cannot run here.  It plans its own launch from three
constants (kTile, kHalo, kCapSpare) and the call's shapes; the diagnostics
read the same constants from its source.  The tests hold the geometry to
the kernel's own formulas, the window to its purpose (every corner of an
offset within the halo inside it), and the corner classes (outside the map
/ in the window / global path) against brute-force loops and against the
pixels the plain version's scatter writes.  They also check that the
wrapper's CPU path is the plain version.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from test_torch_inputs import dcn_inputs
from yolact_tpu_torch.kernels import dcn

torch.set_num_threads(2)


def _geometry(tile, stride, halo=None, cap=None):
    """The kernel's geometry with another tile (and halo, cap): the window
    the kernel's formula gives them."""
    geo = dcn.col2im_geometry(3, stride)
    halo = geo.halo if halo is None else halo
    return dcn.Col2imGeometry(tile, halo, stride * (tile - 1) + 4 + 2 * halo,
                              geo.cap if cap is None else cap)


def test_geometry_is_the_kernel_source():
    """The constants come from csrc/dcn_col2im.cu, whose launch computes
    the window and the list capacity with the formulas col2im_geometry
    uses."""
    with open(dcn._COL2IM_SOURCE) as f:
        text = f.read()
    consts = {k: int(v) for k, v in re.findall(
        r'constexpr int (kTile|kHalo|kCapSpare) = (\d+);', text)}
    assert 'a.window = a.stride * (kTile - 1) + (a.k - 1) * a.dil + 2 + ' \
        '2 * kHalo;' in text
    assert 'return 4 * k * k / (stride * stride) + kCapSpare;' in text
    for k, stride, dil in itertools.product((1, 3, 5), (1, 2), (1, 2)):
        geo = dcn.col2im_geometry(k, stride, dil)
        assert geo.tile == consts['kTile'] and geo.halo == consts['kHalo']
        assert geo.window == (stride * (geo.tile - 1) + (k - 1) * dil + 2
                              + 2 * geo.halo)
        assert geo.cap == 4 * k * k // stride ** 2 + consts['kCapSpare']
    # the yolact_plus_base blocks (3x3, stride 1 and 2)
    assert dcn.col2im_geometry(3, 1) == (8, 4, 19, 48)
    assert dcn.col2im_geometry(3, 2) == (8, 4, 26, 21)


def test_geometry_needs_every_constant(tmp_path, monkeypatch):
    src = tmp_path / 'dcn_col2im.cu'
    src.write_text('constexpr int kTile = 8;\nconstexpr int kHalo = 4;\n')
    monkeypatch.setattr(dcn, '_COL2IM_SOURCE', str(src))
    dcn._col2im_constants.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='kCapSpare'):
            dcn.col2im_geometry()
    finally:
        monkeypatch.undo()
        dcn._col2im_constants.cache_clear()
    assert dcn.col2im_geometry().tile == 8


@pytest.mark.parametrize('stride', [1, 2])
def test_window_holds_every_corner_of_small_offsets(stride):
    """Offsets within +-halo keep all four corners of every sample of a
    tile inside its window (the forward's corners: floor and floor + 1)."""
    geo = dcn.col2im_geometry(3, stride)
    lo = -1 - geo.halo                      # window start - tile start
    for p, t in itertools.product(range(geo.tile), range(9)):
        base = p * stride - 1 + t // 3
        for off in (-geo.halo, -0.63 * geo.halo, 0, 0.37 * geo.halo,
                    geo.halo):
            y0 = int(np.floor(base + off))
            assert lo <= y0 and y0 + 1 <= lo + geo.window - 1, (p, t, off)
    # an offset one pixel beyond the halo leaves it (first pixel, first tap)
    assert int(np.floor(-1 - (geo.halo + 1))) < lo


def _brute_corners(offset, h, w, geo, stride=1, pad=1):
    """col2im_corners by loops over every sample and corner."""
    b, _, ho, wo = offset.shape
    out = np.zeros((b, ho, wo, 9, 4), np.int8)
    off = offset.numpy()
    for n, y, x, t in itertools.product(range(b), range(ho), range(wo),
                                        range(9)):
        ys = np.float32(y * stride - pad + t // 3) + off[n, 2 * t, y, x]
        xs = np.float32(x * stride - pad + t % 3) + off[n, 2 * t + 1, y, x]
        cy = 0 if np.isnan(ys) else int(np.clip(np.floor(ys), -2, h))
        cx = 0 if np.isnan(xs) else int(np.clip(np.floor(xs), -2, w))
        wy = (y // geo.tile) * geo.tile * stride - pad - geo.halo
        wx = (x // geo.tile) * geo.tile * stride - pad - geo.halo
        for q, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            yi, xi = cy + dy, cx + dx
            if not (0 <= yi < h and 0 <= xi < w):
                continue
            inside = (0 <= yi - wy < geo.window and 0 <= xi - wx < geo.window)
            out[n, y, x, t, q] = 1 if inside else 2
    return out


@pytest.mark.parametrize('stride,h,tile', [(1, 11, 4), (2, 13, 2), (1, 9, 8)])
def test_corners_match_brute_force(stride, h, tile):
    gen = torch.Generator().manual_seed(stride + h)
    x, offset, mask = dcn_inputs(gen, 'cpu', 2, 8, h, stride, torch.float32)
    ho = offset.shape[-1]
    geo = _geometry(tile, stride)
    got = dcn.col2im_corners(offset, h, h, 3, stride, 1, 1, geo)
    np.testing.assert_array_equal(got.numpy(),
                                  _brute_corners(offset, h, h, geo, stride))
    assert {0, 1, 2} <= set(np.unique(got.numpy()))


@pytest.mark.parametrize('stride', [1, 2])
def test_corners_are_the_plain_scatter_targets(stride):
    """The pixels some valid corner lands on are the pixels the plain
    version's grad_x can be non-zero at: with random g_cols and a mask
    bounded away from 0, exactly those (NaN-free offsets)."""
    gen = torch.Generator().manual_seed(10 + stride)
    h, cin = 15, 6
    x, offset, _ = dcn_inputs(gen, 'cpu', 2, cin, h, stride, torch.float32,
                              finite=True)
    ho = offset.shape[-1]
    offset = offset + torch.rand(offset.shape, generator=gen) * 0.5 + 0.25
    mask = torch.rand(2, 9, ho, ho, generator=gen) * 0.5 + 0.5
    g_cols = torch.randn(2 * ho * ho, 9 * cin, generator=gen)
    gx = dcn.dcn_col2im_plain(g_cols, x, offset, mask, 3, stride)[0]
    where = dcn.col2im_corners(offset, h, h, 3, stride)
    y0, x0 = dcn._top_left_corners(offset, h, h, 3, stride, 1, 1)
    reached = torch.zeros(2, h, h, dtype=torch.bool)
    for q, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        sel = where[..., q] > 0
        img = torch.arange(2)[:, None, None, None].expand_as(y0)
        reached[img[sel], (y0 + dy)[sel], (x0 + dx)[sel]] = True
    nonzero = (gx != 0).any(1)
    assert torch.equal(nonzero, reached)


def test_zero_and_small_offsets_take_no_global_path():
    for stride, h in ((1, 17), (2, 19)):
        ho = dcn.out_size(h, 3, stride, 1, 1)
        for scale in (0.0, dcn.col2im_geometry(3, stride).halo - 0.01):
            offset = (torch.rand(2, 18, ho, ho,
                                 generator=torch.Generator().manual_seed(1))
                      * 2 - 1) * scale
            where = dcn.col2im_corners(offset, h, h, 3, stride)
            assert not bool((where == 2).any())
            r = dcn.col2im_reductions(offset, 16, h, h, 3, stride)
            assert r['fallback'] == 0 and r['fallback_share'] == 0.0


def test_reductions_count_by_brute_force():
    gen = torch.Generator().manual_seed(3)
    h, c, stride = 12, 20, 1
    _, offset, _ = dcn_inputs(gen, 'cpu', 2, c, h, stride, torch.float32)
    ho = offset.shape[-1]
    geo = _geometry(4, stride, cap=3)
    where = _brute_corners(offset, h, h, geo, stride)
    off = offset.numpy()
    touched, global_path = {}, int((where == 2).sum())
    for n, y, x, t, q in zip(*np.nonzero(where == 1)):
        ys = np.float32(y * stride - 1 + t // 3) + off[n, 2 * t, y, x]
        xs = np.float32(x * stride - 1 + t % 3) + off[n, 2 * t + 1, y, x]
        cy = 0 if np.isnan(ys) else int(np.clip(np.floor(ys), -2, h))
        cx = 0 if np.isnan(xs) else int(np.clip(np.floor(xs), -2, h))
        key = (n, y // 4, x // 4, cy + q // 2, cx + q % 2)
        touched[key] = touched.get(key, 0) + 1
    global_path += sum(max(0, v - geo.cap) for v in touched.values())
    valid = int((where > 0).sum())
    for vec in (True, False):
        got = dcn.col2im_reductions(offset, c, h, h, 3, stride, 1, 1, vec,
                                    geo)
        assert got == dict(scalar=valid * c, window_v4=len(touched) * 5,
                           fallback=global_path * (5 if vec else c),
                           fallback_share=global_path / valid)


def test_vector_rule():
    """16-byte accesses only for C a multiple of the vector and aligned
    pointers; everything else goes element by element."""
    base = torch.zeros(64)
    assert dcn.col2im_vec(8, 4, base) and dcn.col2im_vec(8, 2, base)
    assert not dcn.col2im_vec(6, 4, base)
    assert dcn.col2im_vec(60, 4, base) and not dcn.col2im_vec(60, 2, base)
    assert not dcn.col2im_vec(8, 4, base[1:])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_col2im_wrapper_cpu_path_is_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(6)
    x, offset, mask = dcn_inputs(gen, 'cpu', 2, 12, 9, 1, dtype)
    ho = offset.shape[-1]
    g_cols = torch.randn(2 * ho * ho, 9 * 12, generator=gen).to(dtype)
    n0 = dcn.col2im_launches
    got = dcn.dcn_col2im(g_cols, x, offset, mask)
    want = dcn.dcn_col2im_plain(g_cols, x, offset, mask)
    assert dcn.col2im_launches == n0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
        assert torch.equal(g.isnan(), w.isnan())
