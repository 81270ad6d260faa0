"""The port's DCNv2 (yolact_tpu_torch.kernels.dcn) against the JAX package's
(yolact_tpu/kernels/dcn.py) on the CPU, in float32, on seeded numpy inputs.

The JAX sampler is the production XLA gather that the TPU package's four
Pallas probes (scripts/bench_gather2.py, scripts/probe_sameshape_gather.py)
stand for; those probes live inside script main()s and cannot be imported.
The CUDA kernel is held against the plain version in test_torch_cuda.py.

Tolerances: the sampler 1e-6 in float32 (the same float32 operations; XLA
may pair the four corner products differently) and bit-equal in bfloat16
(rounded at the same points), the convolution 1e-5 (a Cin*K*K-term float32
GEMM summed in another order by XLA and by PyTorch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolact_tpu.kernels import dcn as jax_dcn
from yolact_tpu_torch.kernels import _build, dcn

torch.set_num_threads(2)


def _offsets(rng, kind, shape, h, w):
    if kind == 'zero':
        return np.zeros(shape, np.float32)
    if kind == 'integer':
        return rng.randint(-3, 4, shape).astype(np.float32)
    if kind == 'fractional':
        return (rng.randn(*shape) * 1.5).astype(np.float32)
    # far out of bounds mixed with small and near-edge offsets
    return (rng.randn(*shape) * rng.choice([0.3, 2.0, 3.0 * max(h, w)],
                                           size=shape)).astype(np.float32)


def _case(rng, kind, stride, padding, dilation, b=2, cin=5, cout=4, h=9,
          w=11, k=3):
    ho = dcn.out_size(h, k, stride, padding, dilation)
    wo = dcn.out_size(w, k, stride, padding, dilation)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offset = _offsets(rng, kind, (b, ho, wo, 2 * k * k), h, w)
    mask = rng.rand(b, ho, wo, k * k).astype(np.float32)
    weight = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, offset, mask, weight, bias


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('kind', ['zero', 'integer', 'fractional', 'far_oob'])
@pytest.mark.parametrize('stride,padding,dilation',
                         [(1, 1, 1), (2, 1, 1), (1, 2, 2)],
                         ids=['plain', 'stride2', 'atrous'])
def test_deform_conv2d_plain_matches_jax(rng, stride, padding, dilation,
                                         kind):
    x, offset, mask, weight, bias = _case(rng, kind, stride, padding,
                                          dilation)
    want = np.asarray(jax_dcn.deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(weight), jnp.asarray(bias), stride=stride,
        padding=padding, dilation=dilation))
    got = dcn.deform_conv2d_plain(
        _nchw(x), _nchw(offset), _nchw(mask),
        torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias), stride, padding, dilation)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def _coords(rng, b, n, h, w):
    """Sample coordinates on and off the grid: negative ones (where floor
    must round down), ones just past each edge and far outside."""
    ys = rng.uniform(-3, h + 2, (b, n))
    xs = rng.uniform(-3, w + 2, (b, n))
    ys[:, :8] = [-0.5, -1.0, -1.5, -1e-3, h - 1, h - 0.5, 3.0, 40.0]
    xs[:, :8] = [2.25, -0.75, w - 0.5, w + 30.0, -2.0, 0.0, -1e-3, 1.5]
    return ys.astype(np.float32), xs.astype(np.float32)


@pytest.mark.parametrize('jax_sampler', ['_bilinear_gather_block',
                                         '_bilinear_gather_rows'])
def test_bilinear_sample_plain_matches_jax_samplers(rng, jax_sampler):
    b, h, w, c, n = 2, 7, 9, 6, 300
    x = rng.randn(b, h, w, c).astype(np.float32)
    ys, xs = _coords(rng, b, n, h, w)
    want = np.asarray(getattr(jax_dcn, jax_sampler)(
        jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs)))      # [B, N, C]
    got = dcn.bilinear_sample_plain(torch.from_numpy(x), torch.from_numpy(ys),
                                    torch.from_numpy(xs))       # [B, N, C]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a sample fully outside the map is exactly 0
    assert (got[:, 7] == 0).all() and (got[:, 3] == 0).all()


def test_bilinear_sample_plain_bf16_matches_jax_block_sampler(rng):
    """In bfloat16 each corner product rounds to bf16 and their sum is
    taken in float32 and rounded once, as jnp.sum does in the production
    sampler: the samples are bit-equal."""
    b, h, w, c, n = 2, 7, 9, 16, 600
    scale = 10.0 ** rng.uniform(-2, 2, c)        # per-channel magnitudes
    x = (rng.randn(b, h, w, c) * scale).astype(np.float32)
    ys, xs = _coords(rng, b, n, h, w)
    want = jax_dcn._bilinear_gather_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ys), jnp.asarray(xs))
    got = dcn.bilinear_sample_plain(torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(ys), torch.from_numpy(xs))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_nonfinite_offsets_match_jax(rng):
    """A NaN coordinate gives NaN samples on both sides (XLA converts its
    floor to 0, so its corners lie in the map with NaN weights); an
    infinite one gives 0 (every corner is outside); the rest agree."""
    b, h, w, c, n = 1, 6, 6, 3, 40
    x = rng.randn(b, h, w, c).astype(np.float32)
    ys, xs = _coords(rng, b, n, h, w)
    ys[0, 10:16] = [np.nan, np.inf, -np.inf, 2.5, 2.5, 2.5]
    xs[0, 10:16] = [2.5, 2.5, 2.5, np.inf, np.nan, -np.inf]
    want = np.asarray(jax_dcn._bilinear_gather_rows(
        jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs)))
    got = dcn.bilinear_sample_plain(torch.from_numpy(x), torch.from_numpy(ys),
                                    torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, [10, 14]]).all()
    assert (got[0, [11, 12, 13, 15]] == 0).all()
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-6)


def test_zero_offsets_are_a_half_conv(rng):
    """Offsets 0 and mask 0.5, the YOLACT++ init: half a plain conv."""
    x = torch.from_numpy(rng.randn(2, 4, 9, 8).astype(np.float32))
    weight = torch.from_numpy((rng.randn(6, 4, 3, 3) * 0.2).astype(np.float32))
    bias = torch.from_numpy(rng.randn(6).astype(np.float32))
    offset = torch.zeros(2, 18, 5, 4)
    mask = torch.full((2, 9, 5, 4), 0.5)
    got = dcn.deform_conv2d(x, offset, mask, weight, bias, stride=2)
    want = 0.5 * F.conv2d(x, weight, stride=2, padding=1) + bias[:, None, None]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_columns_layout_and_bf16(rng):
    """Row b*Ho*Wo + p, column t*Cin + c holds channel c at tap t of pixel
    p (JAX's layout); in bfloat16 the plain version rounds where the kernel
    does and stays within bf16 of f32."""
    x_hwc, offset, mask, _, _ = _case(rng, 'fractional', 1, 1, 1, b=1, cin=3)
    x, offset, mask = _nchw(x_hwc), _nchw(offset), _nchw(mask)
    cols = dcn.dcn_columns_plain(x, offset, mask)
    assert cols.shape == (9 * 11, 9 * 3)
    ys = (torch.arange(9.0)[:, None] - 1 + 1 + offset[0, 8]).reshape(1, -1)
    xs = (torch.arange(11.0)[None, :] - 1 + 1 + offset[0, 9]).reshape(1, -1)
    centre = dcn.bilinear_sample_plain(torch.from_numpy(x_hwc), ys, xs)[0] \
        * mask[0, 4].reshape(-1, 1)
    assert torch.equal(cols[:, 4 * 3:5 * 3], centre)          # tap t = 4
    # a channels_last x is read as it lies and gives the same columns
    assert torch.equal(dcn.dcn_columns_plain(
        x.contiguous(memory_format=torch.channels_last), offset, mask), cols)
    low = dcn.dcn_columns_plain(x.bfloat16(), offset, mask)
    assert low.dtype == torch.bfloat16
    torch.testing.assert_close(low.float(), cols, rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('stride,dilation', [(1, 1), (2, 1), (1, 2)])
def test_columns_match_jax_sampler_times_mask(rng, dtype, stride, dilation):
    """The columns in JAX's own layout: deform_conv2d's sampler output
    (taken through its gather_impl hook) times the mask, as the
    [B*Ho*Wo, K*K*Cin] matrix its dot_general reads.  Bit-equal in
    bfloat16 (the same roundings); within 1e-6 in float32 (XLA may pair
    the four corner products differently)."""
    x, offset, mask, weight, _ = _case(rng, 'fractional', stride, dilation,
                                       dilation, cin=8)
    jdt = jnp.dtype(dtype)
    seen = []

    def sampler(xj, ys, xs):
        seen.append(jax_dcn._bilinear_gather_block(xj, ys, xs))
        return seen[-1]

    jax_dcn.deform_conv2d(jnp.asarray(x, jdt), jnp.asarray(offset),
                          jnp.asarray(mask), jnp.asarray(weight, jdt),
                          stride=stride, padding=dilation, dilation=dilation,
                          gather_impl=sampler)
    b, ho, wo, kk = mask.shape
    want = (seen[0].reshape(b, ho * wo, kk, -1)
            * jnp.asarray(mask, jdt).reshape(b, ho * wo, kk, 1))
    want = np.asarray(want.reshape(b * ho * wo, -1).astype(jnp.float32))
    got = dcn.dcn_columns(_nchw(x).to(getattr(torch, dtype)), _nchw(offset),
                          _nchw(mask), 3, stride, dilation, dilation)
    assert got.shape == want.shape == (b * ho * wo, kk * 8)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0 if dtype == 'bfloat16' else 1e-6)


def test_wrappers_take_plain_version_on_cpu(rng):
    x, offset, mask, weight, bias = _case(rng, 'far_oob', 2, 1, 1)
    args = (_nchw(x), _nchw(offset), _nchw(mask))
    w = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy())
    n0 = dcn.launches
    assert torch.equal(dcn.dcn_columns(*args, 3, 2),
                       dcn.dcn_columns_plain(*args, 3, 2))
    assert torch.equal(dcn.deform_conv2d(*args, w, torch.from_numpy(bias), 2),
                       dcn.deform_conv2d_plain(*args, w,
                                               torch.from_numpy(bias), 2))
    assert dcn.launches == n0
    assert _build.SIGNATURES['yolact_dcn_im2col'][0] is _build._P
    assert len(_build.SIGNATURES['yolact_dcn_im2col']) == 16


@pytest.mark.parametrize('bad', ['x_half', 'offset_bf16', 'offset_shape',
                                 'mask_shape', 'x_noncontiguous', 'x_3d'])
def test_columns_reject_bad_inputs(bad):
    x = torch.zeros(1, 4, 6, 6)
    offset = torch.zeros(1, 18, 6, 6)
    mask = torch.zeros(1, 9, 6, 6)
    if bad == 'x_half':
        x = x.half()
    elif bad == 'offset_bf16':
        offset = offset.bfloat16()
    elif bad == 'offset_shape':
        offset = torch.zeros(1, 18, 5, 6)
    elif bad == 'mask_shape':
        mask = torch.zeros(1, 8, 6, 6)
    elif bad == 'x_noncontiguous':      # neither NCHW nor channels_last
        x = torch.zeros(1, 4, 6, 12)[..., ::2]
    else:
        x = x[0]
    with pytest.raises(ValueError, match='dcn'):
        dcn.dcn_columns(x, offset, mask)
