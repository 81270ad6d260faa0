"""The numerics of the stem kernel's float32 branch (csrc/stem_s2d.cu), on
the CPU: a numpy model of its split-TF32 product, and the stem wrapper's
CPU path.

The kernel multiplies on the tensor cores in TF32 (10 explicit mantissa
bits): each input v is split into hi = cvt.rna.tf32(v) (round to nearest,
ties away from zero) and lo = cvt.rna.tf32(v - hi), and the float32 sum
takes hi*hi + hi*lo + lo*hi over the K = 192 taps (k = c * 16 + i * 4 +
j).  Products of two TF32 values are exact in float32, so the model sums
exact products in float32 in k order.  Against a float64 conv the split
must stay within chip_smoke.py's criterion for the kernel, 1e-5 of the
largest output; one TF32 pass (hi*hi alone) must fall outside it, which
shows that the criterion can tell the two apart.  Inputs: the s2d input of
seeded normalized frames (models/layers.py:s2d_input), and values
1 + k * 2^-15 whose low bits only the lo halves carry; weights: the stem's
7x7 kernel rearranged by models/layers.py:s2d_stem_kernel.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolact_tpu_torch.kernels import stem
from yolact_tpu_torch.models.layers import s2d_input, s2d_stem_kernel

torch.set_num_threads(2)

CRITERION = 1e-5            # chip_smoke.py KERNELS['stem_s2d']['tol']


def tf32_rna(a):
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as cvt.rna.tf32.f32 rounds finite values: add half of
    the 13 dropped bits to the magnitude, then clear them."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def im2col(x):
    """x [1, 12, H, W] -> [H, W, 192]: the taps of the 4x4 conv with padding
    (2, 1), column k = c * 16 + i * 4 + j."""
    _, c, h, w = x.shape
    xp = np.pad(x[0], ((0, 0), (2, 1), (2, 1)))
    return np.stack([xp[ci, i:i + h, j:j + w] for ci in range(c)
                     for i in range(4) for j in range(4)], -1)


def tf32_sum(cols, w, pairs):
    """float32 sum over k, in k order, of the exact products of `pairs`
    ((a part, b part), ...) taken in the given order at each k."""
    acc = np.zeros(cols.shape[:2] + (w.shape[0],), np.float32)
    parts = [(split(cols)[ia], split(w)[ib]) for ia, ib in pairs]
    for k in range(cols.shape[-1]):
        for a, b in parts:
            acc = acc + a[..., k:k + 1] * b[None, None, :, k]
    return acc


def stem_inputs(kind, seed, h=14, w=17):
    rng = np.random.RandomState(seed)
    w7 = (rng.randn(64, 3, 7, 7) * np.sqrt(2 / 147)).astype(np.float32)
    w2 = s2d_stem_kernel(torch.from_numpy(w7)).numpy().reshape(64, 192)
    if kind == 'frames':
        frames = rng.randn(1, 3, 2 * h, 2 * w).astype(np.float32)
        x = s2d_input(torch.from_numpy(frames)).numpy()
    else:
        x = (1 + rng.randint(0, 1 << 12, (1, 12, h, w)) * 2.0 ** -15)\
            .astype(np.float32)
    return x, w2


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)                 # one TF32 ulp at 1
    below = np.float32(1 + 2.0 ** -11 - 2.0 ** -23)
    cases = {1 + 2.0 ** -11: one + ulp,           # a tie: away from zero
             -(1 + 2.0 ** -11): -(one + ulp),
             float(below): one,                   # below the tie
             1 + 3 * 2.0 ** -11: one + 2 * ulp,   # a tie, away from zero
             0.0: 0.0}
    for v, want in cases.items():
        assert tf32_rna(np.float32(v)) == np.float32(want), v
    v = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi = tf32_rna(v)
    assert not np.any(hi.view(np.uint32) & np.uint32(0x1FFF))
    assert np.all(np.abs(hi - v) <= np.abs(v) * 2.0 ** -11)


@pytest.mark.parametrize('kind,seed', [('frames', 0), ('frames', 1),
                                       ('wide', 2)])
def test_split_tf32_model_meets_the_criterion(kind, seed):
    x, w2 = stem_inputs(kind, seed)
    cols = im2col(x)
    exact = cols.astype(np.float64) @ w2.T.astype(np.float64)
    top = np.abs(exact).max()
    # the kernel's order at each k: lo*hi, hi*lo, hi*hi
    three = tf32_sum(cols, w2, [(1, 0), (0, 1), (0, 0)])
    one = tf32_sum(cols, w2, [(0, 0)])
    assert np.abs(three - exact).max() <= CRITERION * top
    assert np.abs(one - exact).max() > CRITERION * top


@pytest.mark.parametrize('kind,seed', [('frames', 3), ('wide', 4)])
def test_split_tf32_model_matches_the_plain_stem(kind, seed):
    """The model against the port's plain version (the float32 conv that
    chip_smoke.py holds the kernel to), output layout [64, H, W]."""
    x, w2 = stem_inputs(kind, seed)
    want = stem.stem_conv_s2d_plain(
        torch.from_numpy(x), torch.from_numpy(w2.reshape(64, 12, 4, 4)))
    got = tf32_sum(im2col(x), w2, [(1, 0), (0, 1), (0, 0)])
    top = float(want.abs().max())
    np.testing.assert_allclose(got.transpose(2, 0, 1), want[0].numpy(),
                               rtol=0, atol=CRITERION * top)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_stem_wrapper_cpu_path_is_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, 9, 11, generator=gen).to(dtype)
    w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dtype)
    n0 = stem.launches
    got = stem.stem_conv_s2d(x, w2)
    assert stem.launches == n0
    assert torch.equal(got, stem.stem_conv_s2d_plain(x, w2))
    assert torch.equal(got.float(), F.conv2d(F.pad(x.float(), (2, 1, 2, 1)),
                                             w2.float()).to(dtype).float())
