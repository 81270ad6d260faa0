"""The port's deformable PSRoI pooling (yolact_tpu_torch/kernels/psroi.py)
against the JAX package's (yolact_tpu/kernels/psroi.py), in float32 on the
CPU: the same seeded inputs (``tests/test_psroi.py:_random_case``) through
both.  Tolerance 1e-5: the two gather and sum the same float32 taps, in
orders that XLA and PyTorch choose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_psroi import _random_case
from yolact_tpu.kernels.psroi import DeformRoIPooling as JaxDeformRoIPooling
from yolact_tpu.kernels.psroi import deform_psroi_pool as jax_pool
from yolact_tpu_torch.convert.from_jax import psroi_variables_to_state_dict
from yolact_tpu_torch.kernels import DeformRoIPooling, deform_psroi_pool

ATOL = 1e-5


def _case(rng, no_trans, G, P=3, output_dim=4, num_classes=None, **kw):
    if num_classes is None:
        num_classes = 1 if no_trans else 2
    x, rois, trans = _random_case(rng, output_dim=output_dim, G=G, P=P,
                                  num_classes=num_classes, **kw)
    return (x.astype(np.float32), rois.astype(np.float32),
            trans.astype(np.float32))


def _both(x, rois, trans, **kw):
    want = jax_pool(jnp.asarray(x), jnp.asarray(rois),
                    None if trans is None else jnp.asarray(trans), **kw)
    got = deform_psroi_pool(torch.from_numpy(x), torch.from_numpy(rois),
                            None if trans is None else torch.from_numpy(trans),
                            **kw)
    return np.asarray(want), got


# test_psroi.py's grid: no_trans x group size x trans_std
@pytest.mark.parametrize('no_trans,G,trans_std',
                         [(True, 1, 0.0), (False, 1, 0.1),
                          (False, 2, 0.2), (True, 3, 0.0)])
def test_psroi_matches_jax(rng, no_trans, G, trans_std):
    x, rois, trans = _case(rng, no_trans, G)
    kw = dict(spatial_scale=0.25, pooled_size=3, output_dim=4,
              no_trans=no_trans, group_size=G, sample_per_part=4,
              trans_std=trans_std)
    want, got = _both(x, rois, None if no_trans else trans, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize('part_size', [None, 2])
def test_psroi_gradients_match_jax(rng, part_size):
    """d/dx and d/dtrans of a seeded cotangent against jax.grad (the
    bilinear weights carry the coordinate gradient in both)."""
    x, rois, trans = _case(rng, False, 1, B=2, H=5, W=5, output_dim=3,
                           num_classes=1, N=4)
    if part_size is not None:
        trans = trans[:, :, :part_size, :part_size].copy()
    kw = dict(spatial_scale=0.25, pooled_size=3, output_dim=3,
              no_trans=False, group_size=1, part_size=part_size,
              sample_per_part=4, trans_std=0.3)
    cotan = rng.randn(4, 3, 3, 3).astype(np.float32)

    def f(xa, ta):
        return jnp.sum(jax_pool(xa, jnp.asarray(rois), ta, **kw)
                       * jnp.asarray(cotan))

    gx, gt = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(trans))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(trans).requires_grad_()
    (deform_psroi_pool(tx, torch.from_numpy(rois), tt, **kw)
     * torch.from_numpy(cotan)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=0,
                               atol=ATOL)
    assert np.abs(np.asarray(gt)).max() > 1e-3


def test_module_with_carried_weights_matches_jax(rng):
    """DeformRoIPooling with JAX's initialised weights carried over
    (convert/from_jax.psroi_variables_to_state_dict), the last FC seeded
    non-zero so that the deformable pass moves its taps and the mask is
    not 0.5 everywhere."""
    x, rois, _ = _case(rng, False, 1)
    kw = dict(spatial_scale=0.25, pooled_size=3, output_dim=4,
              no_trans=False, trans_std=0.1, deform_fc_dim=32)
    jmod = JaxDeformRoIPooling(**kw)
    variables = jax.tree_util.tree_map(np.array, dict(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(rois))))
    last = variables['params']['offset_mask_fc_4']
    last['kernel'] = (rng.randn(*last['kernel'].shape) * 0.3).astype(
        np.float32)
    last['bias'] = (rng.randn(*last['bias'].shape) * 0.5).astype(np.float32)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x),
                                 jnp.asarray(rois)))

    mod = DeformRoIPooling(**kw)
    mod.load_state_dict(psroi_variables_to_state_dict(variables))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(rois)).numpy()
        plain = 0.5 * deform_psroi_pool(
            torch.from_numpy(x), torch.from_numpy(rois), None,
            no_trans=True, spatial_scale=0.25, pooled_size=3,
            output_dim=4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got - plain).max() > 1e-2     # the deformable pass acts


def test_module_starts_as_half_plain_pooling(rng):
    """A fresh module (zero last FC: offset 0, mask sigmoid(0)) gives half
    of plain PSRoI pooling, as JAX's test_deform_roi_pooling_module; the
    no_trans module is plain pooling and has no FC."""
    x, rois, _ = _case(rng, False, 1)
    xt, rt = torch.from_numpy(x), torch.from_numpy(rois)
    kw = dict(spatial_scale=0.25, pooled_size=3, output_dim=4)
    plain = deform_psroi_pool(xt, rt, None, no_trans=True, **kw)
    with torch.no_grad():
        out = DeformRoIPooling(trans_std=0.1, deform_fc_dim=32, **kw)(xt, rt)
        bare = DeformRoIPooling(no_trans=True, **kw)
    torch.testing.assert_close(out, 0.5 * plain, rtol=0, atol=1e-6)
    assert not list(bare.parameters())
    torch.testing.assert_close(bare(xt, rt), plain, rtol=0, atol=0)


def test_bin_without_surviving_tap_is_zero():
    """A RoI wholly outside the map leaves every tap outside [-0.5,
    dim - 0.5]: each bin is 0 in both packages, and its gradient too."""
    x = np.ones((1, 6, 6, 4), np.float32)
    rois = np.array([[0, 100, 100, 120, 120],     # outside
                     [0, 2, 2, 14, 14]], np.float32)
    kw = dict(spatial_scale=0.25, pooled_size=2, output_dim=4,
              no_trans=True)
    want, got = _both(x, rois, None, **kw)
    np.testing.assert_array_equal(want[0], 0.0)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert float(got[1].min()) > 0.5
    xt = torch.from_numpy(x).requires_grad_()
    deform_psroi_pool(xt, torch.from_numpy(rois[:1]), None, **kw).sum() \
        .backward()
    assert torch.equal(xt.grad, torch.zeros_like(xt.grad))
