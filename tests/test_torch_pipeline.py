"""The port's end-to-end inference (yolact_tpu_torch.infer) against the JAX
package's, on the tiny ResNet config, in float32 on the CPU.

The same seeded weights (JAX init, carried over by
convert.from_jax.jax_variables_to_state_dict) and the same seeded frames
go through both, each package with its own config (``P`` =
``config_from_jax``).  Tolerances: classes and validity identical, scores and
boxes within 1e-5, masks within 1e-4 (float32 convolutions summed in
another order by XLA and by PyTorch)."""

import ast
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import seed_offsets_jax
from yolact_tpu import config as C
from yolact_tpu.detect.detection import Detections as JaxDetections
from yolact_tpu.detect.detection import detect as jax_detect
from yolact_tpu.detect.postprocess import \
    postprocess_device as jax_postprocess_device
from yolact_tpu.infer import Pipeline as JaxPipeline
from yolact_tpu.infer import forward_and_detect as jax_forward_and_detect
from yolact_tpu.infer import random_variables
from yolact_tpu.models.yolact import MaskIoUHead
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.detect import detection as torch_detection
from yolact_tpu_torch.detect.postprocess import postprocess_device
from yolact_tpu_torch.infer import (Pipeline, forward_and_detect, load_model,
                                    random_state_dict)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sparsify_conf(variables, num_classes):
    """Bias the conf head toward background, as bench.py:_sparsify_conf
    does at full size, so that ~100-150 of the 1023 tiny priors pass
    conf_thresh (the tiny head's logits are within +-0.3; bench.py's
    +-8 would leave none)."""
    head = variables['params']['prediction_layers_0']['conf_layer']['conv']
    b = np.array(head['bias']).reshape(-1, num_classes)
    b[:, 0] += 3.0
    head['bias'] = b.reshape(-1)
    return variables


def _variables(cfg, sparse):
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=3))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    return _sparsify_conf(v, cfg.num_classes) if sparse else v


def _frames(cfg, batch=2):
    rng = np.random.RandomState(7)
    return rng.randint(0, 256, (batch, cfg.max_size, cfg.max_size, 3)
                       ).astype(np.float32)


def _plain_stem(cfg, sd, frames, **kw):
    """The port's forward_and_detect with the stem the config names (the
    Pipeline takes the s2d stem for raw frames), float32 on the CPU."""
    model = load_model(cfg, sd, torch.device('cpu'), 'float32')
    with torch.inference_mode():
        return forward_and_detect(cfg, model, torch.from_numpy(frames), **kw)


def _assert_outputs_match(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out.valid),
                                  torch_out.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jax_out.classes),
                                  torch_out.classes.numpy())
    np.testing.assert_allclose(torch_out.scores.numpy(),
                               np.asarray(jax_out.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch_out.boxes.numpy(),
                               np.asarray(jax_out.boxes), rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch_out.masks.numpy(),
                               np.asarray(jax_out.masks), rtol=0, atol=1e-4)


# nms_candidates=256 < 1023 priors so the prune applies: sparse conf biases
# leave ~150 candidates (pruned tail), dense random ones leave all of them
# (the exact unpruned fallback)
@pytest.mark.parametrize('sparse,branch', [(True, 'pruned'),
                                           (False, 'full')])
@pytest.mark.parametrize('stem_s2d', [False, True])
def test_forward_and_detect_matches_jax(sparse, branch, stem_s2d):
    cfg = tiny_resnet_config(nms_candidates=256)
    variables = _variables(cfg, sparse)
    frames = _frames(cfg)
    sd = jax_variables_to_state_dict(P(cfg), variables)
    before = dict(torch_detection.branch_counts)
    if stem_s2d:
        # both Pipelines' default: the space-to-depth stem
        want = JaxPipeline(cfg, variables)(frames)
        got = Pipeline(P(cfg), sd, 'cpu')(frames)
    else:
        want = jax.jit(lambda v, x: jax_forward_and_detect(
            cfg, JaxYolact(cfg), v, x))(variables, jnp.asarray(frames))
        got = _plain_stem(P(cfg), sd, frames)
    assert torch_detection.branch_counts[branch] == before[branch] + 1
    assert bool(got.valid.any())
    _assert_outputs_match(want, got)


# tiny-plus: DCN blocks in stages 1-3 with seeded non-zero offsets, and
# the maskiou re-scoring (JAX's separate MaskIoUHead tree); mask_scores are
# compared where the detection is valid, within the masks' 1e-4
@pytest.mark.parametrize('sparse,branch', [(True, 'pruned'),
                                           (False, 'full')])
def test_plus_forward_and_detect_matches_jax(sparse, branch):
    cfg = tiny_plus_config(nms_candidates=256)
    variables = seed_offsets_jax(_variables(cfg, sparse), seed=4)
    miou = jax.tree_util.tree_map(np.array, dict(MaskIoUHead(cfg).init(
        jax.random.PRNGKey(9), jnp.zeros((1, 32, 32, 1)))))
    frames = _frames(cfg)
    want = jax.jit(lambda v, m, x: jax_forward_and_detect(
        cfg, JaxYolact(cfg), v, x, maskiou_variables=m))(
            variables, miou, jnp.asarray(frames))

    sd = jax_variables_to_state_dict(P(cfg), dict(variables, maskiou=miou))
    before = dict(torch_detection.branch_counts)
    got = _plain_stem(P(cfg), sd, frames)
    assert torch_detection.branch_counts[branch] == before[branch] + 1
    assert bool(got.valid.any())
    _assert_outputs_match(want, got)
    valid = got.valid.numpy()
    assert got.mask_scores.shape == got.scores.shape
    np.testing.assert_allclose(got.mask_scores.numpy()[valid],
                               np.asarray(want.mask_scores)[valid],
                               rtol=0, atol=1e-4)
    assert (got.mask_scores.numpy()[valid] > 0).any()


def test_uncropped_masks_match_jax():
    """crop_masks=False runs the plain composition, not the kernel."""
    cfg = tiny_resnet_config()
    variables = _variables(cfg, sparse=True)
    frames = _frames(cfg, batch=1)
    want = jax.jit(lambda v, x: jax_forward_and_detect(
        cfg, JaxYolact(cfg), v, x, crop_masks=False))(
            variables, jnp.asarray(frames))
    _assert_outputs_match(want, _plain_stem(
        P(cfg), jax_variables_to_state_dict(P(cfg), variables), frames,
        crop_masks=False))


@pytest.mark.parametrize('name,cfg_kw,call_kw,hw', [
    ('cross_class', {}, {'use_cross_class_nms': True}, (128, 128)),
    ('box_only', {'eval_mask_branch': False}, {}, (128, 128)),
    # upscaled non-square frames: the resize agrees with JAX (no antialias
    # difference when upscaling) and the priors are non-square
    ('preserve_ar', {'preserve_aspect_ratio': True}, {}, (80, 100)),
])
def test_forward_and_detect_variants_match_jax(name, cfg_kw, call_kw, hw):
    cfg = tiny_resnet_config(**cfg_kw)
    variables = _variables(cfg, sparse=True)
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (2,) + hw + (3,)).astype(np.float32)
    want = jax.jit(lambda v, x: jax_forward_and_detect(
        cfg, JaxYolact(cfg), v, x, **call_kw))(variables, jnp.asarray(frames))
    got = _plain_stem(P(cfg), jax_variables_to_state_dict(P(cfg), variables),
                      frames, **call_kw)
    assert bool(got.valid.any())
    _assert_outputs_match(want, got)


def _synthetic_preds(rng, P=500, C1=6, Md=8, n_hot=200):
    """Raw head outputs with `n_hot` confidently foreground priors."""
    priors = np.concatenate([rng.rand(P, 2), rng.rand(P, 2) * 0.2 + 0.05],
                            axis=1).astype(np.float32)
    conf = np.zeros((2, P, C1), np.float32)
    conf[..., 0] = 8.0
    for b in range(2):
        hot = rng.choice(P, n_hot, replace=False)
        conf[b, hot, 0] = 0.0
        conf[b, hot, 1 + (hot % (C1 - 1))] = 6.0 + rng.rand(n_hot)
    return dict(loc=(rng.randn(2, P, 4) * 0.3).astype(np.float32), conf=conf,
                mask=rng.randn(2, P, Md).astype(np.float32), priors=priors,
                proto=rng.rand(2, 16, 16, Md).astype(np.float32))


@pytest.mark.parametrize('n_cand,cross_class,second', [
    (0, False, False), (64, False, False), (256, False, True),
    (256, True, False), (64, True, False)])
def test_detect_matches_jax(rng, n_cand, cross_class, second):
    """detect() alone on synthetic head outputs: 200 hot priors per image,
    so nms_candidates=64 takes the unpruned fallback and 256 the prune."""
    cfg = C.get_config('yolact_base').copy(num_classes=6,
                                           nms_candidates=n_cand)
    preds = _synthetic_preds(rng)
    want = jax_detect(cfg, {k: jnp.asarray(v) for k, v in preds.items()},
                      use_cross_class_nms=cross_class, second_threshold=second)
    got = torch_detection.detect(
        P(cfg), {k: torch.from_numpy(v) for k, v in preds.items()},
        use_cross_class_nms=cross_class, second_threshold=second)
    for name in ('valid', 'classes', 'scores', 'boxes', 'masks'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('cfg_kw,score_threshold', [
    ({'eval_mask_branch': False}, 0.0),
    ({'mask_type': C.MaskType.DIRECT, 'mask_size': 4}, 0.3),
    ({'mask_proto_mask_activation': 'relu'}, 0.3),
])
def test_postprocess_branches_match_jax(rng, cfg_kw, score_threshold):
    cfg = C.get_config('yolact_base').copy(**cfg_kw)
    B, D, Md = 2, 7, 16
    arrays = dict(
        boxes=np.sort(rng.rand(B, D, 4), axis=-1).astype(np.float32)[
            ..., [0, 2, 1, 3]],
        masks=rng.randn(B, D, Md).astype(np.float32),
        classes=rng.randint(0, 4, (B, D)).astype(np.int32),
        scores=rng.rand(B, D).astype(np.float32),
        valid=rng.rand(B, D) > 0.3,
        proto=rng.rand(B, 12, 12, Md).astype(np.float32))
    want_m, want_d = jax_postprocess_device(
        cfg, JaxDetections(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        score_threshold=score_threshold)
    got_m, got_d = postprocess_device(
        P(cfg), torch_detection.Detections(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}),
        score_threshold=score_threshold)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_d.valid.numpy(),
                                  np.asarray(want_d.valid))


def test_pruned_and_full_tails_agree():
    """The pruned tail and the unpruned fallback give the same detections
    on the same inputs (the fallback is what makes the prune exact)."""
    cfg = tiny_resnet_config()
    sd = jax_variables_to_state_dict(P(cfg), _variables(cfg, sparse=True))
    frames = _frames(cfg)
    pruned = Pipeline(P(cfg).copy(nms_candidates=256), sd, 'cpu')(frames)
    full = Pipeline(P(cfg).copy(nms_candidates=0), sd, 'cpu')(frames)
    np.testing.assert_array_equal(pruned.valid.numpy(), full.valid.numpy())
    v = full.valid
    for name in ('classes', 'scores', 'boxes', 'masks'):
        assert torch.equal(getattr(pruned, name)[v], getattr(full, name)[v])


def test_random_state_dict_is_seeded_and_loads():
    cfg = tiny_resnet_config()
    a = random_state_dict(P(cfg), torch.Generator().manual_seed(0))
    b = random_state_dict(P(cfg), torch.Generator().manual_seed(0))
    c = random_state_dict(P(cfg), torch.Generator().manual_seed(1))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['backbone.conv1.weight'],
                           c['backbone.conv1.weight'])
    out = Pipeline(P(cfg), a, 'cpu',
                   compute_dtype='bfloat16')(_frames(cfg, 1))
    assert out.masks.shape == (1, cfg.max_num_detections, 32, 32)
    assert out.masks.dtype == torch.float32
    assert all(bool(torch.isfinite(t).all())
               for t in (out.boxes, out.scores, out.masks))


def test_bf16_pipeline_keeps_maskiou_net_float32():
    """A bfloat16 Pipeline casts the conv and DCN weights, never the mask
    scorer's: JAX runs MaskIoUHead in float32, so its weights must equal
    the state dict bit for bit."""
    cfg = tiny_plus_config()
    sd = random_state_dict(P(cfg), torch.Generator().manual_seed(0))
    model = Pipeline(P(cfg), sd, 'cpu', 'bfloat16').model
    params = dict(model.named_parameters())
    scorer = [k for k in params if k.startswith('maskiou_net.')]
    assert scorer
    for k in scorer:
        assert params[k].dtype == torch.float32
        assert torch.equal(params[k], sd[k]), k
    dcn_weight = 'backbone.layers.1.0.conv2.weight'
    assert params[dcn_weight].dtype == torch.bfloat16
    assert params['backbone.conv1.weight'].dtype == torch.bfloat16


def test_float32_entry_points_turn_tf32_off(monkeypatch):
    """float32 means float32: a float32 Pipeline, load_model or train state
    turns cuDNN's and cuBLAS's TF32 off (the process's flags, which the
    backward's convolutions read too); a bfloat16 one leaves them."""
    from yolact_tpu_torch.train.step import create_train_state
    cfg = P(tiny_resnet_config())
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))

    def defaults():
        monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
        monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)

    def tf32():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    for build in (lambda dt: Pipeline(cfg, sd, 'cpu', dt),
                  lambda dt: load_model(cfg, sd, 'cpu', dt),
                  lambda dt: create_train_state(
                      cfg.copy(compute_dtype=dt), device='cpu',
                      state_dict=sd)):
        defaults()
        build('bfloat16')
        assert tf32() == (True, True)
        build('float32')
        assert tf32() == (False, False)


def test_pipeline_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; this checks the no-GPU error')
    cfg = tiny_resnet_config()
    sd = random_state_dict(P(cfg), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='cuda'):
        Pipeline(P(cfg), sd, 'cuda')


def test_port_imports_no_jax_flax_or_cv2():
    """Every module of the port, chip_smoke.py and probe_spatial.py (their
    imports; main() does not run on import) and the ranks' modules of the
    data-parallel and spatial tests (tests/torch_parallel_worker.py,
    tests/torch_spatial_worker.py), in a fresh interpreter: no module of
    JAX, flax, cv2 or the JAX package (``yolact_tpu``) is loaded, and the
    modules that came with the video entry point, the model options, data
    parallelism and device augmentation (eval/video.py, utils/nvinfo.py,
    ops/resize.py, parallel/mesh.py, ops/bits.py, data/device_augment.py)
    are among those imported."""
    code = ('import importlib, pkgutil, sys\n'
            'import yolact_tpu_torch\n'
            'for m in pkgutil.walk_packages(yolact_tpu_torch.__path__,\n'
            '                               "yolact_tpu_torch."):\n'
            '    importlib.import_module(m.name)\n'
            'import chip_smoke, probe_spatial, torch_parallel_worker\n'
            'import torch_spatial_worker\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
            '             ("jax", "flax", "cv2", "yolact_tpu"))\n'
            'n = sum(m.startswith("yolact_tpu_torch.") for m in sys.modules)\n'
            'new = {"yolact_tpu_torch.eval.video", "yolact_tpu_torch.utils.nvinfo",\n'
            '       "yolact_tpu_torch.ops.resize",\n'
            '       "yolact_tpu_torch.parallel.mesh", "yolact_tpu_torch.ops.bits",\n'
            '       "yolact_tpu_torch.data.device_augment"} - set(sys.modules)\n'
            'print(bad, n, new)\n'
            'sys.exit(1 if bad or new or n < 30 else 0)\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests')]))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PORT_SOURCES = sorted(
    os.path.relpath(path, REPO) for path in
    glob.glob(os.path.join(REPO, 'yolact_tpu_torch', '**', '*.py'),
              recursive=True)) + ['chip_smoke.py', 'probe_cells.py',
                                  'probe_dcn.py', 'probe_dp.py',
                                  'probe_host.py', 'probe_small_kernels.py',
                                  'probe_export.py', 'probe_spatial.py',
                                  'probe_trainer.py', 'probe_horizon.py',
                                  'tests/torch_parallel_worker.py',
                                  'tests/torch_spatial_worker.py']


@pytest.mark.parametrize('path', PORT_SOURCES)
def test_port_source_imports_nothing_of_jax(path):
    """No import statement of the port or of its scripts on the card
    (chip_smoke.py and the probes) names JAX, flax or the JAX package, at
    any depth of the file (lazy imports inside functions included)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names
           if n.split('.')[0] in ('jax', 'flax', 'yolact_tpu')]
    assert not bad, bad
