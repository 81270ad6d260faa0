"""The port's export (yolact_tpu_torch/convert/export.py, cli/export.py) and
the kernels' custom ops, on the CPU, in float32.

- ``torch.library.opcheck`` on the five custom ops (CPU implementations,
  fake implementations, the stem's and the DCN columns' autograd), and
  their gradients through the ops against autograd through the plain
  versions in float64.
- ``detect`` alone exported once and fed predictions that take the pruned
  NMS tail and predictions that take the full one: the ``torch.cond`` in
  the graph picks each, exactly as eager ``detect`` does, and within the
  pipeline tests' 1e-6 of JAX's ``detect``.
- Export -> save -> load of tiny base (b2, the s2d stem, sparse conf: the
  pruned tail) and tiny plus (DCN ops, the ``mask_scores`` field, dense
  conf: the full tail) against the port's ``Pipeline`` (within 1e-6) and
  JAX's ``Pipeline`` on the same weights and frames (the pipeline rule:
  classes and valid identical, scores and boxes 1e-5, masks and
  mask_scores 1e-4).
- The CLI with ``--cuda=False --selftest`` from a port ``.pth`` and from a
  JAX ``.ckpt`` (``tests/test_export.py:test_export_cli``'s counterpart);
  the ``.pt2`` in a fresh interpreter where JAX cannot be imported; a
  float32 artifact's ``load_exported`` turns TF32 off and a bfloat16 one
  leaves it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _tiny import tiny_plus_config, tiny_resnet_config
from test_torch_inputs import seed_offsets_jax
from yolact_tpu import config as C
from yolact_tpu.detect.detection import detect as jax_detect
from yolact_tpu.infer import Pipeline as JaxPipeline
from yolact_tpu.infer import random_variables
from yolact_tpu.models.yolact import MaskIoUHead
from yolact_tpu_torch.cli import export as export_cli
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.export import (export_inference, load_exported,
                                             read_meta)
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.detect import detection
from yolact_tpu_torch.infer import Pipeline, random_state_dict
from yolact_tpu_torch.kernels import dcn, mask_assembly, nms, stem

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ('boxes', 'classes', 'scores', 'masks', 'valid', 'mask_scores')
# the pipeline rule of tests/test_torch_pipeline.py
JAX_TOL = dict(scores=1e-5, boxes=1e-5, masks=1e-4, mask_scores=1e-4)


# ---- the custom ops -------------------------------------------------------

def _dcn_args(dtype=torch.float32, seed=0):
    """NHWC x, offsets with fractional and out-of-map samples, a mask in
    x's dtype and the C entry point's geometry, for a 3x3 DCN on 5 x 6."""
    g = torch.Generator().manual_seed(seed)
    b, c, h, w = 2, 3, 5, 6
    xh = torch.randn(b, h, w, c, generator=g, dtype=dtype)
    offset = (torch.randn(b, 18, h, w, generator=g) * 1.7).to(dtype)
    mask = torch.rand(b, 9, h, w, generator=g, dtype=dtype)
    return xh, offset, mask, [b, c, h, w, h, w, 3, 1, 1, 1]


def _op_cases():
    g = torch.Generator().manual_seed(1)
    xy = torch.rand(3, 7, 2, generator=g)
    boxes = torch.cat([xy, xy + torch.rand(3, 7, 2, generator=g)], -1)
    xh, offset, mask, dims = _dcn_args()
    return {
        'mask_assembly': (mask_assembly.mask_assembly_op, (
            torch.rand(2, 6, 6, 4, generator=g),
            torch.randn(2, 3, 4, generator=g), boxes[:2, :3] / 2, 1)),
        'nms_iou_max': (nms.nms_iou_max_op, (boxes,)),
        'stem_s2d': (stem.stem_s2d_op, (
            torch.randn(1, 12, 5, 6, generator=g).requires_grad_(),
            torch.randn(64, 12, 4, 4, generator=g).requires_grad_())),
        'dcn_columns': (dcn.dcn_columns_op, (
            xh.requires_grad_(), offset.requires_grad_(),
            mask.requires_grad_(), dims)),
        'dcn_col2im': (dcn.dcn_col2im_op, (
            torch.randn(60, 27, generator=g), xh.detach(), offset.detach(),
            mask.detach(), dims)),
    }


@pytest.mark.parametrize('name', ['mask_assembly', 'nms_iou_max',
                                  'stem_s2d', 'dcn_columns', 'dcn_col2im'])
def test_opcheck(name):
    """Schema, fake implementation (traced and dynamic shapes) and
    autograd registration of each op, on its CPU implementation; the op
    equals its plain version.  dcn_col2im's CPU implementation runs
    torch.func.vjp (autograd is not dispatched inside an op's
    implementation), whose wrapped tensors opcheck's dispatch modes cannot
    inspect: for it opcheck checks the autograd registration, and the test
    checks the rest itself (the fake outputs' shapes, dtypes and strides
    those of the real ones, no input mutated, no output aliasing one)."""
    op, args = _op_cases()[name]
    if name != 'dcn_col2im':
        torch.library.opcheck(op, args)
    else:
        torch.library.opcheck(op, args,
                              test_utils=('test_autograd_registration',))
        before = [t.clone() for t in args[:4]]
        out = op(*args)
        assert all(torch.equal(a, b) for a, b in zip(args[:4], before))
        ptrs = {t.untyped_storage().data_ptr() for t in args[:4]}
        assert not ptrs & {t.untyped_storage().data_ptr() for t in out}
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(t) for t in args[:4]], args[4])
        assert [(f.shape, f.dtype, f.stride()) for f in fake] == \
            [(r.shape, r.dtype, r.stride()) for r in out]
    got = op(*args)
    if name == 'mask_assembly':
        want = mask_assembly.assemble_masks_plain(*args)
    elif name == 'nms_iou_max':
        want = nms.nms_iou_max_plain(*args)
    elif name == 'stem_s2d':
        want = stem.stem_conv_s2d_plain(*args)
    elif name == 'dcn_columns':
        xh, offset, mask, dims = args
        want = dcn.dcn_columns_plain(xh.permute(0, 3, 1, 2), offset, mask)
    else:
        g_cols, xh, offset, mask, dims = args
        want = dcn.dcn_col2im_plain(g_cols, xh.permute(0, 3, 1, 2), offset,
                                    mask)
        got = (got[0].permute(0, 3, 1, 2),) + tuple(got[1:])
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


CUDA_IMPLS = {
    'mask_assembly': (mask_assembly, '_launch', '_mask_assembly_cuda'),
    'nms_iou_max': (nms, '_launch', '_nms_iou_max_cuda'),
    'stem_s2d': (stem, '_launch', '_stem_s2d_cuda'),
    'dcn_columns': (dcn, '_launch_im2col', '_dcn_columns_cuda'),
    'dcn_col2im': (dcn, '_launch_col2im', '_dcn_col2im_cuda'),
}


@pytest.mark.parametrize('name', sorted(CUDA_IMPLS))
def test_cuda_implementations_make_inputs_contiguous(name, monkeypatch):
    """An exported program's tensors need not keep the strides they were
    traced with (in a loaded yolact_plus_base artifact on the card the DCN
    offsets and mask arrived channels_last, where eager and the trace had
    them contiguous, and the kernel read them as NCHW): each op's CUDA
    implementation hands its launch contiguous tensors.  Checked here on
    strided CPU tensors, with the launch replaced by a recorder."""
    module, launch, impl = CUDA_IMPLS[name]
    seen = []

    def record(*args):
        seen.extend(t.is_contiguous() for t in args if torch.is_tensor(t))
        return 'launched'

    monkeypatch.setattr(module, launch, record)
    _, args = _op_cases()[name]
    strided = [t.detach().mT.contiguous().mT if torch.is_tensor(t) else t
               for t in args]
    assert not all(t.is_contiguous() for t in strided if torch.is_tensor(t))
    assert getattr(module, impl)(*strided) == 'launched'
    assert seen and all(seen)


def test_stem_op_gradients_match_plain():
    """float64 in: the stem op's gradients (its register_autograd backward)
    against autograd through the plain version, to 1e-10."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 12, 7, 9, generator=g, dtype=torch.float64)
    w2 = torch.randn(64, 12, 4, 4, generator=g, dtype=torch.float64)
    cot = torch.randn(2, 64, 7, 9, generator=g, dtype=torch.float64)
    grads = []
    for fn in (stem.stem_s2d_op, stem.stem_conv_s2d_plain):
        leaves = [x.clone().requires_grad_(), w2.clone().requires_grad_()]
        (fn(*leaves) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    assert float(grads[0][1].abs().max()) > 1.0


def test_dcn_op_gradients_match_plain():
    """float64 in: the DCN columns op's gradients (its backward is the
    dcn_col2im op) against autograd through dcn_columns_plain, to 1e-10,
    and gradcheck of the op."""
    xh, offset, mask, dims = _dcn_args(torch.float64, seed=3)
    cot = torch.randn(60, 27, generator=torch.Generator().manual_seed(4),
                      dtype=torch.float64)
    grads = []
    for through_op in (True, False):
        leaves = [t.clone().requires_grad_() for t in (xh, offset, mask)]
        if through_op:
            cols = dcn.dcn_columns_op(*leaves, dims)
        else:
            cols = dcn.dcn_columns_plain(leaves[0].permute(0, 3, 1, 2),
                                         *leaves[1:])
        (cols * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
        assert float(a.abs().max()) > 0.1
    small = [t[:1, :3, :3].contiguous() if t is xh else t[:1, :, :3, :3]
             .contiguous() for t in (xh, offset, mask)]
    torch.autograd.gradcheck(
        lambda *t: dcn.dcn_columns_op(*t, [1, 3, 3, 3, 3, 3, 3, 1, 1, 1]),
        [t.requires_grad_() for t in small])


# ---- detect, exported -----------------------------------------------------

def _synthetic_preds(rng, n_hot, P=500, C1=6, Md=8):
    """Raw head outputs with `n_hot` confidently foreground priors per
    image (tests/test_torch_pipeline.py:_synthetic_preds)."""
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


class _Detect(torch.nn.Module):
    KEYS = ('loc', 'conf', 'mask', 'priors', 'proto')

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward(self, loc, conf, mask, priors, proto):
        d = detection.detect(self.cfg, dict(loc=loc, conf=conf, mask=mask,
                                            priors=priors, proto=proto))
        return d.boxes, d.masks, d.classes, d.scores, d.valid


def test_exported_detect_takes_both_tails(rng):
    """One exported detect (nms_candidates=256 of 500 priors): 200 hot
    priors an image take the pruned tail, 300 the full one; each run
    equals eager detect exactly and JAX's detect within 1e-6."""
    jcfg = C.get_config('yolact_base').copy(num_classes=6, nms_candidates=256)
    cfg = P(jcfg)
    cases = {branch: _synthetic_preds(rng, n_hot)
             for branch, n_hot in (('pruned', 200), ('full', 300))}
    args = lambda preds: tuple(torch.from_numpy(preds[k])
                               for k in _Detect.KEYS)
    ep = torch.export.export(_Detect(cfg), args(cases['pruned']))
    assert any(n.target is torch.ops.higher_order.cond
               for n in ep.graph.nodes)
    run = ep.module()
    for branch, preds in cases.items():
        before = dict(detection.branch_counts)
        eager = _Detect(cfg)(*args(preds))
        assert detection.branch_counts[branch] == before[branch] + 1
        got = run(*args(preds))
        for a, b in zip(got, eager):
            assert torch.equal(a, b), branch
        want = jax_detect(jcfg, {k: jnp.asarray(v) for k, v in preds.items()})
        for name, a in zip(('boxes', 'masks', 'classes', 'scores', 'valid'),
                           got):
            np.testing.assert_allclose(a.numpy(), np.asarray(
                getattr(want, name)), rtol=0, atol=1e-6,
                err_msg=f'{branch} {name}')


# ---- whole programs -------------------------------------------------------

def _variables(cfg, sparse):
    """JAX's seeded init; `sparse` biases the conf head to background so
    that ~150 of the tiny priors pass conf_thresh (the pruned tail)."""
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=3))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    if sparse:
        head = v['params']['prediction_layers_0']['conf_layer']['conv']
        b = np.array(head['bias']).reshape(-1, cfg.num_classes)
        b[:, 0] += 3.0
        head['bias'] = b.reshape(-1)
    return v


def _frames(cfg, batch=2):
    rng = np.random.RandomState(7)
    return rng.randint(0, 256, (batch, cfg.max_size, cfg.max_size, 3)
                       ).astype(np.float32)


class _Artifact:
    """An exported tiny config with its weights in both packages."""

    def __init__(self, tmp, name, jcfg, variables, miou=None, batch=2,
                 compute_dtype=None):
        self.jcfg, self.variables, self.miou = jcfg, variables, miou
        self.cfg = P(jcfg)
        self.sd = jax_variables_to_state_dict(
            self.cfg, dict(variables, maskiou=miou) if miou else variables)
        self.path = str(tmp / f'{name}.pt2')
        self.meta = export_inference(self.cfg, self.sd, self.path,
                                     batch_size=batch, device='cpu',
                                     compute_dtype=compute_dtype)
        self.frames = _frames(jcfg, batch)


@pytest.fixture(scope='module')
def base(tmp_path_factory):
    jcfg = tiny_resnet_config(nms_candidates=256)
    return _Artifact(tmp_path_factory.mktemp('base'), 'base', jcfg,
                     _variables(jcfg, sparse=True))


@pytest.fixture(scope='module')
def plus(tmp_path_factory):
    jcfg = tiny_plus_config(nms_candidates=256)
    variables = seed_offsets_jax(_variables(jcfg, sparse=False), seed=4)
    miou = jax.tree_util.tree_map(np.array, dict(MaskIoUHead(jcfg).init(
        jax.random.PRNGKey(9), jnp.zeros((1, 32, 32, 1)))))
    return _Artifact(tmp_path_factory.mktemp('plus'), 'plus', jcfg,
                     variables, miou)


@pytest.mark.parametrize('which,branch', [('base', 'pruned'),
                                          ('plus', 'full')])
def test_artifact_matches_pipelines(request, which, branch):
    art = request.getfixturevalue(which)
    runner = load_exported(art.path)
    meta = runner.meta
    assert meta == read_meta(art.path)
    assert (meta['config'], meta['batch'], meta['device'],
            meta['compute_dtype']) == (art.cfg.name, 2, 'cpu', 'float32')
    plus = which == 'plus'
    assert meta['has_mask_scores'] is plus
    assert meta['fields'] == list(FIELDS if plus else FIELDS[:-1])
    ops = {str(n.target) for n in runner.program.graph_module.graph.nodes
           if n.op == 'call_function'}
    assert {'yolact_tpu_torch.stem_s2d.default',
            'yolact_tpu_torch.mask_assembly.default'} <= ops
    assert ('yolact_tpu_torch.dcn_columns.default' in ops) is plus

    got = runner(art.frames)
    before = dict(detection.branch_counts)
    live = Pipeline(art.cfg, art.sd, 'cpu')(art.frames)
    assert detection.branch_counts[branch] == before[branch] + 1
    want = JaxPipeline(art.jcfg, art.variables,
                       maskiou_variables=art.miou)(art.frames)
    assert len(got) == len(meta['fields'])
    assert bool(got[meta['fields'].index('valid')].any())
    for name, a in zip(meta['fields'], got):
        b = getattr(live, name)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
        j = np.asarray(getattr(want, name))
        if name in JAX_TOL:
            # mask_scores where the detection is valid, as the pipeline
            # tests hold them
            keep = live.valid.numpy() if name == 'mask_scores' \
                else slice(None)
            np.testing.assert_allclose(a.numpy()[keep], j[keep], rtol=0,
                                       atol=JAX_TOL[name], err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), j, err_msg=name)


def test_artifact_runs_where_jax_cannot_be_imported(base, tmp_path):
    """A fresh interpreter in which importing jax, flax or yolact_tpu
    fails loads the .pt2 and gives the outputs of this process."""
    want = load_exported(base.path)(base.frames)
    frames = str(tmp_path / 'frames.npy')
    np.save(frames, base.frames)
    expect = str(tmp_path / 'want.pt')
    torch.save(want, expect)
    code = (
        'import importlib.abc, sys\n'
        'class Block(importlib.abc.MetaPathFinder):\n'
        '    def find_spec(self, name, path, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "yolact_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import numpy as np, torch\n'
        'from yolact_tpu_torch.convert.export import load_exported\n'
        f'got = load_exported({base.path!r})(np.load({frames!r}))\n'
        f'want = torch.load({expect!r})\n'
        'assert all(torch.equal(a, b) for a, b in zip(got, want))\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in\n'
        '       ("jax", "flax", "yolact_tpu")]\n'
        'assert not bad, bad\n'
        'print("ok", len(got))\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'ok 5' in proc.stdout


def test_float32_artifact_turns_tf32_off(base, tmp_path, monkeypatch):
    """float32 means float32 in the loading process too: loading a float32
    artifact turns cuDNN's and cuBLAS's TF32 off; a bfloat16 one leaves
    them (test_float32_entry_points_turn_tf32_off's rule)."""
    bf16 = str(tmp_path / 'bf16.pt2')
    export_inference(base.cfg, base.sd, bf16, batch_size=1, device='cpu',
                     compute_dtype='bfloat16')
    assert read_meta(bf16)['compute_dtype'] == 'bfloat16'

    def tf32():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    for path, want in ((bf16, (True, True)), (base.path, (False, False))):
        monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
        monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
        load_exported(path)
        assert tf32() == want, path


@pytest.mark.parametrize('weights', ['pth', 'ckpt'])
def test_export_cli(tmp_path, weights, capsys):
    """cli/export with --cuda=False --selftest on a registered tiny config,
    from a port checkpoint and from a JAX .ckpt (the config parsed from
    the file name); the artifact's outputs have the pipeline's shapes."""
    from yolact_tpu.config import register_config as jax_register_config
    from yolact_tpu.train.checkpoint import save_weights_only
    jcfg = tiny_resnet_config().copy(name=f'tinyexport{weights}')
    jax_register_config(jcfg)
    register_config(P(jcfg))
    path = str(tmp_path / f'{jcfg.name}_0_1.{weights}')
    if weights == 'pth':
        torch.save(random_state_dict(P(jcfg),
                                     torch.Generator().manual_seed(0)), path)
    else:
        save_weights_only(random_variables(jcfg), path)
    out = str(tmp_path / f'{jcfg.name}.pt2')
    export_cli.main(['--trained_model=' + path, '--out=' + out,
                     '--cuda=False', '--batch_size=2', '--selftest'])
    printed = capsys.readouterr().out
    assert 'selftest ok: [(2, 100, 4), (2, 100), (2, 100),' in printed
    meta = read_meta(out)
    assert (meta['config'], meta['batch'], meta['device']) == \
        (jcfg.name, 2, 'cpu')


def test_export_scripts_import_nothing_of_jax():
    """probe_export.py, and chip_smoke.py's export worker (a program in a
    string, which the AST scan of chip_smoke.py does not read), import
    nothing of JAX, flax or the JAX package."""
    import ast
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        smoke = ast.parse(f.read())
    worker, = [node.value.value for node in smoke.body
               if isinstance(node, ast.Assign)
               and [t.id for t in node.targets] == ['EXPORT_WORKER']]
    with open(os.path.join(REPO, 'probe_export.py')) as f:
        sources = {'EXPORT_WORKER': worker, 'probe_export.py': f.read()}
    assert 'from yolact_tpu_torch.convert.export import' in worker
    for name, source in sources.items():
        names = []
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Import):
                names += [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        assert names, name
        assert not [n for n in names
                    if n.split('.')[0] in ('jax', 'flax', 'yolact_tpu')], name
