"""The rank side of ``tests/test_torch_spatial.py``: what each rank of a
spatially partitioned run computes.  It imports nothing of JAX (a spawned
rank imports this module, not the test file): the port, torch, numpy, the
port-side inputs of ``test_torch_inputs`` and the rank starter of
``torch_parallel_worker``.

Each function takes the rank's world :class:`Mesh` (from
``torch_parallel_worker.run_ranks``) and a space split ``space``, builds the
2-D mesh itself (``make_mesh_2d``) and returns numpy arrays and plain
Python values.  With ``mesh`` None (the test process itself) the
step functions run the one-process step on the same inputs."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from torch_parallel_worker import _numpy

MAP = (2, 3, 11, 5)          # B, C, H, W of the op cases' input map


def map_shape(height: int) -> tuple:
    return MAP[:2] + (height, MAP[3])


def whole_map(seed: int, shape=MAP) -> torch.Tensor:
    return torch.from_numpy(
        np.random.RandomState(seed).standard_normal(shape))


def op_cases(height: int = MAP[2]):
    """name -> (whole-map op, row-sharded op), each on a float64 map of
    ``MAP``'s batch, channels and width and the given height; every op
    geometry the ResNet configs use."""
    from yolact_tpu_torch.models import layers as L

    def conv(k, s, p, d=1, cin=3, cout=4):
        c = L.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d).double()
        with torch.no_grad():
            c.weight.copy_(whole_map(7, tuple(c.weight.shape)))
            c.bias.copy_(whole_map(8, tuple(c.bias.shape)))
        return c

    def resize(h, w, mode):
        kw = {'align_corners': False} if mode == 'bilinear' else {}
        return (lambda x: F.interpolate(x, size=(h, w), mode=mode, **kw),
                lambda x, r: L.resize_rows(x, r, (h, w), mode))

    cases = {}
    for name, (k, s, p) in {'conv3x3': (3, 1, 1), 'conv3x3_s2': (3, 2, 1),
                            'conv1x1': (1, 1, 0), 'conv1x1_s2': (1, 2, 0),
                            'conv7x7_s2': (7, 2, 3),
                            'conv3x3_valid': (3, 1, 0)}.items():
        c = conv(k, s, p)
        cases[name] = (c, lambda x, r, c=c: L.conv_rows(c, x, r))
    cases['max_pool'] = (lambda x: L.max_pool(x, 3, 2, 1),
                         lambda x, r: L.max_pool_rows(x, r, 3, 2, 1))
    cases['upsample_x2'] = resize(2 * height, 2 * MAP[3], 'bilinear')
    cases['resize_fpn'] = resize(21, 9, 'bilinear')
    cases['resize_down'] = resize(6, 3, 'bilinear')
    cases['nearest'] = resize(21, 9, 'nearest')
    return cases


def seeded(module, seed):
    """`module` in float64 with every parameter a seeded normal draw."""
    module = module.double()
    with torch.no_grad():
        for i, p in enumerate(module.parameters()):
            p.copy_(whole_map(seed + i, tuple(p.shape)))
    return module


def config_op_cases(height: int = MAP[2]):
    """As :func:`op_cases`, for the op geometries the other configs add:
    VGG's ceil-mode and 3/1/1 pools and its dilation-6 fc6 conv, transposed
    convs (strides 1 and 2, ``output_padding``), the FPN's stride-2
    subsample without downsample convs, a ``'cat'`` entry of a conv and a
    transposed conv pair, and group norm on the map's rows."""
    from torch import nn

    from yolact_tpu_torch.models import layers as L

    def pool(k, s, p, ceil):
        return (lambda x: L.max_pool(x, k, s, p, ceil),
                lambda x, r: L.max_pool_rows(x, r, k, s, p, ceil))

    def transposed(k, s, p, op=0):
        c = seeded(L.ConvTranspose2d(3, 4, k, stride=s, padding=p,
                                     output_padding=op), 9)
        return c, lambda x, r: L.conv_transpose_rows(c, x, r)

    def group_norm(groups):
        gn = seeded(L.GroupNorm(3, num_groups=groups), 11)
        return gn, lambda x, r: (gn(x, rows=r), r)

    fc6 = seeded(L.Conv2d(3, 4, 3, padding=6, dilation=6), 7)
    cat = seeded(L.Concat([
        nn.Sequential(L.Conv2d(3, 2, 3, padding=1), nn.ReLU()),
        nn.Sequential(L.ConvTranspose2d(3, 2, 2, stride=2), nn.ReLU(),
                      L.Conv2d(2, 2, 2, stride=2), nn.LeakyReLU(0.1))]), 13)
    return {
        'max_pool_ceil': pool(2, 2, 0, True),
        'max_pool_ceil_k3_p1': pool(3, 2, 1, True),
        'max_pool_3_1_1': pool(3, 1, 1, False),
        'conv_dilation6': (fc6, lambda x, r: L.conv_rows(fc6, x, r)),
        'conv_transpose_k2_s2': transposed(2, 2, 0),
        'conv_transpose_k3_s1_p1': transposed(3, 1, 1),
        'conv_transpose_k3_s2_p1_op1': transposed(3, 2, 1, 1),
        'conv_transpose_k4_s2_p1': transposed(4, 2, 1),
        'subsample': (lambda x: x[:, :, ::2, ::2],
                      lambda x, r: L.max_pool_rows(x, r, 1, 2)),
        'cat': (cat, lambda x, r: L.run_rows([cat], x, r)),
        'group_norm': group_norm(3),
        'group_norm_1_group': group_norm(1),
    }


def _op_outputs(cases, rows, shape, to=lambda t: t):
    """Each row-sharded op of `cases` on this rank's rows of the seeded
    float64 map of `shape` (`to` moves a map where the ops run): its
    output rows, their owner's range and the gradient of
    ``sum(output * weight)`` (the weight a seeded map of the output's
    shape, this rank's rows of it)."""
    out = {}
    for name, (_, sharded) in cases.items():
        x = to(rows.take(whole_map(0, shape))).clone().requires_grad_(True)
        y, r = sharded(x, rows)
        full_shape = y.shape[:2] + (r.height, y.shape[3])
        w = to(r.take(whole_map(1, full_shape)))
        (y * w).sum().backward()
        out[name] = dict(y=y.detach().cpu().numpy(),
                         grad=x.grad.cpu().numpy(), own=r.own())
    return out


def config_ops_run(mesh, space, height):
    """:func:`config_op_cases` on this rank's rows (:func:`_op_outputs`)."""
    from yolact_tpu_torch.parallel.mesh import Rows, make_mesh_2d
    grid = make_mesh_2d(mesh, space)
    return _op_outputs(config_op_cases(height), Rows(grid.space, height),
                       map_shape(height))


def cuda_config_ops_run(mesh, space, height, names):
    """:func:`config_ops_run` for the cases `names`, in float32 on
    ``cuda:0`` (gloo carries the card's tensors)."""
    from yolact_tpu_torch.parallel.mesh import Rows, make_mesh_2d
    torch.backends.cudnn.allow_tf32 = False      # float32 means float32
    grid = make_mesh_2d(mesh, space)
    cases = {n: c for n, c in config_op_cases(height).items() if n in names}
    for whole, _ in cases.values():
        whole.to('cuda', torch.float32)
    return _op_outputs(cases, Rows(grid.space, height), map_shape(height),
                       to=lambda t: t.to('cuda', torch.float32))


def ops_run(mesh, space, height):
    """Every op case of :func:`op_cases` (:func:`_op_outputs`), the row
    fetch and the two gathers on this rank's rows of one float64 map of
    `height` rows (:func:`map_shape`); for the gathers the whole output and
    the gradient of a loss on it ('shared': the same on every rank; 'own':
    weighted by a rank's own seeded map)."""
    from yolact_tpu_torch.parallel.mesh import (Rows, fetch_rows,
                                                gather_rows, make_mesh_2d)
    grid = make_mesh_2d(mesh, space)
    rows = Rows(grid.space, height)
    shape = map_shape(height)
    out = _op_outputs(op_cases(height), rows, shape)
    # the fetch: rows [lo - 3, hi + 2) of every rank, -7 outside the map
    x = rows.take(whole_map(0, shape)).clone().requires_grad_(True)
    wins = [(lo - 3, hi + 2) for lo, hi in rows.owns()]
    y = fetch_rows(x, rows, wins, fill=-7.0)
    lo, hi = wins[grid.space.rank]
    (y * whole_map(2 + grid.space.rank, map_shape(hi - lo))).sum().backward()
    out['fetch'] = dict(y=y.detach().numpy(), grad=x.grad.numpy())
    # bfloat16 travels as its bytes
    x = rows.take(whole_map(0, shape)).to(torch.bfloat16)
    out['bf16'] = dict(fetch=fetch_rows(x, rows, wins, fill=-7.0).float()
                       .numpy(),
                       gather=gather_rows(x, rows, 'shared').float().numpy())
    for how in ('shared', 'own'):
        x = rows.take(whole_map(0, shape)).clone().requires_grad_(True)
        y = gather_rows(x, rows, how)
        seed = 3 if how == 'shared' else 4 + grid.space.rank
        (y * whole_map(seed, shape)).sum().backward()
        out[how] = dict(y=y.detach().numpy(), grad=x.grad.numpy())
    return out


def forward_run(mesh, space, cases):
    """The float64 eval forward (``Yolact.forward``; ``rows`` on this
    rank's rows of the input under the 2-D mesh, or the whole input when
    `mesh` is None) per ``(name, cfg)`` of `cases`, from seeded weights on
    a seeded image batch of 2: name -> the outputs as numpy arrays."""
    from yolact_tpu_torch.infer import random_state_dict
    from yolact_tpu_torch.models.yolact import Yolact
    from yolact_tpu_torch.parallel.mesh import Rows, make_mesh_2d
    if mesh is not None:
        mesh = make_mesh_2d(mesh, space)
    out = {}
    for name, cfg in cases:
        model = Yolact(cfg)
        model.load_state_dict(random_state_dict(
            cfg, torch.Generator().manual_seed(0)))
        model.double()
        model.compute_dtype = torch.float64
        x = whole_map(5, (2, 3, cfg.max_size, cfg.max_size))
        rows = None
        if mesh is not None:
            rows = Rows(mesh.space, x.shape[2])
            x = rows.take(x)
        with torch.no_grad():
            out[name] = {k: v.numpy().copy() for k, v in
                         model(x, rows=rows).items()}
    return out


def grid_run(mesh, space):
    """This rank's place on the 2-D mesh and the sums over its data and
    space groups of its world rank."""
    from yolact_tpu_torch.parallel.mesh import make_mesh_2d
    grid = make_mesh_2d(mesh, space)
    me = torch.tensor([float(mesh.rank)])
    return dict(data=(grid.data.rank, grid.data.size),
                space=(grid.space.rank, grid.space.size),
                data_sum=float(grid.data.all_sum(me)),
                space_sum=float(grid.space.all_sum(me)),
                world_sum=float(grid.all_sum(me)))


def _batches_for(mesh, batch):
    """This rank's part of a global batch: its data rank's rows (whole
    images), as the loader of a spatial run delivers them."""
    from yolact_tpu_torch.parallel.mesh import shard_batch
    if mesh is None:
        return batch
    data = mesh.data_mesh
    return shard_batch(batch, data.rank, data.size)


def train_run(mesh, space, cfg, state_dict, batches, seed=0, draws=None):
    """float32 ``train_step`` per global batch on this rank (one process
    when `mesh` is None), the draws from a generator seeded `seed` or,
    per step, the given global ``(mask_priorities, maskiou_priorities)``:
    per step the losses and whether the update was applied; after each
    step the weights and buffers; after the last the momentum."""
    from yolact_tpu_torch.parallel.mesh import make_mesh_2d
    from yolact_tpu_torch.train.step import (apply_gradients,
                                             create_train_state,
                                             loss_and_grads, train_step)
    if mesh is not None:
        mesh = make_mesh_2d(mesh, space)
    state = create_train_state(cfg, device='cpu', state_dict=state_dict,
                               mesh=mesh)
    generator = torch.Generator().manual_seed(seed)
    steps, weights = [], []
    for i, batch in enumerate(batches):
        batch = _batches_for(mesh, batch)
        if draws is None:
            out = train_step(state, batch, generator)
        else:
            mask_pri, miou_pri = (torch.as_tensor(d) for d in draws[i])
            if mesh is not None:
                mask_pri = mask_pri[mesh.data_mesh.rows(mask_pri.shape[0])]
            out = apply_gradients(state, loss_and_grads(
                state, batch, mask_pri, miou_pri))
        steps.append(dict({k: float(v) for k, v in out.items()
                           if k not in ('finite', 'lr')},
                          finite=out['finite'], lr=out['lr']))
        weights.append(_numpy(state.model.state_dict()))
    momentum = _numpy({k: state.optimizer.state[p]['momentum_buffer']
                       for k, p in state.model.named_parameters()
                       if p in state.optimizer.state})
    return dict(steps=steps, weights=weights, momentum=momentum)


def case_run(mesh, space, cfg, state_dict, batches, f64_steps, f32=False,
             controls=False):
    """:func:`float64_run` on the first `f64_steps` batches; with `f32`
    :func:`train_run` on all of them; with `controls` the first float64
    step again under each control of :func:`float64_run`."""
    out = dict(f64=float64_run(mesh, space, cfg, state_dict,
                               batches[:f64_steps]))
    if f32:
        out['f32'] = train_run(mesh, space, cfg, state_dict, batches)
    if controls:
        out['controls'] = {c: float64_run(mesh, space, cfg, state_dict,
                                          batches[:1], control=c)
                           for c in ('local_bn', 'own_gather')}
    return out


def float64_run(mesh, space, cfg, state_dict, batches, seed=0,
                control=None):
    """The train step in float64 (``.float()`` meaning float64, as
    ``torch_parallel_worker.float64_steps``) through the step's own
    pieces, ``forward_loss``, ``sum_over_ranks`` and ``apply_gradients``:
    one step per global batch, the draws as ``train_step`` takes them.
    Per step the losses; the first step's gradients; the weights and
    buffers after the last.  `control` breaks one piece on purpose
    (:func:`_control`)."""
    from yolact_tpu_torch.parallel import mesh as parallel
    from yolact_tpu_torch.train.step import (apply_gradients,
                                             batch_to_device,
                                             create_train_state,
                                             draw_priorities, forward_loss,
                                             sum_over_ranks)
    if mesh is not None:
        mesh = parallel.make_mesh_2d(mesh, space)
    state = create_train_state(cfg, device='cpu', state_dict=state_dict,
                               mesh=mesh)
    model = state.model.double()
    model.compute_dtype = torch.float64
    if state.conf_state is not None:
        state.conf_state = {k: v.double()
                            for k, v in state.conf_state.items()}
    undo = _control(control, model)
    priors = model.priors(cfg.max_size, cfg.max_size, 'cpu')
    generator = torch.Generator().manual_seed(seed)
    steps, grads = [], None
    real_float = torch.Tensor.float
    try:
        for batch in batches:
            n = len(batch['image'])
            mask_pri, miou_pri = (d.double() for d in draw_priorities(
                cfg, n, priors.shape[0], generator, 'cpu'))
            batch = _batches_for(mesh, batch)
            if mesh is not None:
                mask_pri = mask_pri[mesh.data_mesh.rows(n)]
            state.optimizer.zero_grad(set_to_none=True)
            torch.Tensor.float = torch.Tensor.double
            try:
                tensors = batch_to_device(
                    dict(batch, image=batch['image'].astype(np.float64)),
                    'cpu')
                losses = forward_loss(state, tensors, mask_pri, miou_pri,
                                      num_gts=batch['num_gts'])
                losses['total'].backward()
            finally:
                torch.Tensor.float = real_float
            out = apply_gradients(state, sum_over_ranks(state, losses))
            steps.append({k: float(v) for k, v in out.items()
                          if k not in ('finite', 'lr')})
            if grads is None:
                grads = _numpy({k: p.grad for k, p in
                                model.named_parameters()
                                if p.grad is not None})
    finally:
        undo()
    return dict(steps=steps, grads=grads,
                weights=_numpy(model.state_dict()))


def _control(control, model):
    """Break one piece of the spatial step on purpose; returns what undoes
    it.  'local_bn': each rank's own batch-norm moments; 'own_gather': the
    head outputs' gather with the 'own' gradient; 'local_gn': group norm's
    moments over each rank's own rows; 'shared_features': the prototypes
    as features gathered with the 'shared' gradient, as the loss's are."""
    from yolact_tpu_torch.models import heads, layers, yolact
    from yolact_tpu_torch.parallel import mesh as parallel
    real_gather = parallel.gather_rows
    if control == 'local_bn':
        for m in model.modules():
            if hasattr(m, 'pending'):
                m.mesh = None
    elif control == 'own_gather':
        heads.gather_rows = lambda x, rows, grad: real_gather(x, rows, 'own')
    elif control == 'shared_features':
        yolact.gather_rows = \
            lambda x, rows, grad: real_gather(x, rows, 'shared')
    elif control == 'local_gn':
        real_gn = layers.GroupNorm.forward
        layers.GroupNorm.forward = \
            lambda self, x, train=False, rows=None: real_gn(self, x, train)
    elif control is not None:
        raise ValueError(f'control {control!r}')

    def undo():
        heads.gather_rows = yolact.gather_rows = real_gather
        if control == 'local_gn':
            layers.GroupNorm.forward = real_gn
    return undo


def cases_run(mesh, space, cases):
    """:func:`case_run` per ``(name, cfg, state_dict, batches, f64_steps,
    f32, controls)`` of `cases` on one set of ranks (`controls`: the
    names of :func:`_control`'s controls to run): name -> its results."""
    out = {}
    for name, cfg, sd, batches, steps, f32, controls in cases:
        out[name] = case_run(mesh, space, cfg, sd, batches, steps, f32)
        out[name]['controls'] = {
            c: float64_run(mesh, space, cfg, sd, batches[:1], control=c)
            for c in controls}
    return out


def infer_run(mesh, space, cfg, state_dict, images, dtype='float32'):
    """``Pipeline`` (host-normalized frames, ``preprocess=False``) on this
    rank's data rank's rows of `images` under the 2-D mesh (or all of
    them on one process): the detections as numpy arrays."""
    from yolact_tpu_torch.infer import Pipeline
    from yolact_tpu_torch.parallel.mesh import make_mesh_2d, shard_batch
    if mesh is not None:
        mesh = make_mesh_2d(mesh, space)
        images = shard_batch(images, mesh.data_mesh.rank,
                             mesh.data_mesh.size)
    pipe = Pipeline(cfg, state_dict, 'cpu', compute_dtype=dtype,
                    preprocess=False, mesh=mesh)
    out = pipe(torch.as_tensor(images))
    return {k: v.numpy().copy() for k, v in out._asdict().items()
            if v is not None}


def step_and_infer_run(mesh, space, cfg, state_dict, batches, draws,
                       infer_cfg, infer_state_dict, images):
    """:func:`train_run` with the given draws, then :func:`infer_run`, on
    one set of ranks."""
    return dict(step=train_run(mesh, space, cfg, state_dict, batches,
                               draws=draws),
                infer=infer_run(mesh, space, infer_cfg, infer_state_dict,
                                images))


def cli_run(mesh, cfg, runs):
    """``cli/train.train(argv)`` once per ``(argv, port, (n, sizes,
    seed))`` of `runs`, in turn, after registering `cfg` (a spawned rank
    starts with the built-in configs only); each run starts its own
    process group on `port`.  The data: ``SyntheticTrainSet(n, sizes)``
    of seeded frames under the training ``SSDAugmentation`` UNSEEDED, so
    each rank's loader augments on draws of its own, as the host loader's
    worker threads do.  Per run: the summary's iteration, start,
    checkpoint path and step, and the weights; per step the image the
    loader delivered to this rank, and what the forward took: the config,
    the prepared tensors, the draws, the weights before it and the
    losses."""
    import os

    from test_torch_inputs import SyntheticTrainSet
    from yolact_tpu_torch.cli import train as cli
    from yolact_tpu_torch.config import register_config
    from yolact_tpu_torch.data.augmentations import SSDAugmentation
    from yolact_tpu_torch.train import step
    register_config(cfg)
    real_loss_and_grads, real_forward_loss = (step.loss_and_grads,
                                              step.forward_loss)
    out = []
    for argv, port, (n, sizes, seed) in runs:
        loaded, steps = [], []

        def loss_and_grads(state, batch, *args, **kw):
            loaded.append(np.array(batch['image']))
            return real_loss_and_grads(state, batch, *args, **kw)

        def forward_loss(state, tensors, mask_pri, miou_pri, *args, **kw):
            weights = _numpy(state.model.state_dict())
            losses = real_forward_loss(state, tensors, mask_pri, miou_pri,
                                       *args, **kw)
            steps.append(dict(cfg=state.cfg, tensors=_numpy(tensors),
                              weights=weights,
                              draws=(mask_pri.numpy().copy(),
                                     miou_pri.numpy().copy()),
                              losses={k: float(v)
                                      for k, v in losses.items()}))
            return losses

        os.environ['MASTER_PORT'] = str(port)
        data = SyntheticTrainSet(n, sizes, cfg.num_classes,
                                 SSDAugmentation(cfg), seed=seed)
        step.loss_and_grads, step.forward_loss = (loss_and_grads,
                                                  forward_loss)
        try:
            run = cli.train(argv, dataset=data)
        finally:
            step.loss_and_grads, step.forward_loss = (real_loss_and_grads,
                                                      real_forward_loss)
        out.append(dict(iteration=run['iteration'],
                        start_iter=run['start_iter'], path=run['path'],
                        step=run['state'].step, loaded=loaded, steps=steps,
                        weights=_numpy(run['state'].model.state_dict())))
    return out
