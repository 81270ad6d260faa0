#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (yolact_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX or of the JAX package.
Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi); exit 1 without CUDA
2. build: the five kernels compiled from yolact_tpu_torch/csrc/*.cu
3. kernels vs their plain PyTorch versions on the card at main-path shapes:
   mask assembly at b8 and b1 (B x 100, 138x138, Md 32), a ragged D and a
   NaN coefficient row, within 1e-5 with the same zeros and NaNs (its max
   error printed); the IoU max bit for bit at [640,200], [80,200], K = 37,
   rows of near ties and of identical boxes; mask assembly also at phase
   9's options shapes (b8, b1 and D = 37 over 70x70 prototypes, Md 33:
   the kernel's copy branch for Md % 4 != 0); the DCN sampling at the five yolact_plus_base DCN shapes and one with
   Cin % 8 != 0, in bf16 at b8 and in f32 at b1, with integer, fractional,
   far out-of-bounds and non-finite offsets, bit for bit, from NCHW and
   channels_last inputs; the s2d stem conv at the yolact_base shapes (bf16
   b8, f32 b1 and b8), an odd one and f32 b8 inputs 1 + k * 2^-15 (the
   split-TF32 product's lo halves): f32 within 1e-5 of max|out|, bf16
   within one bf16 ulp of |plain| plus 1e-5 of max|plain|; the DCN backward
   (dcn_col2im) against autograd through the plain columns at the same six
   shapes and offsets, in bf16 at b8 and in f32 at b1 and at b8 (the train
   step's call), and with offsets beyond the kernel's window halo (its
   global path) at two shapes in f32 and bf16: f32 within 1e-5 of each
   gradient's largest entry, the offset and mask gradients exactly 0 where
   every addend is (no valid corner, no column gradient; for the offsets
   also mask 0) and grad_x exactly 0 where no valid corner lands; a value
   that is 0 in one of the two only (a sum that cancels may round to 0 in
   one order and not in the other) within the two summation orders' error
   bound, 2 (n - 1 + p) 2^-24 sum |addend|, with the count of such values
   nearer the float64 gradient in each; bf16 within one
   bf16 ulp plus 1e-2 of it; each line with the global-path share of the
   corners and the global reductions into grad_x; the stem's
   gradients at [8,12,275,275] f32 against autograd through the plain stem
4. the three paths, each at 550x550 with seeded random weights, b1 and b8
   in bf16 and b1 in f32 (TF32 off), with the kernels and with the plain
   versions, for (a) a dense conf head (most priors pass conf_thresh: the
   unpruned NMS fallback) and (b) a background-biased one (a few hundred
   pass: the pruned NMS tail):
   - yolact_base through the plain 7x7/s2 stem (load_model and
     forward_and_detect): the NMS and mask-assembly kernels;
   - Pipeline(yolact_base), which takes the space-to-depth stem for raw
     frames: the stem kernel as well, held against the plain-stem path
     (exactly in f32, as matched sets in bf16);
   - Pipeline(yolact_plus_base): ResNet-101 with 11 DCN blocks, whose
     offset convs get seeded non-zero weights (the zero init would put
     every sample on the grid), 57,744 priors, and the maskiou re-scoring;
     the NMS, mask-assembly, DCN and stem kernels.
   Each path's launch counts are set to 0 just before its kernel-path runs
   and must be above 0 just after (and 0 for the kernels the path does not
   run); paths with the bf16 s2d stem are held against their plain
   versions as matched sets in bf16, exactly in f32
4b. the other backbones, the same way, sparse cell only: yolact_darknet53,
   yolact_vgg16 (no FPN, six per-level heads, 56,992 priors) and
   yolact_base with RESNET101_GN_BACKBONE (group norm; Pipeline takes the
   s2d stem): the NMS and mask-assembly kernels on all three, the stem on
   the GN path only, no DCN; then the registered configs no earlier run
   took (A14_CONFIGS: yolact_im400, yolact_im700, yolact_resnet50,
   yolact_resnet50_pascal, yolact_plus_resnet50), each at its own size
   (400, 700, 550) and full width from seeded weights: Pipeline at b1 f32
   with the kernels against the plain versions by phase 4's rule, its conf
   head scaled and background-biased so that 100-900 priors pass
   conf_thresh (the bias read in the run from the plain model's logits,
   the count printed), the launches of each kernel (above 0 on the path,
   0 for one the config does not run); then one b8 f32 train step at the
   config's size by phase 6's rule (the s2d stem on the four ResNets
   without DCN, 'dcn' remat on yolact_plus_resnet50; losses within 1e-4
   relative, conv1's first gradient within STEM_BATCH_STATS_LIMIT behind
   the s2d stem under batch statistics, the other first gradients within
   1e-3, launches per step)
5. eval: evaluate_dataset over 16 seeded in-memory 550x550 frames with
   boxes and masks (no image files, no cv2), yolact_base sparse cell, b8
   bf16: fast NMS with the s2d stem (kernels, then plain versions: the same
   mAP table) and traditional NMS, the mask IoU on the card by default
   (every image's matrices equal to the host path's); launch counts
   checked, tables and frames/s printed.  Then 16 frames at 480x640,
   640x480 and 427x640 with one crowd each, mask IoU on the card and on
   the host (device, host, host, device): equal mAP tables, every image's
   IoU and crowd-IoU matrices equal, frames/s and the IoU stage's ms per
   image both ways; the same on detections made from the gt (a non-zero
   mAP); and an --output_coco_json run of the set through cli/coco_eval
   against a gt JSON written here: 12 finite numbers per type
6. train: three steps of train/step.py:train_step at 550x550, b8, float32
   (TF32 off) on a seeded synthetic batch (boxes, labels with one crowd per
   image and padding, rectangular masks), for yolact_base with the s2d stem
   and for yolact_plus_base (seeded offset convs, train_remat='dcn'), once
   with the kernels and once with their plain versions from the same
   weights (every bottleneck's last batch norm scaled to 0.1, which brings
   the random network's gradients from 1e6 to order 1) and draws, under
   PyTorch's deterministic algorithms and at a tenth of the config's
   learning rate warmed up from 1e-7 (so that the atomics' last bits stay
   last bits for three steps): every loss finite and equal within 1e-4 relative per
   step, the gradients of conv1 and of the first DCN block non-zero and
   within 1e-3 of their largest entry (yolact_base's on a second
   comparison with frozen batch norm, see TRAIN_PATHS), the launch counts per step (stem 1;
   DCN sampling 22 and backward 11 under 'dcn', 11 and 11 under 'none'), and
   a step on a NaN image, which must leave weights, momentum and batch-norm
   statistics bit-equal and advance the count; then ms per step, peak
   memory, device busy and idle share, the matcher's and the loss's time;
   for yolact_plus_base the inputs of each dcn_col2im launch of the first
   kernel step are recorded, held against the plain version as in phase 3
   and timed alone (beside the kernel's time inside the step), with the
   global reductions per step
9. model options and video (run after phase 4b): yolact_base with direct
   masks (mask_size 16: 256 values per prior, no protonet) and with every
   lincomb option the reference builds together (OPTIONS: 33 prototypes
   with the bias channel on P4 with data/grid.npy's 32 grid channels,
   prototypes as features, coefficient gate, mask scoring, instance
   coefficients, DSSD prediction module, YOLO regressors, an extra head
   net with a 'cat' and transposed convs), each at 550x550 in its sparse
   cell, b8 bf16 and b1 f32, kernels against plain versions as phase 4
   holds its paths (launches counted: the IoU max and the stem on both,
   mask assembly at Md 33 on the options path only); the direct masks
   pasted into their boxes (finish_masks_direct), kernel and plain pastes
   equal on >= 99.9% of pixels; e2e and device busy at b8 bf16; three
   train steps of each at 550 b8 f32 with the s2d stem, kernels against
   plain versions by phase 6's rule (losses within 1e-4 relative; conv1's,
   the heads' and the protonet's first gradients within
   STEM_BATCH_STATS_LIMIT under batch statistics and within 1e-3 with
   frozen batch norm; the stem once a step); then eval/video.py:evalvideo at
   yolact_base on 64 in-memory 720x1280 frames, 4 a batch, fast NMS, float32,
   masks drawn (no cv2 on the card for boxes and text), with the plain
   versions and with the kernels: launches one per batch each, the drawn
   frames equal on >= 99.9% of their pixels, the first batch's detections
   by phase 4's float32 rule, frames/s with the card's name and power
   limit, and apart the step, the masks' upsample and copy to the host and
   one frame's compositing (VIDEO_CELL and shape_masks give the random
   model detections and masks to draw)
8. trainer (run between phases 6 and 7): cli/train.train with in-memory
   data, 24 raw BGR frames of 480x640, 640x480 and 600x600 with boxes,
   labels, one crowd and rectangular or elliptic masks each, through the
   cv2-free SSDAugmentation on 4 loader threads, 550x550 b8, every
   bottleneck's last batch norm scaled to 0.1 and a tenth of the learning
   rate: yolact_base with --stem_s2d in f32 and in bf16 (--compute_dtype
   over f32 master weights), each 20 iterations from a weights file with
   --save_interval=10 --keep_latest, then --resume latest for 10 more and
   validation on 16 frames; yolact_plus_base bf16 (train_remat='dcn'), 10
   iterations.  Checks: every step applied and every logged loss finite;
   launches per step (stem 1; DCN sampling 22 and backward 11 for plus);
   the checkpoint left by --keep_latest; the reloaded state bit-equal to
   the one saved (weights, buffers, momentum, step); in f32 one step from
   each under deterministic algorithms on a fixed batch and draws,
   bit-equal; the resumed run starts at the saved step and its learning
   rate; the log holds train and val entries; validation prints its mAP
   table.  The second mode, --device_augment (the loader resizes with
   RawResize and ships uint8 images and bit-packed full-resolution masks,
   the step augments on the card): yolact_base --stem_s2d bf16 and
   yolact_plus_base bf16, 10 iterations each, the same checks and
   launches.  Prints per run the median ms per iteration, the loader's
   share of it, images/s, peak memory, device busy and idle share
   (profiler kernel events inside the loop's iterations), the step alone,
   the bytes each batch copies to the card, bf16 against f32, and each
   device-augment run against the host-augment run of its model
8b. device augmentation and the packed transports (run after phase 8):
   eight of phase 8's frames through RawResize, padded to 100 gts, masks
   bit-packed and the image uint8, as the device-augment loader ships
   them (their bytes printed against unpacked float transport);
   train/step.py:prepare_batch (unpack, data/device_augment.py with
   augment_random_flip on, yolact_base's proto and seg targets) on the card
   under torch.cuda.set_sync_debug_mode('error') (no host sync) and on the
   CPU with the same draws: the affine maps (crop windows, expand
   offsets), boxes, labels and counts equal, images within 1e-4, mask
   targets equal but where a float64 run of the warp, turn and resize on
   the card puts the pixel within 1e-6 of 0.5, and no target pixel beyond
   1e-6 of 0.5 on the other side of that float64 threshold; its device
   time per batch; then a yolact_base s2d f32 step (deterministic
   algorithms) on gt_masks_packed with a uint8 image and on packed
   multires targets, each with losses bit-equal to the unpacked batch's
10. data parallelism (run between phases 8 and 7): (a) two gloo ranks
   in processes of their own (spawn) share the one card (NCCL refuses two
   ranks on one device): yolact_plus_base at 550x550 with the s2d stem,
   seeded offset convs and train_remat='dcn', f32 (TF32 off) under
   deterministic algorithms, batch statistics, a global batch of 8 (4 a
   rank) through train/step.py:train_step on each rank's rows, phase 6's
   tamed weights and learning rate; TRAIN_STEPS steps against the
   one-process b8 step on the same weights, batch and draws (losses within
   1e-4 relative; the first-step gradients of conv1 and of the first DCN
   block, whose forwards differ by the moments' summation order from the
   first batch norm on, within STEM_BATCH_STATS_LIMIT of their largest
   entry, phase 9's rule under batch statistics; a control run with each
   rank's own batch-norm moments, DistributedDataParallel's, must fail
   one of the two), both ranks' weights and buffers bit-equal after
   every step (sha256), launches per rank per step stem 1, DCN sampling 22
   and dcn_col2im 11, a NaN pixel in rank 1's image skipping the step on
   both ranks; then ms per step per rank and the collectives' share of it
   (each collective timed between two synchronisations).  (b)
   cli/train.train(['--distributed', ...]) at world size 1 over NCCL:
   yolact_base --stem_s2d bf16 550 b8, 10 iterations on phase 8's frames,
   every step applied and every loss finite, the checkpoint written by
   rank 0, ms per iteration beside phase 8's one-device run.  (c)
   evaluate_dataset with n_devices=0 (every local device: one) gives
   n_devices=1's mAP table on phase 5's 16 frames.  (d) float32 means
   float32: Pipeline(yolact_base) f32 b1 built under PyTorch's default
   TF32 flags turns them off and matches phase 4's TF32-off output by its
   f32 rule, which the same pipeline with cuDNN's TF32 back on must fail
11. export (run after phase 10): yolact_plus_base 550 (the sparse cell's
   weights, seeded offsets), which launches all four forward kernels,
   exported by convert/export.py:export_inference on the card at b1 f32
   (TF32 off) and b8 bf16 (the kernels as custom ops, the NMS candidate
   branch as a torch.cond), saved as .pt2 and loaded in a fresh process
   that imports torch and the port only (EXPORT_WORKER), beside a
   Pipeline on the same weights there (taking the pruned NMS tail): the
   f32 artifact against it by phase 4's float32 rule (and TF32 off after
   its load), the bf16 one as matched sets; each kernel's launches per
   call of the artifact equal Pipeline's (the four forward kernels above
   0, dcn_col2im 0); median and p90 ms a batch of both (Pipeline,
   artifact, artifact, Pipeline), export, save and load seconds; the f32
   Pipeline of this process against the fresh one's (printed, not
   checked: cuDNN may pick other algorithms in another process); then
   each custom op's call against its bare
   ctypes launch at b1 shapes: host us a call (200 calls queued behind a
   device spin) and device ms
11b. deformable PSRoI pooling (kernels/psroi.py, plain PyTorch, no
   kernel): the card against the CPU on seeded R-FCN-sized inputs
   (PSROI): the function with and without the translation within 1e-4,
   its gradients in x and trans within 1e-4 of their largest entry, the
   module with seeded weights within 1e-4 (float32 coordinates up to 69
   px, rounded otherwise on the card); its ms a call on the card
12. spatial partitioning (parallel/mesh.py:make_mesh_2d): two spawned gloo
   ranks on cuda:0 split data 1 x space 2, each holding its rows of every
   map of the same 8 images. (a) yolact_plus_base 550 f32, s2d stem,
   train_remat 'dcn', batch statistics, phase 10's weights, batch and
   seeds: one step (SP_CHECKED_STEPS) against phase 10's first
   one-process b8 step (losses within 1e-4 relative, first gradients
   within STEM_BATCH_STATS_LIMIT of their max, launches per rank per step
   equal to one process's), the two
   ranks' weights bit-equal after each step; a control that must fail
   the gradient check (the head outputs gathered with the gradient summed
   over the ranks, the other transpose); ms a step a rank, the
   collectives' count and share of one more step in which each is timed,
   peak memory allocated per rank against one process's, and against one
   process's with its batch norms on the ranks' global-moment path. (b) Pipeline(yolact_plus_base) under the mesh
   on the raw frames, b1 f32 (phase 4's rule) and b8 bf16 (matched sets)
   against Pipeline in this process, every rank's detections bit-equal,
   launches a call equal. (c) the DCN sampling and dcn_col2im on rank 1's
   output rows (row0 > 0) at the five DCN shapes, f32 and bf16 b8: the
   columns bit-equal to the plain version and to the whole call's rows,
   the backward within phase 3's tolerances of its plain version and of
   the whole call
12b. spatial partitioning of every other config (run after phase 12):
   the same two ranks' set-up for yolact_darknet53, yolact_vgg16,
   yolact_base_gn, yolact_base_direct and yolact_base_options at 550 and
   full width (the ResNets with the s2d stem): (a) one f32 b8 step with
   batch statistics from phase 10's seeds and schedule against the
   one-process step, with native convolutions on both sides (cuDNN
   picks its algorithm by shape, and its weight gradients on a rank's
   row windows round otherwise), (losses within 1e-4 relative; first
   gradients as
   accurate as one process's: within twice the one-process float32
   step's distance from its float64 step, plus 1e-3 of their max, of that
   float64 step; the ranks' weights bit-equal, launches per rank per step
   equal), two controls that must fail the gradient check (group norm's moments over
   a rank's own rows; the prototype features gathered with the loss's
   gradient); then with cuDNN, ms a step a rank and its peak memory
   against one process's, the collectives' count and share in one more; (b) Pipeline under the mesh at b1
   f32 and b8 bf16 against Pipeline, as in phase 12
13. the horizon tools (yolact_tpu_torch/scripts/, run after phase 12b):
   yolact_plus_resnet50_horizon at 550 b8 bf16 through cli/train.train
   with train_horizon's flags and its 64 in-memory synthetic images (host
   augmentation on 4 loader threads), from the trainer's seeded random
   weights: 20 iterations ending in a checkpoint, then --resume latest to
   40; every step applied and every logged loss finite, launches per step
   (DCN sampling 26, dcn_col2im 13), the second segment starting at step
   20 at learning_rate(cfg, 20) from a state bit-equal to the first
   segment's final state (weights and buffers, momentum, step); ms per
   iteration and peak memory; the loss letters per 200 iterations beside
   the JAX run's committed log; train_horizon's --eval of the final
   checkpoint with the kernels, then map_ab's seven rows on it (CLEAN:
   the nms_candidates rows equal, the kernel row equal to the plain row
   and to the --eval); flops of yolact_base and yolact_plus_base at b1
   and b8 inference and of their b8 train step
7. timing: median and p90 ms per batch at b1 / b8 bf16 for every path
   (CUDA events over 100 calls; the s2d A/B in the order plain, s2d, s2d,
   plain), device busy and idle share per batch (torch.profiler kernel
   events) with the top kernels, yolact_plus_base's DCN sampling and GEMM
   kernels per batch, the 11 DCN blocks at their shapes (sampling, GEMM
   against one on per-image [Cin*9, Ho*Wo] columns and a cuDNN 3x3 conv,
   the block's tail on channels_last against NCHW), and each kernel's
   device time against its plain version, its bound and, for the stem,
   cuDNN's convs (the IoU max and mask assembly at b8 and b1; the stem
   also in f32 at b8, against cuDNN's f32 convs with TF32 off, its bound
   as three TF32 products beside the bound as FMAs); dcn_col2im at the
   five shapes in f32 and bf16 with its global reductions

Each phase prints its seconds, and the end of the run all of them; the
run order is 1, 2, 3, 4, 4b, 9, 5, 6, 8, 8b, 10, 11, 11b, 12, 12b, 13, 7.
The line before the last is a JSON object with each kernel's launches
(and, as trainer_launches, its launches in the trainer's runs, as
device_augment_launches_per_step per step of phase 8's device-augment
runs by run, as
option_launches in phase 9's runs by path, and as
dp_launches_per_rank_step per rank in a step of phase 10's two-rank
run, as spatial_launches_per_rank_step per rank in a step of phase 12's
run, as spatial_config_launches per config of phase 12b per rank per step
and per call, as export_launches per call of phase 11's artifacts by run,
as a14_launches per phase-4b registered config on its b1 f32 inference
path and per train step, as horizon_launches_per_step per step of phase
13's training), error,
times and bound; the last line is {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from yolact_tpu_torch import MEANS, STD, get_config
from yolact_tpu_torch.cli import train as train_cli
from yolact_tpu_torch.config import (RESNET101_GN_BACKBONE, MaskType,
                                     register_config)
from yolact_tpu_torch.data import device_augment as device_augment_module
from yolact_tpu_torch.data.augmentations import RawResize, SSDAugmentation
from yolact_tpu_torch.data.coco import pack_batch_masks, pad_batch
from yolact_tpu_torch.detect import detection
from yolact_tpu_torch.cli import coco_eval as coco_eval_cli
from yolact_tpu_torch.data import rle as rle_codec
from yolact_tpu_torch.detect.postprocess import (finish_masks,
                                                 finish_masks_direct,
                                                 upsample_masks_device)
from yolact_tpu_torch.eval import device_metrics, evaluate, evaluator, video
from yolact_tpu_torch.eval.coco_json import inverse_label_map
from yolact_tpu_torch.eval.evaluate import evaluate_dataset
from yolact_tpu_torch.infer import (InferenceOutput, Pipeline,
                                    forward_and_detect, load_model,
                                    maybe_enable_stem_s2d, preprocess_device,
                                    random_state_dict)
from yolact_tpu_torch.convert.export import export_inference
from yolact_tpu_torch.kernels import (_build, dcn, mask_assembly, nms, psroi,
                                      stem)
from yolact_tpu_torch.models.layers import BatchNorm2d, drop_batch_stats
from yolact_tpu_torch.models.resnet import DCNLayer
from yolact_tpu_torch.models.yolact import Yolact
from yolact_tpu_torch.ops.anchors import proto_size, seg_size
from yolact_tpu_torch.ops.bits import pack_bits_last, unpack_bits_last
from yolact_tpu_torch.ops.resize import _weights as resize_weights
from yolact_tpu_torch.ops.resize import resize_bilinear_np
from yolact_tpu_torch.parallel.mesh import own
from yolact_tpu_torch.train import checkpoint, step as step_module
from yolact_tpu_torch.train.loss import multibox_loss
from yolact_tpu_torch.train.matcher import match as match_priors
from yolact_tpu_torch.train.schedule import learning_rate
from yolact_tpu_torch.train.step import (batch_to_device, create_train_state,
                                         draw_priorities, loss_and_grads,
                                         prepare_batch, train_step)

REPO = os.path.dirname(os.path.abspath(__file__))
# Each kernel with the path whose launches the kernels line reports.
KERNELS = {
    # bit-equal: `iou_max <= nms_thresh` decisions depend on the last bit
    'fast_nms_iou_max': dict(
        source='yolact_tpu_torch/csrc/fast_nms_iou.cu', module=nms,
        replaces='yolact_tpu/kernels/nms_pallas.py:23', tol=0.0,
        path='yolact_base'),
    # within 1e-5, the same zero pattern and NaNs: the kernel sums the
    # Md products on the tensor cores in split TF32 (~2^-21 relative per
    # product, another order than the plain float32 sum)
    'mask_assembly': dict(
        source='yolact_tpu_torch/csrc/mask_assembly.cu', module=mask_assembly,
        replaces='yolact_tpu/kernels/mask_assembly.py:24', tol=1e-5,
        path='yolact_base'),
    # the columns bit-equal to the plain version, NaNs included
    'dcn': dict(
        source='yolact_tpu_torch/csrc/dcn_im2col.cu', module=dcn,
        replaces='scripts/bench_gather2.py:174,239,268; '
                 'scripts/probe_sameshape_gather.py:49 (the gather of '
                 'yolact_tpu/kernels/dcn.py:155 _bilinear_gather)',
        tol=1e-5, path='yolact_plus_base'),
    # f32 within 1e-5 of max|out| (TF32 off; cuDNN may sum the 192 products
    # in another order); bf16 within one bf16 ulp of |plain| plus 1e-5 of
    # max|plain| (the tensor cores sum the exact products in another order
    # than the float32 conv rounded once; the absolute term covers outputs
    # near zero after cancellation)
    'stem_s2d': dict(
        source='yolact_tpu_torch/csrc/stem_s2d.cu', module=stem,
        replaces='yolact_tpu/kernels/stem.py:52', tol=1e-5,
        path='yolact_base_s2d'),
    # float32: the three gradients within 1e-5 of each one's largest entry
    # (float32 sums over the channels, atomics in another order from run to
    # run); bfloat16: within one bf16 ulp + 1e-2 of it (the plain version
    # multiplies, sums and scatters in bfloat16)
    'dcn_col2im': dict(
        source='yolact_tpu_torch/csrc/dcn_col2im.cu', module=dcn,
        counter='col2im_launches',
        replaces='yolact_tpu/kernels/dcn.py:176 (_bilinear_gather_bwd and '
                 'the mask product\'s VJP: the JAX package\'s hand-written '
                 'XLA backward, not a Pallas kernel)',
        tol=1e-5, path='train_yolact_plus_base'),
}
# The paths driven, each with its config, its conf-head cells (name,
# scale, background bias, the NMS tail it must take; see shape_conf) and
# its kernels.  Pipeline takes the space-to-depth stem for raw frames, as
# JAX's does: yolact_base_s2d is Pipeline(yolact_base), and yolact_base
# is the same weights through the plain 7x7/s2 stem (load_model and
# forward_and_detect, PlainStemPipeline).
PATHS = {
    'yolact_base': dict(
        config='yolact_base', plain_stem=True,
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.0, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly')),
    'yolact_base_s2d': dict(
        config='yolact_base',
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.0, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly', 'stem_s2d')),
    'yolact_plus_base': dict(
        config='yolact_plus_base',
        cells=(('dense', 3.0, 0.0, 'full'), ('sparse', 3.0, 7.75, 'pruned')),
        kernels=('fast_nms_iou_max', 'mask_assembly', 'dcn', 'stem_s2d')),
    # phase 4b, the other backbones: the sparse cell only, each scale and
    # bias chosen with probe_cells.py on these seeded weights and frames so
    # that tens to hundreds of priors per image pass conf_thresh in float32
    # and bfloat16 (DarkNet's count falls off a cliff just above +7.75).
    # GN's random trunk amplifies the stem's last bits most: its bf16
    # detections move as far apart under one bf16 ulp at the stem kernel's
    # share of differing outputs as under the kernel, so its bf16 match is
    # held to a limit read in the run (match_calibration).  At scale 1
    # (+12) its f32 scores move past compare()'s 1e-5 under Gaussian stem
    # noise of the f32 kernel's rms error as under the kernel; at scale 0.5
    # both stay within it (probe_cells.py on the card, PERF.md §6)
    'yolact_darknet53': dict(
        config='yolact_darknet53', cells=(('sparse', 1.0, 7.9, 'pruned'),),
        kernels=('fast_nms_iou_max', 'mask_assembly')),
    'yolact_vgg16': dict(
        config='yolact_vgg16', cells=(('sparse', 1.0, 4.0, 'pruned'),),
        kernels=('fast_nms_iou_max', 'mask_assembly')),
    'yolact_base_gn': dict(
        config='yolact_base_gn', cells=(('sparse', 0.5, 7.0, 'pruned'),),
        kernels=('fast_nms_iou_max', 'mask_assembly', 'stem_s2d'),
        calibrated_match=True),
}
# phase 9, the model options: yolact_base with direct masks, and with
# every lincomb option the reference builds together (OPTIONS); b8 bf16
# and b1 f32, the sparse cell (its scale and bias from probe_cells.py on
# these seeded weights and frames)
OPTION_RUNS = (('b8 bf16', 'bfloat16', 8), ('b1 f32', 'float32', 1))
PATHS.update({
    'yolact_base_direct': dict(
        config='yolact_base_direct', cells=(('sparse', 3.0, 9.5, 'pruned'),),
        runs=OPTION_RUNS, kernels=('fast_nms_iou_max', 'stem_s2d')),
    'yolact_base_options': dict(
        config='yolact_base_options', cells=(('sparse', 1.0, 4.0, 'pruned'),),
        runs=OPTION_RUNS,
        kernels=('fast_nms_iou_max', 'mask_assembly', 'stem_s2d')),
})
# the phase-4b paths, after the phase-4 ones in PATHS; then phase 9's
OTHER_BACKBONES = ('yolact_darknet53', 'yolact_vgg16', 'yolact_base_gn')
OPTION_PATHS = ('yolact_base_direct', 'yolact_base_options')
PAD1 = (('padding', 1),)
# Every lincomb option of the reference that builds with the others, on
# yolact_base: 33 prototypes (32 and the bias channel; mask assembly's
# Md % 4 != 0 branch), the prototypes (without the bias) as features of
# every head, the coefficient gate, mask scoring, instance coefficients,
# DSSD's prediction module (batch statistics in the heads), YOLO
# regressors, the grid prototypes of data/grid.npy ([32, 35, 35]: the
# stride-16 level at 550, so the protonet reads P4 and its prototypes are
# 70 x 70), and an extra head net with a 'cat' of a conv and a transposed
# conv pair, then a stride-1 transposed conv.  Split prototypes by head
# needs a mask_dim the five heads divide: the CPU tests hold it.
OPTIONS = dict(
    mask_proto_bias=True, mask_proto_prototypes_as_features=True,
    mask_proto_coeff_gate=True, use_mask_scoring=True,
    use_instance_coeff=True, use_prediction_module=True,
    use_yolo_regressors=True, mask_proto_use_grid=True,
    mask_proto_grid_file='data/grid.npy', mask_proto_src=1,
    extra_head_net=(('cat', (((128, 3, PAD1),),
                             ((64, -2, (('stride', 2),)),
                              (128, 2, (('stride', 2),))))),
                    (256, -3, PAD1)))
# The 11 DCN blocks of yolact_plus_base at 550x550: (blocks, how many per
# batch, Cin = Cout, H, stride); 3x3, padding 1, dilation 1 everywhere
DCN_SHAPES = (('layers.1 block 0', 1, 128, 138, 2),
              ('layers.1 block 3', 1, 128, 69, 1),
              ('layers.2 block 0', 1, 256, 69, 2),
              ('layers.2 blocks 3-21', 7, 256, 35, 1),
              ('layers.3 block 0', 1, 512, 35, 2))
# Cin % 8 != 0: the kernel's channel-by-channel path
DCN_ODD_SHAPE = ('Cin 60', 0, 60, 35, 1)
# The card's data-sheet rates (H100 SXM at 700 W): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# rate of their type
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# dense TF32 on the tensor cores; the stem's float32 kernel does each
# product three times (split TF32: hi*hi + hi*lo + lo*hi)
TF32_TENSOR_OPS_PER_S = 494.7e12
BF16_TENSOR_OPS_PER_S = 989e12
# The s2d stem conv: yolact_base 550 at b8 bf16 and b1 and b8 f32, an odd
# shape, and (wide) float32 inputs 1 + k * 2^-15, k < 2^12, whose low bits
# only the split-TF32 product's lo halves carry
STEM_SHAPES = ((torch.bfloat16, (8, 12, 275, 275), False),
               (torch.float32, (1, 12, 275, 275), False),
               (torch.float32, (8, 12, 275, 275), False),
               (torch.bfloat16, (2, 12, 37, 41), False),
               (torch.float32, (2, 12, 37, 41), False),
               (torch.float32, (8, 12, 275, 275), True))
EVAL_FRAMES = 16
# phase 5's second set: COCO's usual image sizes (h, w), one crowd each
EVAL_SIZES = ((480, 640), (640, 480), (427, 640))


def config_named(name):
    """A registered config, or one of yolact_base's variants: 'yolact_base_gn'
    with RESNET101_GN_BACKBONE's type and args (the repo registers no GN
    model config), 'yolact_base_direct' with direct masks (mask_size 16),
    'yolact_base_options' with OPTIONS."""
    if name == 'yolact_base_direct':
        return get_config('yolact_base').copy(name=name,
                                              mask_type=MaskType.DIRECT)
    if name == 'yolact_base_options':
        return get_config('yolact_base').copy(name=name, **OPTIONS)
    if name != 'yolact_base_gn':
        return get_config(name)
    cfg = get_config('yolact_base')
    return cfg.copy(name=name, backbone=cfg.backbone.copy(
        name=RESNET101_GN_BACKBONE.name, path=RESNET101_GN_BACKBONE.path,
        type=RESNET101_GN_BACKBONE.type, args=RESNET101_GN_BACKBONE.args))
RUNS = 100     # timed calls per measurement: p90 has 10 samples beyond it


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def time_ms(fn, runs=RUNS, warmup=5):
    """Median and 90th percentile over `runs` of one call's device time,
    by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), float(np.percentile(times, 90))


QUEUE_CYCLES = 2 * 10 ** 7    # about 10 ms of the card's clock


def device_ms(fn, runs=50, warmup=5):
    """Device time of one call, by CUDA events around `runs` calls launched
    back to back behind a spin of QUEUE_CYCLES on the card, so that the
    host has queued them all before the first starts: the card never waits
    for the host, and short kernels read their own time, not their
    launch's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs

# ---- phase 3 inputs ------------------------------------------------------

def mask_inputs(gen, dev, b, d, hw=138, md=32, nan_row=False):
    proto = torch.rand(b, hw, hw, md, generator=gen)
    coeffs = torch.tanh(torch.randn(b, d, md, generator=gen))
    if nan_row:
        coeffs[0, 4, 1] = float('nan')                    # a NaN mask
    xy1 = torch.rand(b, d, 2, generator=gen) * 0.7
    wh = torch.rand(b, d, 2, generator=gen) * 0.5
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 0] = boxes[:, 0, [2, 3, 0, 1]]               # inverted
    boxes[:, 1] = torch.tensor([-0.3, -0.2, 1.4, 1.1])    # outside [0, 1]
    boxes[:, 2] = 0.5                                     # zero area
    boxes[:, 3] = torch.tensor([2, 3, 9, 7]) / hw          # on pixel edges
    return [t.to(dev) for t in (proto, coeffs, boxes)]


def iou_inputs(gen, dev, n, k):
    xy1 = torch.rand(n, k, 2, generator=gen) * 0.6
    wh = torch.rand(n, k, 2, generator=gen) * 0.3 + 0.02
    boxes = torch.cat([xy1, xy1 + wh], -1)
    boxes[:, 1] = boxes[:, 0]                             # IoU exactly 1
    boxes[:, 2, 2:] = boxes[:, 2, :2]                     # zero area
    boxes[:, 3] = torch.tensor([0.1, 0.1, float('inf'), float('inf')])
    boxes[:, 4] = torch.tensor([float('nan'), 0.1, 0.3, 0.3])
    return boxes.to(dev)


def near_tie_boxes(n, k, seed=0):
    """[n, k, 4] boxes whose last column's IoU max is decided between
    two earlier boxes (positions k - 3 and k - 2, both orders) with IoUs
    equal from different fractions, one float32 ulp apart, or with equal
    float32 cross products inter_a * union_b == inter_b * union_a (the
    kernel's fmaf tie test); the rest lie right of the column box, apart
    from it.  Found by a seeded search over 200,000 boxes on a 1/1024 grid."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    col = np.array([0.25, 0.25, 0.75, 0.625], f32)
    xy = rng.randint(0, 1024, (200000, 2))
    cand = (np.concatenate([xy, xy + rng.randint(1, 512, (200000, 2))], 1)
            / 1024).astype(f32)
    ix = np.minimum(cand[:, 2], col[2]) - np.maximum(cand[:, 0], col[0])
    iy = np.minimum(cand[:, 3], col[3]) - np.maximum(cand[:, 1], col[1])
    inter = np.maximum(ix, f32(0)) * np.maximum(iy, f32(0))
    area = (cand[:, 2] - cand[:, 0]) * (cand[:, 3] - cand[:, 1])
    uni = (area + (col[2] - col[0]) * (col[3] - col[1])) - inter
    ok = (inter > 0) & (uni > 0)
    cand, inter, uni = cand[ok], inter[ok], uni[ok]
    order = np.argsort(inter / uni, kind='stable')
    cand, inter, uni = cand[order], inter[order], uni[order]
    q = inter / uni
    p1, p2 = inter[1:] * uni[:-1], inter[:-1] * uni[1:]
    exact = (inter[1:].astype(np.float64) * uni[:-1]
             - inter[:-1].astype(np.float64) * uni[1:])
    pick = np.flatnonzero(((p1 == p2) & (exact != 0))
                          | ((q[1:] == q[:-1]) & (inter[1:] != inter[:-1]))
                          | (q[1:] == np.nextafter(q[:-1], f32(np.inf))))
    # k >= 3; filler boxes with x1 <= y1 <= x2 <= y2 in [0.85, 0.95]
    boxes = np.sort(rng.rand(n, k, 4).astype(f32) * f32(0.1), -1) + f32(0.85)
    for r in range(n):
        a = pick[(r // 2) * len(pick) // ((n + 1) // 2)]     # spread over q
        boxes[r, k - 3:k - 1] = cand[[a, a + 1]] if r % 2 else cand[[a + 1, a]]
        boxes[r, k - 1] = col
    return boxes


def dcn_inputs(gen, dev, b, cin, h, stride, dtype, finite=False):
    """x, offsets and mask of one DCN block.  Offsets mix, per element,
    integers, fractions of a few pixels, far out-of-bounds values (up to
    3 map sizes, both signs) and small ones; unless `finite`, some are NaN
    or infinite."""
    ho = dcn.out_size(h, 3, stride, 1, 1)
    shape = (b, 18, ho, ho)
    kind = torch.randint(0, 4, shape, generator=gen)
    offset = torch.where(
        kind == 0, torch.randint(-4, 5, shape, generator=gen).float(),
        torch.where(kind == 1, torch.randn(shape, generator=gen) * 2,
                    torch.where(kind == 2,
                                (torch.rand(shape, generator=gen) * 2 - 1)
                                * 3 * h,
                                torch.randn(shape, generator=gen) * 0.3)))
    if not finite:     # taps 0-3 of the first pixel: NaN, 0, 0, NaN samples
        nan, inf = float('nan'), float('inf')
        offset[0, :8, 0, 0] = torch.tensor(
            [nan, 0.5, 0.5, inf, -inf, 0.5, 0.5, nan])
    x = torch.randn(b, cin, h, h, generator=gen).to(dtype)
    mask = torch.rand(b, 9, ho, ho, generator=gen).to(dtype)
    return x.to(dev), offset.to(dev), mask.to(dev)


def ulps(a, b):
    """Elementwise distance in units in the last place between two bfloat16
    tensors of finite values."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (ordered(a) - ordered(b)).abs()


def bf16_ulp(t):
    """One bfloat16 ulp of |t| (8 significant bits), 0 where t is 0."""
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, 0.0, torch.ldexp(torch.ones_like(t.float()),
                                                e - 8))


def dcn_vs_plain(dev):
    """The DCN sampling kernel against its plain version at the five
    yolact_plus_base shapes; returns the largest abs error."""
    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    for dtype, batch in ((torch.bfloat16, 8), (torch.float32, 1)):
        for name, _, cin, h, stride in DCN_SHAPES + (DCN_ODD_SHAPE,):
            x, offset, mask = dcn_inputs(gen, dev, batch, cin, h, stride,
                                         dtype)
            got = dcn.dcn_columns(x, offset, mask, 3, stride)
            want = dcn.dcn_columns_plain(x, offset, mask, 3, stride)
            # a channels_last x is read as it lies: the same columns
            cl = dcn.dcn_columns(
                x.contiguous(memory_format=torch.channels_last), offset,
                mask, 3, stride)
            torch.cuda.synchronize()
            nan = want.isnan()
            same_nan = bool(torch.equal(got.isnan(), nan))
            g, w = got[~nan], want[~nan]
            err = float((g.float() - w.float()).abs().max())
            equal = same_nan and bool(torch.equal(g, w))
            tag = (f'dcn {name} {str(dtype)[6:]} b{batch} x{list(x.shape)} '
                   f'cols{list(got.shape)}')
            print(f'{tag}: max_abs_err={err!r} bit_equal={equal} '
                  f'same_nan={same_nan} nan_columns={int(nan.sum())}')
            check(equal, f'{tag}: not bit-equal to its plain version')
            check(bool(torch.equal(cl.nan_to_num(), got.nan_to_num())),
                  f'{tag}: a channels_last x gives other columns')
            worst = max(worst, err)
            del x, offset, mask, got, want, cl
    return worst


def reached_pixels(offset, h, w, stride, pad=1, dil=1):
    """[B, H, W] bool: the input pixels that a valid corner of some sample
    lands on (dcn.col2im_corners), the only ones grad_x can be non-zero at."""
    b = offset.shape[0]
    where = dcn.col2im_corners(offset, h, w, 3, stride, pad, dil)
    y0, x0 = dcn._top_left_corners(offset, h, w, 3, stride, pad, dil)
    img = torch.arange(b, device=offset.device)[:, None, None, None]
    reached = torch.zeros(b * h * w, dtype=torch.bool, device=offset.device)
    for q, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        keys = (img * h + y0 + dy) * w + x0 + dx
        reached[keys[where[..., q] > 0]] = True
    return reached.view(b, h, w)


def idle_samples(g_cols, offset, mask, c, h, w, stride, pad=1, dil=1,
                 offsets=False):
    """bool, the layout of grad_mask [B, 9, Ho, Wo] (of grad_offset
    [B, 18, Ho, Wo] with `offsets`): the samples whose gradients have only
    zero addends, because no corner of the sample lands in the map or the
    columns' gradient of the sample is 0 on every channel (and, for the
    offsets, because the mask is 0)."""
    b, _, ho, wo = offset.shape
    none = (dcn.col2im_corners(offset, h, w, 3, stride, pad, dil) == 0
            ).all(-1).permute(0, 3, 1, 2)                  # [B, 9, Ho, Wo]
    none |= (g_cols.view(b, ho, wo, 9, c) == 0).all(-1).permute(0, 3, 1, 2)
    if not offsets:
        return none
    none |= mask == 0
    return none[:, :, None].expand(b, 9, 2, ho, wo).reshape(b, 18, ho, wo)


# the roundings in one addend of a sample's offset or mask gradient before
# it is summed: 1 - fy, 1 - fx, and at most three products (wy * wx, * x,
# * g for the mask; g * m, * w, * x for the offsets)
ADDEND_ROUNDINGS = 5


def sample_order_bounds(g_cols, x, offset, mask, stride, pad=1, dil=1):
    """{'grad_mask': [B, 9, Ho, Wo], 'grad_offset': [B, 18, Ho, Wo]}
    float32: how far two float32 computations of a sample's gradient can
    differ when they sum its addends in different orders.  A sample's mask
    gradient sums n = C x (valid corners) addends g * wy * wx * x, its
    offset gradients g * m * wx * x (y) and g * m * wy * x (x); each order
    is within (n - 1 + p) 2^-24 sum |addend| of the exact sum, p =
    ADDEND_ROUNDINGS, so the two are within twice that (NaN samples left
    out)."""
    b, c, h, w = x.shape
    _, _, ho, wo = offset.shape
    dev = offset.device
    tap = torch.arange(9, device=dev)
    base_y = ((torch.arange(ho, device=dev) * stride - pad)[:, None, None]
              + tap // 3 * dil).float()
    base_x = ((torch.arange(wo, device=dev) * stride - pad)[None, :, None]
              + tap % 3 * dil).float()
    off = offset.float().view(b, 9, 2, ho, wo).permute(0, 3, 4, 1, 2)
    fy, fx = base_y + off[..., 0], base_x + off[..., 1]
    fy, fx = fy - torch.floor(fy), fx - torch.floor(fx)
    y0, x0 = dcn._top_left_corners(offset, h, w, 3, stride, pad, dil)
    xl = x.float().abs().permute(0, 2, 3, 1).reshape(b * h * w, c)
    g = g_cols.float().abs().view(b, ho, wo, 9, c)
    img = torch.arange(b, device=dev)[:, None, None, None]
    zero = torch.zeros(b, ho, wo, 9, dtype=torch.float64, device=dev)
    s_mask, s_y, s_x, n = zero.clone(), zero.clone(), zero.clone(), zero
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        keys = (img * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
        s = (g * xl[keys]).sum(-1).double() * valid      # sum_c |g x|
        wy = (fy if dy else 1 - fy).abs().double()
        wx = (fx if dx else 1 - fx).abs().double()
        s_mask += wy * wx * s
        s_y += wx * s
        s_x += wy * s
        n = n + valid * c
    scale = 2 * (n - 1 + ADDEND_ROUNDINGS) * 2.0 ** -24
    m = mask.float().abs().permute(0, 2, 3, 1).double()[..., None]
    offsets = torch.stack((s_y, s_x), -1) * m * scale[..., None]
    return {'grad_mask': (scale * s_mask).float().permute(0, 3, 1, 2),
            'grad_offset': offsets.float().reshape(b, ho, wo, 18)
            .permute(0, 3, 1, 2)}


def float64_gradients(g_cols, x, offset, mask, stride, pad=1, dil=1):
    """The plain version's gradients in float64 on the same inputs, each
    offset moved so that its sample's coordinate is the float32 one (the
    tap's base plus the offset, rounded to float32) that the kernel and the
    float32 plain version both take."""
    b, _, ho, wo = offset.shape
    dev = offset.device
    tap = torch.arange(9, device=dev)[:, None, None]
    base_y = ((torch.arange(ho, device=dev) * stride - pad)[None, :, None]
              + tap // 3 * dil).float()                     # [9, Ho, 1]
    base_x = ((torch.arange(wo, device=dev) * stride - pad)[None, None, :]
              + tap % 3 * dil).float()                      # [9, 1, Wo]
    off = offset.float().view(b, 9, 2, ho, wo)
    off64 = torch.stack(
        ((base_y + off[:, :, 0]).double() - base_y.double(),
         (base_x + off[:, :, 1]).double() - base_x.double()), 2)
    grads = dcn.dcn_col2im_plain(g_cols.double(), x.double(),
                                 off64.view(b, 18, ho, wo), mask.double(), 3,
                                 stride, pad, dil)
    return dict(zip(('grad_x', 'grad_offset', 'grad_mask'), grads))


def order_bounds(g_cols, offset, mask, h, w, stride, pad=1, dil=1):
    """[B, C, H, W] float32: how far two float32 sums of the addends
    g * m * cw that a pixel and channel of grad_x sums can differ when
    taken in different orders, 2 (n - 1) 2^-24 sum |addend| for n addends
    (recursive summation's error bound, for each of the two; NaN samples
    left out)."""
    b, _, ho, wo = offset.shape
    c = g_cols.shape[1] // 9
    dev = offset.device
    tap = torch.arange(9, device=dev)
    base_y = ((torch.arange(ho, device=dev) * stride - pad)[:, None, None]
              + tap // 3 * dil).float()
    base_x = ((torch.arange(wo, device=dev) * stride - pad)[None, :, None]
              + tap % 3 * dil).float()
    off = offset.view(b, 9, 2, ho, wo).permute(0, 3, 4, 1, 2)
    fy, fx = base_y + off[..., 0], base_x + off[..., 1]
    fy, fx = fy - torch.floor(fy), fx - torch.floor(fx)
    y0, x0 = dcn._top_left_corners(offset, h, w, 3, stride, pad, dil)
    m = mask.float().permute(0, 2, 3, 1).abs()
    g = g_cols.float().view(b, ho, wo, 9, c).abs()
    img = torch.arange(b, device=dev)[:, None, None, None]
    total = torch.zeros(b * h * w, c, dtype=torch.float64, device=dev)
    n = torch.zeros(b * h * w, dtype=torch.float64, device=dev)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        cw = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
        scale = (m * cw.abs()).nan_to_num(0, 0, 0)[valid]
        keys = ((img * h + yi) * w + xi)[valid]
        total.index_add_(0, keys, (g[valid] * scale[:, None]).double())
        n.index_add_(0, keys, torch.ones_like(keys, dtype=torch.float64))
    bound = 2 * (n[:, None] - 1).clamp(min=0) * 2.0 ** -24 * total
    return bound.float().view(b, h, w, c).permute(0, 3, 1, 2)


def col2im_check(tag, g_cols, x, offset, mask, stride, pad=1, dil=1):
    """The DCN backward kernel against autograd through the plain columns on
    one input (see KERNELS['dcn_col2im']); prints each gradient's error, the
    share of corners on the kernel's global path and the global reductions
    into grad_x (see col2im_reductions_line).  Returns the largest float32
    abs error (0.0 in bfloat16)."""
    tol = KERNELS['dcn_col2im']['tol']
    dtype = x.dtype
    got = dcn.dcn_col2im(g_cols, x, offset, mask, 3, stride, pad, dil)
    want = dcn.dcn_col2im_plain(g_cols, x, offset, mask, 3, stride, pad, dil)
    torch.cuda.synchronize()
    report, worst, cancelled = [], 0.0, ''
    bounds = exact = None     # made where a value is 0 in one order only
    for gname, g, w in zip(('grad_x', 'grad_offset', 'grad_mask'), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f'{tag}: {gname} has another shape or dtype')
        check(bool(torch.equal(g.isnan(), w.isnan())),
              f'{tag}: {gname} has other NaNs')
        ok = ~w.isnan()
        gf, wf = g[ok].float(), w[ok].float()
        top = float(wf.abs().max())
        err = float((gf - wf).abs().max())
        limit = tol * top
        if dtype == torch.bfloat16:
            # one rounding of the float32 sum against bfloat16 products,
            # sums and (grad_x) scatter-adds
            limit = bf16_ulp(wf) + 1e-2 * top
            over = int(((gf - wf).abs() > limit).sum())
        else:
            over = int(err > limit)
            if gname == 'grad_x':
                # zero exactly where no valid corner lands, in both; where
                # the plain version's addends cancel to exactly 0 on a pixel
                # they reach, the kernel's sum of them in another order
                # (the atomics' order changes from run to run, the plain
                # scatter's too) within the two orders' error bound
                idle = ~reached_pixels(offset, *x.shape[2:], stride, pad,
                                       dil)[:, None].expand_as(g)
                check(bool((g[idle] == 0).all() and (w[idle] == 0).all()),
                      f'{tag}: grad_x is not 0 where no corner lands')
                cancel = (w == 0) & ~idle
                bound = order_bounds(g_cols, offset, mask, *x.shape[2:],
                                     stride, pad, dil)[cancel]
                got0 = g[cancel].abs()
                check(bool((got0 <= bound).all()), f'{tag}: grad_x is '
                      f'further from 0 than the order of its sum explains '
                      f'where the plain version cancels to 0')
                share = float((got0 / bound)[got0 > 0].max()) if bool(
                    (got0 > 0).any()) else 0.0
                cancelled = (f'; grad_x where plain cancels to 0 at a reached '
                             f'pixel: {int(cancel.sum())} values, kernel 0 at '
                             f'{int((got0 == 0).sum())}, the others at most '
                             f'{share!r} of their order bound')
            else:
                # exactly 0 in both where every addend is 0 (no valid corner,
                # no column gradient; for the offsets also mask 0).
                # Elsewhere a sum over the channels and corners that
                # cancels may round to exactly 0 in one order and not in
                # the other: there the two within the orders' error bound
                zero = idle_samples(g_cols, offset, mask, x.shape[1],
                                    *x.shape[2:], stride, pad, dil,
                                    gname == 'grad_offset')[ok]
                check(bool((gf[zero] == 0).all() and (wf[zero] == 0).all()),
                      f'{tag}: {gname} is not 0 where every addend is')
                differ = (gf == 0) != (wf == 0)
                if bool(differ.any()):
                    bounds = bounds or sample_order_bounds(
                        g_cols, x, offset, mask, stride, pad, dil)
                    exact = exact or float64_gradients(
                        g_cols, x, offset, mask, stride, pad, dil)
                    gap = (gf - wf)[differ].abs()
                    bound = bounds[gname][ok][differ]
                    ref = exact[gname][ok][differ]
                    kernel_off = (gf[differ].double() - ref).abs()
                    plain_off = (wf[differ].double() - ref).abs()
                    check(bool((gap <= bound).all()), f'{tag}: {gname} is 0 '
                          f'in one order only further from the other than '
                          f'the order of its sum explains')
                    cancelled = (
                        f'; {int(differ.sum())} values 0 in one order only, '
                        f'at most {float((gap / bound).max())!r} of their '
                        f'order bound; nearer the float64 gradient: kernel '
                        f'at {int((kernel_off < plain_off).sum())}, plain '
                        f'version at {int((plain_off < kernel_off).sum())}')
            worst = max(worst, err)
        report.append(f'{gname} max_abs_err={err!r} rel_to_max={err / top!r} '
                      f'nans={int((~ok).sum())}' + cancelled)
        cancelled = ''
        check(over == 0, f'{tag}: {gname} disagrees with the plain version '
              f'({report[-1]})')
    print(f'{tag}: ' + '; '.join(report) + '; '
          + col2im_reductions_line(x, offset, stride, pad, dil))
    if dtype == torch.bfloat16:
        # which of the two is nearer the float32 gradients of the same
        # bfloat16 inputs
        ref = dcn.dcn_col2im_plain(g_cols.float(), x.float(), offset,
                                   mask.float(), 3, stride, pad, dil)
        ok = ~ref[0].isnan()
        top = float(ref[0][ok].abs().max())
        print(f'{tag}: grad_x against float32 autograd on the same inputs, '
              f'of its max: kernel '
              f'{float((got[0].float() - ref[0])[ok].abs().max()) / top!r}, '
              f'plain version '
              f'{float((want[0].float() - ref[0])[ok].abs().max()) / top!r}')
    return worst


def col2im_reductions_line(x, offset, stride, pad=1, dil=1):
    """The global reductions into grad_x of one call, reckoned from the
    offsets and the kernel's geometry (dcn.col2im_reductions): a kernel
    with one float32 atomicAdd per valid corner and channel (the design
    before the tiled one) beside the tiled kernel's 16-byte window
    flushes and global-path reductions, and the global path's share of
    the corners."""
    c, h, w = x.shape[1:]
    r = dcn.col2im_reductions(offset, c, h, w, 3, stride, pad, dil,
                              dcn.col2im_vec(c, x.element_size(), x))
    return (f'global reductions into grad_x: per corner and channel '
            f'{r["scalar"]}, tiled {r["window_v4"] + r["fallback"]} '
            f'({r["window_v4"]} window flushes + {r["fallback"]} on the global '
            f'path); global-path share of the corners '
            f'{r["fallback_share"]!r}')


def far_offsets(gen, b, ho, h):
    """[b, 18, ho, ho] offsets of 10 to h / 2 pixels, either sign: beyond
    the window's halo (dcn.col2im_geometry), so many corners that stay in the
    map take the kernel's global path."""
    shape = (b, 18, ho, ho)
    size = 10 + torch.rand(shape, generator=gen) * max(h / 2 - 10, 1)
    sign = torch.randint(0, 2, shape, generator=gen) * 2 - 1
    return size * sign


def col2im_vs_plain(dev):
    """The DCN backward kernel against autograd through the plain columns
    at the five yolact_plus_base shapes and one with Cin % 8 != 0, with
    integer, fractional, far out-of-bounds and non-finite offsets, in bf16
    at b8 and in f32 at b1 and b8 (the train step's call); then offsets far
    outside any window at two shapes.  Returns the largest float32 abs
    error at the yolact_plus_base shapes."""
    gen = torch.Generator().manual_seed(8)
    worst = 0.0
    for dtype, batch in ((torch.bfloat16, 8), (torch.float32, 1),
                         (torch.float32, 8)):
        for name, count, cin, h, stride in DCN_SHAPES + (DCN_ODD_SHAPE,):
            x, offset, mask = dcn_inputs(gen, dev, batch, cin, h, stride,
                                         dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            ho = offset.shape[-1]
            g_cols = torch.randn(batch * ho * ho, 9 * cin, generator=gen)\
                .to(dtype).to(dev)
            err = col2im_check(
                f'dcn_col2im {name} {str(dtype)[6:]} b{batch} '
                f'x{list(x.shape)} g_cols{list(g_cols.shape)}',
                g_cols, x, offset, mask, stride)
            if count:
                worst = max(worst, err)
            del x, offset, mask, g_cols
    for dtype in (torch.float32, torch.bfloat16):
        for name, count, cin, h, stride in (DCN_SHAPES[0], DCN_SHAPES[3]):
            x, _, mask = dcn_inputs(gen, dev, 8, cin, h, stride, dtype)
            ho = mask.shape[-1]
            offset = far_offsets(gen, 8, ho, h).to(dev)
            g_cols = torch.randn(8 * ho * ho, 9 * cin, generator=gen)\
                .to(dtype).to(dev)
            err = col2im_check(
                f'dcn_col2im {name} {str(dtype)[6:]} b8 far offsets '
                f'x{list(x.shape)}', g_cols, x, offset, mask, stride)
            worst = max(worst, err)
            del x, offset, mask, g_cols
    return worst


@contextlib.contextmanager
def capture_col2im():
    """Records the inputs of every dcn_col2im kernel launch in the block, as
    the dcn_columns op's backward passes them (g_cols, NHWC x, offsets, mask,
    geometry), in a list."""
    captured = []
    launch = dcn._launch_col2im

    def record(g_cols, xh, offset, mask, dims):
        captured.append((g_cols.clone(), xh.clone(), offset.clone(),
                         mask.clone(), dims))
        return launch(g_cols, xh, offset, mask, dims)

    dcn._launch_col2im = record
    try:
        yield captured
    finally:
        dcn._launch_col2im = launch


def col2im_in_step(captured, card):
    """The DCN backward kernel on the inputs one train step gave it: held
    against its plain version, then timed alone per block (torch.profiler
    kernel events, 20 calls) with the global reductions; returns the
    kernel's ms summed over the step's launches."""
    total = 0.0
    reductions = collections.Counter()
    for i, (g_cols, xh, offset, mask, dims) in enumerate(captured):
        _, c, h, w, _, _, k, stride, pad, dil, row0 = dims
        check(row0 == 0, f'one process launched dcn_col2im from row {row0}')
        x = xh.permute(0, 3, 1, 2)
        r = dcn.col2im_reductions(offset, c, h, w, k, stride, pad, dil,
                                  dcn.col2im_vec(c, x.element_size(), x))
        reductions.update(scalar=r['scalar'], tiled=r['window_v4']
                          + r['fallback'], corners=r['scalar'] // c,
                          global_path=round(r['fallback_share']
                                            * r['scalar'] / c))
        tag = (f'dcn_col2im in-step launch {i} {str(x.dtype)[6:]} '
               f'x{list(x.shape)} stride {stride}')
        col2im_check(tag, g_cols, x, offset, mask, stride, pad, dil)
        q = torch.quantile(offset.abs().flatten()[:1 << 24].float(),
                           torch.tensor([0.5, 0.9, 0.99], device=x.device))
        ms = device_times(lambda: dcn.dcn_col2im(g_cols, x, offset, mask, k,
                                                 stride, pad, dil),
                          'dcn_col2im_kernel')[1]
        total += ms
        print(f'{tag}: kernel alone {ms!r} ms (torch.profiler kernel events, '
              f'20 calls); |offset| median, p90, p99 '
              f'{[float(v) for v in q]} [{card}]')
    print(f'dcn_col2im alone on one step\'s {len(captured)} in-step inputs: '
          f'{total!r} ms; global reductions into grad_x per step: per corner '
          f'and channel {reductions["scalar"]}, tiled {reductions["tiled"]}; '
          f'global-path share of the corners '
          f'{reductions["global_path"] / max(reductions["corners"], 1)!r} '
          f'[{card}]')
    return total


def stem_grads_vs_plain(dev):
    """The stem's autograd.Function (kernel forward, conv-gradient
    backward) against autograd through the plain stem at the yolact_base b8
    shape in float32: within 1e-5 of each gradient's largest entry."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(8, 12, 275, 275, generator=gen).to(dev)
    w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dev)
    g = torch.randn(8, 64, 275, 275, generator=gen).to(dev)
    grads = {}
    for name, fn in (('kernel', stem.stem_conv_s2d),
                     ('plain', stem.stem_conv_s2d_plain)):
        a, b = x.clone().requires_grad_(), w2.clone().requires_grad_()
        out = fn(a, b)
        check(out.requires_grad, f'stem {name}: the output is detached')
        (out * g).sum().backward()
        grads[name] = (a.grad, b.grad)
    torch.cuda.synchronize()
    for gname, got, want in zip(('grad_x', 'grad_w2'), *grads.values()):
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        print(f'stem_s2d autograd x[8,12,275,275] f32 {gname}: '
              f'max_abs_err={err!r} rel_to_max={err / top!r}')
        check(err <= 1e-5 * top, f'stem {gname} disagrees with autograd '
              f'through the plain stem')


def stem_vs_plain(dev):
    """The s2d stem kernel against its plain version (float32 conv by cuDNN,
    TF32 off, rounded once) at STEM_SHAPES; also prints both against a
    float64 conv.  Returns the largest abs error."""
    gen = torch.Generator().manual_seed(4)
    worst = 0.0
    for dtype, shape, wide in STEM_SHAPES:
        x = (1 + torch.randint(0, 1 << 12, shape, generator=gen).float()
             * 2.0 ** -15 if wide else torch.randn(shape, generator=gen))
        x = x.to(dtype).to(dev)
        w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dtype).to(dev)
        got = stem.stem_conv_s2d(x, w2)
        want = stem.stem_conv_s2d_plain(x, w2)
        exact = F.conv2d(F.pad(x.double(), (2, 1, 2, 1)), w2.double())
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        err = float(diff.max())
        rel = err / top
        tag = (f'stem_s2d {str(dtype)[6:]} x{list(shape)}'
               f'{" 1+k*2^-15" if wide else ""}: max_abs_err={err!r} '
               f'rel_to_max={rel!r} vs_float64: kernel '
               f'{float((got.double() - exact).abs().max())!r} plain '
               f'{float((want.double() - exact).abs().max())!r}')
        if dtype == torch.float32:
            print(tag)
            check(rel <= KERNELS['stem_s2d']['tol'],
                  f'{tag}: disagrees with its plain version')
        else:
            big = want.float().abs() >= 1e-3 * top
            over = diff > bf16_ulp(want) + KERNELS['stem_s2d']['tol'] * top
            print(f'{tag} bit_equal_share='
                  f'{float((got == want).float().mean())!r} '
                  f'max_ulps_where_|plain|>=1e-3max='
                  f'{int(ulps(got, want)[big].max())} beyond_criterion='
                  f'{int(over.sum())}')
            check(not bool(over.any()),
                  f'{tag}: beyond one bf16 ulp + 1e-5 max|plain|')
        worst = max(worst, err)
        del x, w2, got, want, exact
    return worst


def kernel_vs_plain(dev):
    """Each kernel against its plain version; returns the max abs error at
    the main-path shapes per kernel."""
    gen = torch.Generator().manual_seed(0)
    errs = {}
    # (B, D, Hp, Md, NaN coefficient row): b8 and b1 at yolact_base, a
    # ragged D, a NaN row; b8, b1 and a ragged D at phase 9's options path
    # (70 x 70 prototypes, Md 33: the copy branch for Md % 4 != 0)
    for b, d, hw, md, nan_row in (
            (8, 100, 138, 32, False), (1, 100, 138, 32, False),
            (2, 37, 138, 32, False), (2, 100, 138, 32, True),
            (8, 100, 70, 33, False), (1, 100, 70, 33, False),
            (2, 37, 70, 33, False)):
        args = mask_inputs(gen, dev, b, d, hw=hw, md=md, nan_row=nan_row)
        got = mask_assembly.assemble_masks(*args)
        want = mask_assembly.assemble_masks_plain(*args)
        torch.cuda.synchronize()
        nan = want.isnan()
        same_nan = bool(torch.equal(got.isnan(), nan))
        err = float((got - want)[~nan].abs().max())
        same_crop = bool(torch.equal(got == 0, want == 0))
        print(f'mask_assembly B={b} D={d} {hw}x{hw} Md={md}'
              f'{" NaN row" if nan_row else ""}: max_abs_err={err!r} '
              f'same_crop={same_crop} same_nan={same_nan} '
              f'nan_outputs={int(nan.sum())}')
        check(err <= KERNELS['mask_assembly']['tol'] and same_crop
              and same_nan, f'mask_assembly disagrees with its plain '
              f'version (B={b}, D={d}, NaN row {nan_row})')
        errs['mask_assembly'] = max(errs.get('mask_assembly', 0.0), err)
    print(f'mask_assembly max abs error over all shapes: '
          f'{errs["mask_assembly"]!r}')
    identical = torch.rand(8, 1, 4, generator=gen).sort(-1).values\
        .expand(8, 200, 4).contiguous()
    cases = (('b8', iou_inputs(gen, dev, 8 * 80, 200)),
             ('b1', iou_inputs(gen, dev, 80, 200)),
             ('b8 K=37', iou_inputs(gen, dev, 8 * 80, 37)),
             ('b1 near ties', torch.from_numpy(near_tie_boxes(80, 200))
              .to(dev)),
             ('identical boxes', identical.to(dev)))
    for tag, boxes in cases:
        got = nms.nms_iou_max(boxes)
        want = nms.nms_iou_max_plain(boxes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = bool(torch.equal(got, want))
        print(f'fast_nms_iou_max {tag} {list(boxes.shape)}: '
              f'max_abs_err={err!r} bit_equal={equal}')
        check(equal, f'fast_nms_iou_max is not bit-equal to its plain '
              f'version ({tag})')
        errs['fast_nms_iou_max'] = max(errs.get('fast_nms_iou_max', 0.0),
                                       err)
    errs['dcn'] = dcn_vs_plain(dev)
    errs['stem_s2d'] = stem_vs_plain(dev)
    errs['dcn_col2im'] = col2im_vs_plain(dev)
    stem_grads_vs_plain(dev)
    return errs


# ---- phase 4: the main path ---------------------------------------------

def shape_conf(sd, num_classes, scale, bg_bias):
    """Scale the random conf head and add `bg_bias` to its background
    logit.  Xavier-random weights leave the 81-way softmax nearly flat
    (logit std 0.47 at yolact_base), so no prior passes conf_thresh=0.05;
    a head scaled by 3 gives peaked scores like a trained one: ~18,400 of
    the 19,248 yolact_base priors pass (the unpruned NMS fallback), and a
    background bias of +7 on top leaves a few hundred (the pruned tail),
    of which tens per image survive NMS.  yolact_plus_base has three times
    the priors and needs +7.75 to stay under nms_candidates=1024.
    bench.py's +-8 bias alone would leave none here.  Every head is
    shaped: yolact_vgg16 has one per level."""
    sd = dict(sd)
    for w in [k for k in sd if k.endswith('.conf_layer.weight')]:
        b = w[:-len('weight')] + 'bias'
        sd[w] = sd[w] * scale
        bias = (sd[b] * scale).view(-1, num_classes)
        bias[:, 0] += bg_bias
        sd[b] = bias.view(-1)
    return sd


def shape_masks(sd, bias=1.0):
    """Add `bias` to every lincomb coefficient (the mask heads' bias): the
    random coefficients then lean positive over the non-negative
    prototypes, so an assembled mask is above 0.5 over much of its box,
    as a trained model's is over its object.  Random heads leave many
    masks empty, and a drawn frame would not show them."""
    return {k: v + bias if k.endswith('.mask_layer.bias') else v
            for k, v in sd.items()}


def seed_offsets_state_dict(sd, gen, w_scale=0.05, b_scale=2.0):
    """Seeded non-zero weights for every DCN offset/mask conv: the zero
    init would put every sample on a grid point and leave the kernel's
    bilinear and out-of-bounds paths unused."""
    sd = dict(sd)
    for key in [k for k in sd if 'conv_offset_mask' in k]:
        scale = w_scale if key.endswith('weight') else b_scale
        sd[key] = torch.randn(sd[key].shape, generator=gen) * scale
    return sd


def reset_launches():
    for info in KERNELS.values():
        setattr(info['module'], info.get('counter', 'launches'), 0)


def read_launches(names):
    return {name: getattr(KERNELS[name]['module'],
                          KERNELS[name].get('counter', 'launches'))
            for name in names}


def check_output(tag, out, cfg, batch):
    d = cfg.max_num_detections
    check(tuple(out.boxes.shape) == (batch, d, 4),
          f'{tag}: boxes shape {tuple(out.boxes.shape)}')
    hw = (cfg.mask_size,) * 2 if cfg.mask_type == MaskType.DIRECT \
        else proto_size(cfg)
    check(tuple(out.masks.shape) == (batch, d) + hw,
          f'{tag}: masks shape {tuple(out.masks.shape)}')
    names = ['boxes', 'scores', 'masks']
    if cfg.use_maskiou:
        check(out.mask_scores is not None and
              tuple(out.mask_scores.shape) == (batch, d),
              f'{tag}: no [{batch}, {d}] mask_scores')
        names.append('mask_scores')
    for name in names:
        check(bool(torch.isfinite(getattr(out, name)).all()),
              f'{tag}: non-finite {name}')


TOL = {'scores': 1e-5, 'boxes': 1e-5, 'masks': 1e-4, 'mask_scores': 1e-4}


def tie_slots(scores, tol):
    """[B, D] bool: detections whose score lies within `tol` of another
    detection's of the same image, where a summation order can swap ranks."""
    gap = (scores[:, :, None] - scores[:, None, :]).abs()
    gap.diagonal(dim1=1, dim2=2).fill_(float('inf'))
    return gap.amin(dim=2) <= tol


def compare(tag, got, want, exact, tol=TOL, ties_ok=False):
    """One path against another on the same inputs.  Returns the number of
    entries whose validity or class differ.  `exact` wants none;
    `ties_ok` allows them where the ranking has a near tie (scores within
    the score tolerance), prints the ties, holds the score sequences
    slot by slot and the other fields off the tied slots."""
    diff = (got.valid != want.valid) | (got.classes != want.classes)
    n_diff = int(diff.sum())
    skip = torch.zeros_like(diff)
    if ties_ok:
        skip = (tie_slots(got.scores, tol['scores'])
                | tie_slots(want.scores, tol['scores'])) & \
            (got.valid | want.valid)
    both = got.valid & want.valid & ~diff & ~skip
    names = ['scores', 'boxes', 'masks'] + (
        ['mask_scores'] if got.mask_scores is not None else [])
    errs = {name: float((getattr(got, name) - getattr(want, name))[both]
                        .abs().max()) if bool(both.any()) else 0.0
            for name in names}
    print(f'{tag}: valid={int(got.valid.sum())} valid_or_class_diffs={n_diff} '
          + ' '.join(f'{n}_err={e!r}' for n, e in errs.items()))
    if ties_ok and bool(skip.any()):
        either = got.valid | want.valid
        seq = float((got.scores - want.scores)[either].abs().max())
        print(f'{tag}: {int(skip.sum())} detections in near ties (score gap '
              f'<= {tol["scores"]!r}), {int((diff & ~skip).sum())} differing '
              f'outside them; score sequences differ by {seq!r}')
        check(seq <= tol['scores'], f'{tag}: score sequences differ')
    if exact:
        check(not bool((diff & ~skip).any()),
              f'{tag}: valid sets or classes differ')
    check(all(e <= tol[n] for n, e in errs.items()),
          f'{tag}: the two paths differ beyond tolerance')
    return n_diff


def match(tag, got, want, tol=2e-2, least=0.75):
    """Two different computations of the same detections in bf16 (the 7x7
    stem by cuDNN and the s2d stem kernel): their roundings pass through the
    bf16 trunk, move scores by up to ~1e-2 and reorder near ties, so
    detections are matched as sets.  At least `least` of the valid
    detections of each side must have one on the other of the same image
    and class, with score and box coordinates within `tol` (a wrong layout
    or weight matches next to none; the f32 comparison holds precision).
    Prints the shares at other tolerances too; returns the smaller share at
    `tol`."""
    def rate(a, b, t):
        ok = ((a.classes[:, :, None] == b.classes[:, None, :])
              & a.valid[:, :, None] & b.valid[:, None, :]
              & ((a.scores[:, :, None] - b.scores[:, None, :]).abs() <= t)
              & ((a.boxes[:, :, None] - b.boxes[:, None, :]).abs()
                 .amax(-1) <= t))
        return float(ok.any(dim=2).sum()) / max(1, int(a.valid.sum()))
    rates = {t: (rate(got, want, t), rate(want, got, t))
             for t in (5e-3, tol, 5e-2)}
    print(f'{tag}: valid {int(got.valid.sum())} / {int(want.valid.sum())}, '
          'matched as sets: ' + ', '.join(
              f'{r[0]!r} / {r[1]!r} within {t!r}' for t, r in rates.items()))
    check(min(rates[tol]) >= least, f'{tag}: detections do not match')
    return min(rates[tol])


# A calibrated matched-set limit (PATHS' calibrated_match) lies this far
# under the plain path's share with stem noise of the kernel's size: two
# draws of the same noise over ~800 detections differ by about 2 sqrt(p (1
# - p) / 800) ~ 0.03 in share
MATCH_MARGIN = 0.05

def ulp_noise(density, seed=1):
    """The plain stem with one bf16 ulp added or taken at `density` of its
    outputs (seeded)."""
    plain = stem.stem_conv_s2d_plain

    def conv(x, w2):
        out = plain(x, w2)
        g = torch.Generator(device=out.device).manual_seed(seed)
        pick = torch.rand(out.shape, generator=g, device=out.device) < density
        sign = torch.rand(out.shape, generator=g, device=out.device) < 0.5
        ulp = bf16_ulp(out)
        moved = (out.float() + torch.where(sign, ulp, -ulp)).to(out.dtype)
        return torch.where(pick, moved, out)
    return conv


def match_calibration(tag, name, wsd, frames, dev, want):
    """The limit of a bf16 matched-set check, read in this run on the
    path's own inputs: the share (match) of the plain path with its stem
    output one bf16 ulp off at the share of outputs where the stem kernel
    differs from the plain stem on this stem input (the kernel is within one
    ulp plus 1e-5 of the largest output there, as in phase 3), against the
    plain path `want`, less
    MATCH_MARGIN, and at most match()'s 0.75.  The fault the check is for
    must fall below the limit: the plain path with its stem's 4x4 taps read
    in mirrored order (a layout fault of the s2d kernel)."""
    pipe = make_pipeline(name, wsd, dev, 'bfloat16', use_kernels=False)
    record = []
    with plain_stem_as(recording_stem(record)):
        pipe(frames)
    x, w2 = record
    plain_out = stem.stem_conv_s2d_plain(x, w2)
    kernel_out = stem.stem_conv_s2d(x, w2)
    torch.cuda.synchronize()
    gap = (kernel_out.float() - plain_out.float()).abs()
    top = float(plain_out.float().abs().max())
    check(bool((gap <= bf16_ulp(plain_out) + 1e-5 * top).all()),
          f'{tag}: the stem kernel is further from the plain stem on this '
          f'input than phase 3 admits')
    density = float((gap > 0).float().mean())
    print(f'{tag} calibration: the stem kernel differs from the plain stem '
          f'at {density!r} of the {plain_out.numel()} stem outputs '
          f'x{list(plain_out.shape)}, by at most '
          f'{float((gap / bf16_ulp(plain_out)).nan_to_num(0, 0, 0).max())!r}'
          f' bf16 ulp (max|plain| {top!r})')
    del record, x, w2, plain_out, kernel_out, gap
    plain = stem.stem_conv_s2d_plain
    shares = []
    for what, conv in (
            ('one ulp at that share of its stem outputs', ulp_noise(density)),
            ('its stem taps mirrored',
             lambda x, w2: plain(x, w2.flip(-1, -2)))):
        with plain_stem_as(conv):
            noisy = pipe(frames)
        shares.append(match(f'{tag} calibration, plain path with {what}',
                            noisy, want, least=0.0))
    limit = min(0.75, shares[0] - MATCH_MARGIN)
    print(f'{tag} calibration: matched-set limit {limit!r}')
    check(shares[1] < limit, f'{tag}: the matched-set limit {limit!r} admits '
          f'a stem with mirrored taps ({shares[1]!r}): it has no teeth')
    return limit


def main_path(name, sd, frames8, dev):
    """One path: both conf cells through Pipeline with kernels and with
    the plain versions.  Returns (launch counts of the kernel-path runs,
    the kernel-path outputs, the sparse bf16 kernel pipeline)."""
    cfg = path_config(name)
    path = PATHS[name]
    # cuDNN may sum the stem's products in another order than the float32
    # kernel: near ties may swap
    ties_ok = cfg.stem_s2d
    runs = path.get('runs', (('b1 bf16', 'bfloat16', 1),
                             ('b8 bf16', 'bfloat16', 8),
                             ('b1 f32', 'float32', 1)))
    weights = [(wname, shape_conf(sd, cfg.num_classes, scale, bias), branch)
               for wname, scale, bias, branch in path['cells']]

    plain = {}
    reset_launches()
    for wname, wsd, _ in weights:
        for rname, dtype, batch in runs:
            pipe = make_pipeline(name, wsd, dev, dtype, use_kernels=False)
            plain[wname, rname] = pipe(frames8[:batch])
            del pipe
    torch.cuda.synchronize()
    check(not any(read_launches(KERNELS).values()),
          f'{name}: the plain path launched a kernel')

    kernel_pipes, kernel_out, branches = {}, {}, {}
    for wname, wsd, _ in weights:
        for dtype in ('bfloat16', 'float32'):
            kernel_pipes[wname, dtype] = make_pipeline(name, wsd, dev, dtype)
            check(getattr(kernel_pipes[wname, dtype].model.backbone,
                          'stem_s2d', False) == cfg.stem_s2d,
                  f'{name}: the stem is not the expected one')
    # the path's run: counts from 0, read right after
    reset_launches()
    for wname, _, _ in weights:
        before = dict(detection.branch_counts)
        for rname, dtype, batch in runs:
            kernel_out[wname, rname] = kernel_pipes[wname, dtype](
                frames8[:batch])
        branches[wname] = {k: detection.branch_counts[k] - before[k]
                           for k in before}
    torch.cuda.synchronize()
    every = read_launches(KERNELS)
    launches = {k: every[k] for k in path['kernels']}
    print(f'{name} path launches: {json.dumps(every)}')
    for kname, n in every.items():
        if kname in path['kernels']:
            check(n > 0, f'{kname} was not launched on the {name} path')
        else:
            check(n == 0, f'{kname} was launched on the {name} path')

    bf16_diffs = 0
    for wname, wsd, branch in weights:
        print(f'{name} {wname} weights: NMS tails taken {branches[wname]}')
        check(branches[wname][branch] == len(runs),
              f'{name} {wname} weights did not take the {branch} NMS tail')
        for rname, dtype, batch in runs:
            tag = f'{name} {wname} {rname}'
            check_output(tag, kernel_out[wname, rname], cfg, batch)
            check_output(tag + ' plain', plain[wname, rname], cfg, batch)
            if dtype == 'bfloat16' and cfg.stem_s2d:
                # the tensor-core stem puts about 1 in 10^4 outputs one bf16
                # ulp from its plain version, and the bf16 trunk carries
                # that on: matched as sets, as the two stems are below
                least = 0.75
                if path.get('calibrated_match'):
                    least = match_calibration(tag, name, wsd,
                                              frames8[:batch], dev,
                                              plain[wname, rname])
                match(tag, kernel_out[wname, rname], plain[wname, rname],
                      least=least)
                continue
            n = compare(tag, kernel_out[wname, rname], plain[wname, rname],
                        exact=dtype == 'float32', ties_ok=ties_ok)
            if dtype == 'bfloat16':
                bf16_diffs += n
    check(bool(kernel_out['sparse', 'b8 bf16'].valid.any()),
          f'{name}: the sparse conf head gave no detections')
    print(f'{name} bf16 valid/class differences kernel vs plain: '
          f'{bf16_diffs}')
    return launches, kernel_out, kernel_pipes['sparse', 'bfloat16']


def path_config(name):
    """The config a path's model runs: Pipeline's choice of stem for raw
    frames, or the plain stem."""
    cfg = config_named(PATHS[name]['config'])
    return cfg if PATHS[name].get('plain_stem') else maybe_enable_stem_s2d(cfg)


class PlainStemPipeline:
    """yolact_base through the plain 7x7/s2 stem: load_model and
    forward_and_detect, the Pipeline's parts without its choice of the s2d
    stem for raw frames."""

    def __init__(self, cfg, state_dict, device, compute_dtype,
                 use_kernels=True):
        self.cfg = cfg
        self.model = load_model(cfg, state_dict, device, compute_dtype)
        self.device = device
        self.use_kernels = use_kernels

    def __call__(self, images):
        with torch.inference_mode():
            return forward_and_detect(self.cfg, self.model,
                                      torch.as_tensor(images,
                                                      device=self.device),
                                      use_kernels=self.use_kernels)


def make_pipeline(name, state_dict, device, compute_dtype, use_kernels=True):
    if PATHS[name].get('plain_stem'):
        return PlainStemPipeline(path_config(name), state_dict, device,
                                 compute_dtype, use_kernels)
    return Pipeline(config_named(PATHS[name]['config']), state_dict, device,
                    compute_dtype, use_kernels=use_kernels)


class SyntheticEvalSet:
    """`n` seeded BGR frames of `size` x `size` pixels, each with 1-3
    objects of random foreground classes (elliptic masks inside their
    boxes), in the COCODetection item contract that evaluate_dataset reads:
    pull_item -> (frame normalized as BaseTransform does for a ResNet config
    at max_size == size, gt [k, 5] relative boxes and 0-based labels, masks
    [k, size, size], h, w, 0 crowds)."""

    def __init__(self, n, size, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = list(range(1, n + 1))
        self.items = []
        yy, xx = np.mgrid[:size, :size] + 0.5
        for _ in range(n):
            raw = rng.randint(0, 256, (size, size, 3)).astype(np.float32)
            k = rng.randint(1, 4)
            xy1 = rng.randint(0, size // 2, (k, 2))
            xy2 = xy1 + rng.randint(size // 8, size // 2, (k, 2))
            cx, cy = (xy1 + xy2).T / 2
            rx, ry = (xy2 - xy1).T / 2
            masks = ((((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
                      + ((yy[None] - cy[:, None, None]) / ry[:, None, None])
                      ** 2) <= 1).astype(np.float32)
            labels = rng.randint(0, num_classes - 1, k)
            gt = np.hstack([np.hstack([xy1, xy2]) / size, labels[:, None]])
            img = ((raw - np.float32(MEANS)) / np.float32(STD))[..., ::-1]
            self.items.append((np.ascontiguousarray(img, np.float32), gt,
                               masks, size, size, 0))

    def __len__(self):
        return len(self.items)

    def pull_item(self, index):
        return self.items[index]


def eval_phase(sd, dev, card):
    """evaluate_dataset on EVAL_FRAMES in-memory frames, yolact_base sparse
    cell, b8 in the config's dtype: fast NMS with the s2d stem (kernels,
    then plain versions), and traditional NMS with the s2d stem, each with
    evaluate_dataset's default mask IoU, which must run on the card (every
    image's matrices held against the host path).  Returns the steady
    frames/s of each run (the loop's own average, which skips the first two
    frames, as the reference does)."""
    cfg = get_config('yolact_base').copy(stem_s2d=True)
    data = SyntheticEvalSet(EVAL_FRAMES, cfg.max_size, cfg.num_classes,
                            seed=5)
    wsd = shape_conf(sd, cfg.num_classes, 3.0, 7.0)
    # (tag, fast NMS, kernels, kernels that must run / must not)
    runs = (('fast_nms s2d', True, True, ('stem_s2d', 'fast_nms_iou_max',
                                           'mask_assembly'), ('dcn',)),
            ('fast_nms s2d plain', True, False, (), tuple(KERNELS)),
            ('traditional s2d', False, True, ('stem_s2d',),
             ('fast_nms_iou_max', 'mask_assembly', 'dcn')))
    maps, rates = {}, {}
    for tag, fast, kernels, must, must_not in runs:
        reset_launches()
        buf = io.StringIO()
        recorded = RecordedIoU()
        evaluate.mask_iou_device = recorded
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                maps[tag] = evaluate_dataset(cfg, wsd, data, dev,
                                             eval_batch_size=8, fast_nms=fast,
                                             use_kernels=kernels)
        finally:
            evaluate.mask_iou_device = device_metrics.mask_iou_device
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(len(recorded.calls) == EVAL_FRAMES,
              f'eval {tag}: the default mask IoU ran on the card for '
              f'{len(recorded.calls)} of {EVAL_FRAMES} images')
        recorded.check_against_host(tag)
        launches = read_launches(KERNELS)
        out = buf.getvalue()
        rates[tag] = float(re.findall(r'([0-9.]+) fps', out)[-1])
        size = f'{cfg.max_size}x{cfg.max_size}'
        print(f'eval {tag}: {EVAL_FRAMES} frames of {size}, b8: '
              f'{rates[tag]!r} frames/s steady, {secs!r} s in all (pipeline '
              f'build and first batch included); launches '
              f'{json.dumps(launches)} [{card}]')
        print(out.split('\r')[-1].split('\n', 1)[-1].rstrip())
        check(maps[tag] is not None and set(maps[tag]) == {'box', 'mask'},
              f'eval {tag}: no mAP table')
        check(all(np.isfinite(v) for t in maps[tag].values()
                  for v in t.values()), f'eval {tag}: non-finite mAP')
        for kname in must:
            check(launches[kname] > 0, f'eval {tag}: {kname} not launched')
        for kname in must_not:
            check(launches[kname] == 0, f'eval {tag}: {kname} launched')
    check(maps['fast_nms s2d'] == maps['fast_nms s2d plain'],
          'eval: the kernels and their plain versions give other mAPs')
    return rates


def ellipses(rng, k, h, w):
    """k seeded elliptic masks [k, h, w] and their absolute boxes [k, 4]."""
    yy, xx = np.mgrid[:h, :w] + 0.5
    xy1 = np.stack([rng.randint(0, w // 2, k), rng.randint(0, h // 2, k)], 1)
    wh = np.stack([rng.randint(w // 8, w // 2, k),
                   rng.randint(h // 8, h // 2, k)], 1)
    xy2 = xy1 + wh
    cx, cy = (xy1 + xy2).T / 2
    rx, ry = wh.T / 2
    masks = ((((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
              + ((yy[None] - cy[:, None, None]) / ry[:, None, None]) ** 2)
             <= 1).astype(np.float32)
    return masks, np.hstack([xy1, xy2]).astype(np.float64)


class SizedEvalSet:
    """`n` seeded eval items at the image sizes `sizes` (h, w), in turn, in
    the COCODetection item contract: 1-3 objects of random foreground
    classes and, last, one crowd annotation (elliptic masks [k + 1, h, w]).
    The network input stands for the frame after BaseTransform: a seeded
    random frame at max_size x max_size, normalized as SyntheticEvalSet's
    (no image files, no resize, no cv2)."""

    def __init__(self, n, sizes, max_size, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = list(range(1, n + 1))
        self.items = []
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            k = rng.randint(1, 4)
            masks, boxes = ellipses(rng, k + 1, h, w)
            labels = rng.randint(0, num_classes - 1, k + 1)
            gt = np.hstack([boxes / [w, h, w, h], labels[:, None]])
            raw = rng.randint(0, 256, (max_size, max_size, 3))
            img = ((raw - np.float32(MEANS)) / np.float32(STD))[..., ::-1]
            self.items.append((np.ascontiguousarray(img, np.float32), gt,
                               masks, h, w, 1))

    def __len__(self):
        return len(self.items)

    def pull_item(self, index):
        return self.items[index]


class OraclePipeline:
    """Stands in for Pipeline in evaluate_dataset: answers each frame with
    detections made from its own gt (recognised by the frame's bytes): per
    gt object, the crowd included, one of its class with the box moved by
    a few pixels and the mask averaged down to the prototypes' size, plus
    two false positives; seeded scores.  A non-zero mAP from any weights,
    with the masks on the card."""

    def __init__(self, dataset, cfg, device, seed=0):
        self.device = torch.device(device)
        rng = np.random.RandomState(seed)
        d = cfg.max_num_detections
        hp, wp = proto_size(cfg)
        self.by_frame = {}
        for img, gt, masks, h, w, _ in dataset.items:
            fp_masks, fp_boxes = ellipses(rng, 2, h, w)
            boxes = np.vstack([gt[:, :4] * [w, h, w, h]
                               + rng.randint(-3, 4, (len(gt), 4)), fp_boxes])
            small = F.interpolate(torch.from_numpy(
                np.concatenate([masks, fp_masks]))[None], size=(hp, wp),
                mode='area')[0]
            n = min(len(boxes), d)
            out = dict(boxes=np.zeros((d, 4), np.float32),
                       classes=np.zeros(d, np.int32),
                       scores=np.zeros(d, np.float32),
                       masks=torch.zeros(d, hp, wp),
                       valid=np.zeros(d, bool))
            out['boxes'][:n] = (boxes / [w, h, w, h])[:n]
            out['classes'][:n] = np.concatenate(
                [gt[:, 4], rng.randint(0, cfg.num_classes - 1, 2)])[:n]
            out['scores'][:n] = np.sort(rng.uniform(0.1, 1, n))[::-1]
            out['masks'][:n] = small[:n]
            out['valid'][:n] = True
            self.by_frame[img.tobytes()] = out

    def __call__(self, images):
        outs = [self.by_frame[np.asarray(f, np.float32).tobytes()]
                for f in images]
        stack = {k: torch.as_tensor(np.stack([o[k] for o in outs]))
                 for k in ('boxes', 'classes', 'scores', 'valid')}
        return InferenceOutput(
            stack['boxes'], stack['classes'], stack['scores'],
            torch.stack([o['masks'] for o in outs]).to(self.device),
            stack['valid'])


def write_gt_json(data, cfg, path):
    """The set's gt as a COCO instances JSON (category ids as
    DetectionsWriter maps the classes, RLE masks, the crowds marked)."""
    cats = inverse_label_map(cfg.dataset)
    images, anns = [], []
    for image_id, (_, gt, masks, h, w, crowds) in zip(data.ids, data.items):
        images.append({'id': image_id, 'height': h, 'width': w})
        for j, (row, m) in enumerate(zip(gt, masks)):
            x1, y1, x2, y2 = (row[:4] * [w, h, w, h]).tolist()
            r = rle_codec.mask_to_rle(m > 0.5)
            anns.append({'id': len(anns) + 1, 'image_id': image_id,
                         'category_id': cats[int(row[4])],
                         'bbox': [x1, y1, x2 - x1, y2 - y1],
                         'area': float(m.sum()),
                         'iscrowd': int(j >= len(gt) - crowds),
                         'segmentation': {'size': r['size'],
                                          'counts': r['counts'].decode()}})
    with open(path, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': c} for c in sorted(set(cats.values()))]
                   }, f)


class RecordedIoU:
    """Wraps eval/evaluate.py's mask_iou_device: keeps each call's inputs
    and outputs, to hold them against the host path afterwards, and times
    each call to its end on the card (host clock)."""

    def __init__(self):
        self.calls = []
        self.seconds = []

    def __call__(self, masks, gt, h, w):
        t0 = time.perf_counter()
        out = device_metrics.mask_iou_device(masks, gt, h, w)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.calls.append((masks.clone(), np.asarray(gt), h, w,
                           [t.cpu().numpy() for t in out]))
        return out

    def check_against_host(self, tag):
        """Every call's IoU and crowd IoU equal the host path's
        (finish_masks, then the evaluator's IoU), bit for bit.  Returns the
        host path's seconds per call."""
        seconds = []
        for masks, gt, h, w, (iou, crowd, area) in self.calls:
            t0 = time.perf_counter()
            full = finish_masks(masks, w, h).reshape(
                len(masks), h * w).astype(np.float32)
            g = np.asarray(gt, np.float32).reshape(len(gt), h * w)
            host_iou = evaluator._np_mask_iou(full, g)
            host_crowd = evaluator._np_mask_iou(full, g, iscrowd=True)
            seconds.append(time.perf_counter() - t0)
            check(np.array_equal(iou, host_iou)
                  and np.array_equal(crowd, host_crowd)
                  and np.array_equal(area, full.sum(1)),
                  f'eval {tag}: device mask IoU differs from the host path '
                  f'at {h}x{w}')
        return seconds


def eval_sizes_phase(sd, dev, card):
    """Phase 5, second set: EVAL_FRAMES frames at EVAL_SIZES with a crowd
    each, yolact_base sparse cell, s2d stem, b8, evaluate_dataset with the
    mask IoU on the card and on the host in the order device, host, host,
    device: equal mAP tables, every image's device IoU and crowd-IoU
    matrices equal to the host path's, frames/s of each run, and the mask
    IoU stage's ms per image both ways on the same masks.  The same with
    detections made from the gt (a non-zero mAP).  Then --output_coco_json
    of the set through cli/coco_eval against a gt JSON of it: 12 finite
    numbers per type.  Returns the frames/s by run."""
    cfg = get_config('yolact_base').copy(stem_s2d=True)
    data = SizedEvalSet(EVAL_FRAMES, EVAL_SIZES, cfg.max_size,
                        cfg.num_classes, seed=6)
    sizes = '/'.join(f'{h}x{w}' for h, w in EVAL_SIZES)
    wsd = shape_conf(sd, cfg.num_classes, 3.0, 7.0)
    rates = {}
    real_pipeline = evaluate.Pipeline
    try:
        for oracle in (False, True):
            name = 'gt-made detections' if oracle else 'sized'
            if oracle:
                evaluate.Pipeline = lambda *a, **k: OraclePipeline(
                    data, cfg, dev)
            maps, stage = [], {True: [], False: []}
            order = (True, False) if oracle else (True, False, False, True)
            for run, on_card in enumerate(order):
                where = 'device' if on_card else 'host'
                tag = f'{name} {where} mask IoU run {run + 1}'
                recorded = RecordedIoU()
                evaluate.mask_iou_device = recorded
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    maps.append(evaluate_dataset(
                        cfg, wsd, data, dev, eval_batch_size=8,
                        device_mask_iou=on_card))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                out = buf.getvalue()
                rates[tag] = float(re.findall(r'([0-9.]+) fps', out)[-1])
                check(len(recorded.calls) == (len(data) if on_card else 0),
                      f'eval {tag}: {len(recorded.calls)} device IoU calls')
                line = (f'eval {tag}: {EVAL_FRAMES} frames of {sizes}, b8: '
                        f'{rates[tag]!r} frames/s steady, {secs!r} s in all')
                if on_card:
                    host_s = recorded.check_against_host(tag)
                    dets = [len(c[0]) for c in recorded.calls]
                    stage[True] += recorded.seconds
                    stage[False] += host_s
                    line += (f'; {len(dets)} images\' IoU matrices equal '
                             f'to the host path\'s; detections per image '
                             f'{min(dets)}-{max(dets)} (mean '
                             f'{statistics.mean(dets)!r})')
                print(line + f' [{card}]')
                print(out.split('\r')[-1].split('\n', 1)[-1].rstrip())
            check(all(m == maps[0] for m in maps),
                  f'eval {name}: device and host mask IoU give other mAP '
                  f'tables')
            if oracle:
                check(maps[0]['mask']['all'] > 0 and maps[0]['box']['all'] > 0,
                      'eval gt-made detections: mAP 0')
            print(f'eval {name}: mask IoU stage per image, same masks and gt '
                  f'(host clock, median of {len(stage[True])}): device '
                  f'{statistics.median(stage[True]) * 1e3!r} ms (gt to the '
                  f'card, upsample, GEMM, synchronised), host '
                  f'{statistics.median(stage[False]) * 1e3!r} ms (finish_masks '
                  f'to the host, numpy IoU) [{card}]')
    finally:
        evaluate.Pipeline = real_pipeline
        evaluate.mask_iou_device = device_metrics.mask_iou_device

    with tempfile.TemporaryDirectory() as tmp:
        files = {k: os.path.join(tmp, f'{k}.json')
                 for k in ('gt', 'bbox', 'mask')}
        write_gt_json(data, cfg, files['gt'])
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate_dataset(cfg, wsd, data, dev, eval_batch_size=8,
                             output_coco_json=True,
                             bbox_det_file=files['bbox'],
                             mask_det_file=files['mask'])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = coco_eval_cli.main([
                f'--gt_ann_file={files["gt"]}',
                f'--bbox_det_file={files["bbox"]}',
                f'--mask_det_file={files["mask"]}'])
    print('coco_eval of the sized set\'s --output_coco_json: '
          + json.dumps(stats))
    check(set(stats) == {'bbox', 'segm'} and all(
        len(v) == 12 and all(np.isfinite(x) for x in v.values())
        for v in stats.values()), 'coco_eval: not 12 finite numbers a type')
    return rates


def bound(nbytes, ops, ops_per_s):
    """The least time in ms the card could take: the larger of `nbytes`
    over the memory rate and `ops` over `ops_per_s`, with which of the two
    bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def device_events(prof):
    """The profiler's device events: kernels and copies.  A record_function
    range (the optimizer's step, the trainer's iterations) shows up on the
    device too, spanning the kernels it holds; those are left out."""
    events = prof.events()
    annotations = {e.name for e in events
                   if getattr(e, 'is_user_annotation', False)}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and e.name not in annotations | {'iteration'}]


PROFILES = collections.Counter()    # profile_kernels: profiles, lost events


def profile_kernels(fn, calls=20, warmup=3):
    """torch.profiler kernel events over `calls` calls: (device busy ms per
    call, idle share of the span from the first kernel's start to the last
    one's end, {kernel name: ms per call}, {kernel name: events}), or None
    when the profiler recorded no kernel.  The profiler loses events on an
    H100 (11-19 of 20 kept is common; the sum of a 0.39 ms kernel's events
    over 20 calls once read 0.079 ms, as if it had kept 4), so a kernel's
    ms per call is the mean of its recorded events times its launches per
    call, the recorded count over the calls rounded up (which holds while
    fewer than `calls` of its events are lost)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        return None
    total, counts = collections.Counter(), collections.Counter()
    for e in events:
        total[e.name] += e.time_range.elapsed_us() / 1e3
        counts[e.name] += 1
    by_name = {k: total[k] / counts[k] * -(-counts[k] // calls)
               for k in total}
    PROFILES['profiles'] += 1
    PROFILES['with lost events'] += any(n % calls for n in counts.values())
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3 / calls
    return busy, 1 - busy / span, by_name, dict(counts)


def device_times(fn, symbol=None):
    """Device ms per call of `fn` by torch.profiler kernel events over 20
    calls (profile_kernels): (all its kernels, those whose name holds
    `symbol`).  Where the profiler records nothing (or nothing of
    `symbol`), which it does on an H100 for whole profiles, both are
    device_ms's time of the whole call, and say so."""
    prof = profile_kernels(fn)
    mine = [v for k, v in (prof[2] if prof else {}).items()
            if symbol is not None and symbol in k]
    if prof is None or (symbol is not None and not mine):
        t = device_ms(fn)
        what = '' if prof is None else f' of {symbol}'
        print(f'profiler recorded no kernel{what}: CUDA-event time of the '
              f'whole call (device_ms) instead')
        return t, t
    return prof[0], sum(mine)


def kernel_names(fn):
    """The names of the kernels the calls of `fn` launch."""
    prof = profile_kernels(fn)
    return sorted(prof[2]) if prof else ['not measured']


def stem_timing(dev, card):
    """The stem kernel's device time against its plain version, cuDNN's
    4x4 conv of the same function (one call: padding 2, the extra last row
    and column not read) and cuDNN's 7x7/s2 conv on the 3-channel image it
    replaces, with the kernel's bound: bf16 at b8 and b1, and float32 (the
    split-TF32 kernel a float32 train step runs; TF32 is off, so cuDNN's
    convs are float32 too) at b8, whose bound is its three TF32 products
    at the TF32 rate, printed beside the FMA bound of one float32 product
    per pair.  Returns the numbers by (dtype, batch)."""
    gen = torch.Generator().manual_seed(6)
    out = {}
    for dtype, batch in ((torch.bfloat16, 8), (torch.bfloat16, 1),
                         (torch.float32, 8)):
        x = torch.randn(batch, 12, 275, 275, generator=gen).to(dev, dtype)
        w2 = (torch.randn(64, 12, 4, 4, generator=gen) * 0.1).to(dev, dtype)
        x3 = torch.randn(batch, 3, 550, 550, generator=gen).to(dev, dtype)
        w7 = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(dev, dtype)
        fns = {'plain': lambda: stem.stem_conv_s2d_plain(x, w2),
               'kernel': lambda: stem.stem_conv_s2d(x, w2),
               'cudnn_4x4': lambda: F.conv2d(x, w2, padding=2)[..., :275,
                                                                :275],
               'cudnn_7x7': lambda: F.conv2d(x3, w7, stride=2, padding=3)}
        dev_ms = {k: device_times(fn)[0] for k, fn in fns.items()}
        symbol = ('stem_s2d_mma_kernel' if dtype == torch.bfloat16
                  else 'stem_s2d_tf32_kernel')
        dev_ms['kernel'] = device_times(fns['kernel'], symbol)[1]
        call = {k: time_ms(fns[k]) for k in ('plain', 'kernel')}
        y = fns['kernel']()
        ops = 2 * y.numel() * 12 * 16
        # no call can beat the bytes it must move, nor the kernel its bound
        # below: a reading under its floor is a fault of the measurement
        floors = {k: bound(n, 0, 1)[0] for k, n in (
            ('plain', nbytes(x, w2, y)), ('kernel', nbytes(x, w2, y)),
            ('cudnn_4x4', nbytes(x, w2, y)),
            ('cudnn_7x7', nbytes(x3, w7) + y.numel() * y.element_size()))}
        if dtype == torch.bfloat16:
            b_ms, b_by = bound(nbytes(x, w2, y), ops, BF16_TENSOR_OPS_PER_S)
            fma = ''
        else:
            b_ms, b_by = bound(nbytes(x, w2, y), 3 * ops,
                               TF32_TENSOR_OPS_PER_S)
            fma_ms, fma_by = bound(nbytes(x, w2, y), ops, FP32_OPS_PER_S)
            fma = (f'; as FMAs the bound would be {fma_ms!r} by {fma_by} '
                   f'({fma_ms / dev_ms["kernel"]!r} of it)')
        floors['kernel'] = b_ms
        name = str(dtype)[6:]
        for k, floor in floors.items():
            check(dev_ms[k] >= floor, f'stem b{batch} {name}: {k} read '
                  f'{dev_ms[k]!r} ms, below its bound {floor!r} ms: not a '
                  f'device time')
        print(f'stem b{batch} {name} x[{batch},12,275,275] -> '
              f'[{batch},64,275,275]: device ms per call (torch.profiler '
              f'kernel events, 20 calls) kernel {dev_ms["kernel"]!r} (bound '
              f'{b_ms!r} by {b_by}: {b_ms / dev_ms["kernel"]!r} of it{fma}), '
              f'plain '
              f'(float32 conv, rounded) {dev_ms["plain"]!r}, cuDNN {name} 4x4 '
              f'{dev_ms["cudnn_4x4"]!r}, cuDNN {name} 7x7/s2 on '
              f'[{batch},3,550,550] {dev_ms["cudnn_7x7"]!r}; call median '
              f'(p90) ms kernel {call["kernel"][0]!r} ({call["kernel"][1]!r}), '
              f'plain {call["plain"][0]!r} ({call["plain"][1]!r}) [{card}]')
        out[dtype, batch] = dict(dev_ms, bound=(b_ms, b_by))
    return out


def dcn_timing(dev, card, plus_pipe, frames8):
    """yolact_plus_base's 11 DCN blocks at b8 bf16, each at its shape
    (device time of all the call's kernels, torch.profiler kernel events
    over 20 calls): the sampling kernel on a channels_last x and on an
    NCHW one (the wrapper's NHWC copy), the GEMM
    on its columns against the GEMM in the per-image [Cin*9, Ho*Wo]
    layout and a cuDNN 3x3 conv of the same shape, and the block's tail
    (BN, ReLU, the 1x1 conv) on the GEMM's channels_last output against an
    NCHW copy of it.  Prints the sums per batch and the GEMM kernels'
    names; returns the layers.2 blocks 3-21 times and bound for the kernels
    line."""
    formats = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args: formats.append(
            args[0].is_contiguous(memory_format=torch.channels_last)))
             for m in plus_pipe.model.modules() if isinstance(m, DCNLayer)]
    plus_pipe(frames8)
    for h in hooks:
        h.remove()
    print(f'yolact_plus_base b8: {sum(formats)} of {len(formats)} DCN blocks '
          f'take a channels_last x (the rest pay the wrapper\'s NHWC copy)')
    gen = torch.Generator().manual_seed(7)
    per_batch = collections.Counter()
    line = {}
    for name, count, cin, h, stride in DCN_SHAPES:
        x, offset, mask = dcn_inputs(gen, dev, 8, cin, h, stride,
                                     torch.bfloat16, finite=True)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        ho = offset.shape[-1]
        w = (torch.randn(cin, cin, 3, 3, generator=gen) * 0.02).to(dev)\
            .bfloat16()
        w_t = w.permute(0, 2, 3, 1).reshape(cin, -1).t()
        cols = dcn.dcn_columns(x_cl, offset, mask, 3, stride)
        w_per_image = w.reshape(cin, -1)
        cols_per_image = cols.view(8, ho * ho, -1).transpose(1, 2).contiguous()
        y = torch.matmul(cols, w_t).view(8, ho, ho, cin).permute(0, 3, 1, 2)
        w3 = (torch.randn(4 * cin, cin, 1, 1, generator=gen) * 0.05).to(dev)\
            .bfloat16()
        bn = [torch.rand(cin, generator=gen).to(dev) + 0.5 for _ in range(4)]

        def tail(t):
            t = F.batch_norm(t, bn[0], bn[1], bn[2], bn[3], False, 0.0, 1e-5)
            return F.conv2d(F.relu(t), w3)

        fns = {'sampling': lambda: dcn.dcn_columns(x_cl, offset, mask, 3,
                                                   stride),
               'sampling_nchw_x': lambda: dcn.dcn_columns(x, offset, mask, 3,
                                                          stride),
               'gemm': lambda: torch.matmul(cols, w_t),
               'gemm_per_image_cols': lambda: torch.matmul(w_per_image, cols_per_image),
               'cudnn_3x3': lambda: F.conv2d(x, w, stride=stride, padding=1),
               'tail_channels_last': lambda: tail(y),
               'tail_nchw_copy': lambda: tail(y.contiguous())}
        ms = {k: device_times(fn)[0] for k, fn in fns.items()}
        for k, v in ms.items():
            per_batch[k] += count * v
        b_ms, b_by = bound(nbytes(x, offset, mask, cols), 8 * cols.numel(),
                           FP32_OPS_PER_S)
        per_batch['bound'] += count * b_ms
        print(f'dcn {name} b8 bf16 x[8,{cin},{h},{h}] cols'
              f'{list(cols.shape)} (x{count} per batch): device ms '
              + ', '.join(f'{k} {v!r}' for k, v in ms.items())
              + f'; sampling bound {b_ms!r} by {b_by} ({b_ms / ms["sampling"]!r}'
              f' of it) [{card}]')
        if count == 7:
            kern_ms = device_times(fns['sampling'], 'dcn_im2col_kernel')[1]
            plain_ms = device_times(lambda: dcn.dcn_columns_plain(
                x_cl, offset, mask, 3, stride))[0]
            print(f'dcn {name}: kernel {kern_ms!r} ms, plain {plain_ms!r} '
                  f'ms (torch.profiler kernel events, 20 calls) [{card}]')
            line = dict(ms=kern_ms, plain_ms=plain_ms,
                        bound=(b_ms, b_by),
                        shape=f'{name} x[8,{cin},{h},{h}] bf16 -> cols'
                              f'{list(cols.shape)}')
            for k in ('gemm', 'gemm_per_image_cols', 'cudnn_3x3'):
                print(f'dcn {name}: {k} kernels {kernel_names(fns[k])}')
        del x, x_cl, offset, mask, cols, cols_per_image, y
    print('dcn per yolact_plus_base b8 batch (11 blocks), device ms: '
          + ', '.join(f'{k} {v!r}' for k, v in per_batch.items())
          + f' [{card}]')
    return line


def small_kernel_bounds(margs, boxes):
    """The bounds of the IoU-max and mask-assembly kernels on these inputs:
    {name: (ms, 'bytes' or 'operations')}."""
    n, k = boxes.shape[:2]
    b, d, md = margs[1].shape
    masks_out = b * d * margs[0].shape[1] * margs[0].shape[2]
    return {
        # 13 float32 operations per IoU pair: 4 min/max, 2 subtractions and
        # 2 clamps and a product for the intersection, 2 for the union, the
        # divide, the running max (the per-box areas are O(k))
        'fast_nms_iou_max': bound(nbytes(boxes) + n * k * 4,
                                  13 * n * k * (k - 1) // 2, FP32_OPS_PER_S),
        # the Md-term dot product (2 Md operations) and the sigmoid (3)
        'mask_assembly': bound(nbytes(*margs) + masks_out * 4,
                               masks_out * (2 * md + 3), FP32_OPS_PER_S),
    }


def clocks():
    """The card's SM and memory clocks and power draw now, as nvidia-smi
    reads them: an isolated short kernel's time follows the power state
    that the work before it left the card in."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.mem,power.draw',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()


def small_kernel_timing(dev, card):
    """The IoU-max and mask-assembly kernels at the b8 and b1 main-path
    shapes: device and call time against their plain versions, with their
    bounds.  Returns the b8 numbers."""
    gen = torch.Generator().manual_seed(1)
    out = {}
    print(f'clocks before the isolated kernel timings: {clocks()}')
    for batch in (8, 1):
        margs = mask_inputs(gen, dev, batch, 100)
        boxes = iou_inputs(gen, dev, batch * 80, 200)
        bounds = small_kernel_bounds(margs, boxes)
        timed = {
            'fast_nms_iou_max': (
                lambda: nms.nms_iou_max(boxes),
                lambda: nms.nms_iou_max_plain(boxes),
                'fast_nms_iou_max_kernel', f'[{batch * 80},200,4]'),
            'mask_assembly': (
                lambda: mask_assembly.assemble_masks(*margs),
                lambda: mask_assembly.assemble_masks_plain(*margs),
                'mask_assembly_kernel', f'B={batch} D=100 138x138 Md=32'),
        }
        for name, (kern, plain, symbol, shape) in timed.items():
            b_ms, b_by = bounds[name]
            dev_ms = device_times(kern, symbol)[1]
            plain_dev = device_times(plain)[0]
            plain_call, plain_p90 = time_ms(plain)
            call, p90 = time_ms(kern)
            print(f'kernel {name} b{batch} {shape}: device {dev_ms!r} ms '
                  f'(bound {b_ms!r} by {b_by}: {b_ms / dev_ms!r} of it), '
                  f'plain device {plain_dev!r} ms (torch.profiler kernel '
                  f'events, 20 calls); call median {call!r} ms (p90 '
                  f'{p90!r}), plain {plain_call!r} ms (p90 {plain_p90!r}) '
                  f'({RUNS} calls each; call time: wrapper, launch and '
                  f'device) [{card}]')
            if batch == 8:
                out[name] = dict(ms=dev_ms, plain_ms=plain_dev,
                                 bound=(b_ms, b_by))
        del margs, boxes
    # phase 9's options path: 33 prototypes at 70 x 70 (Md % 4 != 0)
    margs = mask_inputs(gen, dev, 8, 100, hw=70, md=33)
    b_ms, b_by = small_kernel_bounds(
        margs, iou_inputs(gen, dev, 8, 200))['mask_assembly']
    dev_ms = device_times(lambda: mask_assembly.assemble_masks(*margs),
                          'mask_assembly_kernel')[1]
    plain_dev = device_times(
        lambda: mask_assembly.assemble_masks_plain(*margs))[0]
    print(f'kernel mask_assembly b8 B=8 D=100 70x70 Md=33 (the options '
          f'path): device {dev_ms!r} ms (bound {b_ms!r} by {b_by}: '
          f'{b_ms / dev_ms!r} of it), plain device {plain_dev!r} ms '
          f'(torch.profiler kernel events, 20 calls) [{card}]')
    return out

# ---- phase 6: the train step ---------------------------------------------

# The train paths: config overrides, the kernels' launches per step, and
# the gradients held against the plain run (non-zero, within 1e-3 of their
# largest entry)
DCN0 = 'backbone.layers.1.0.conv2.'
# stem_limit: under batch statistics the float32 stem's train check holds
# the first-step conv1 gradient to this limit, set from recorded readings,
# instead of 1e-3; the same comparison with frozen batch norm holds it to
# 1e-3 beside it.  Under batch statistics the random ResNet-101's
# first-step conv1 gradient moves by 3.4e-3 of its max when the plain
# stem's float32 output alone is perturbed by about an ulp (probe_stem.py
# --sensitivity, PERF.md), so 1e-3 holds only a stem bit-equal to cuDNN's.
# The limit sits between two readings taken in the same run
# (stem_calibration): the plain path with its stem's output perturbed at
# the kernel's own error level, which the limit must admit, and the plain
# path with a one-pass TF32 stem (2^-11 relative), which it must refuse.
STEM_BATCH_STATS_LIMIT = 3e-2
TRAIN_PATHS = {
    'train_yolact_base_s2d': dict(
        config='yolact_base', overrides=dict(stem_s2d=True),
        per_step=dict(stem_s2d=1, dcn=0, dcn_col2im=0),
        grads=('backbone.conv1.weight',), stem_limit=STEM_BATCH_STATS_LIMIT),
    'train_yolact_plus_base': dict(
        config='yolact_plus_base', overrides=dict(train_remat='dcn'),
        per_step=dict(stem_s2d=0, dcn=22, dcn_col2im=11),
        grads=('backbone.conv1.weight', DCN0 + 'conv_offset_mask.weight',
               DCN0 + 'weight')),
}
TRAIN_KERNELS = ('stem_s2d', 'dcn', 'dcn_col2im')
TRAIN_STEPS = 3
TRAIN_TIMED_STEPS = 10


def make_train_batch(cfg, batch=8, max_gt=16, n=5, seed=0):
    """A seeded batch in the contract of data/coco.py:pad_batch: `n` boxes
    per image with rectangular masks, the last a crowd (-1), the other rows
    padding (-2); a normalized-looking RGB image."""
    rng = np.random.RandomState(seed)
    size = cfg.max_size
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    labels = np.full((batch, max_gt), -2, np.int32)
    masks = np.zeros((batch, max_gt, size, size), np.uint8)
    for b in range(batch):
        for g in range(n):
            x1, y1 = rng.rand(2) * 0.5
            w, h = rng.rand(2) * 0.4 + 0.1
            boxes[b, g] = [x1, y1, min(x1 + w, 1), min(y1 + h, 1)]
            labels[b, g] = rng.randint(0, cfg.num_classes - 1)
            masks[b, g, int(y1 * size):int(min(y1 + h, 1) * size),
                  int(x1 * size):int(min(x1 + w, 1) * size)] = 1
        labels[b, n - 1] = -1
    return dict(image=rng.randn(batch, size, size, 3).astype(np.float32),
                gt_boxes=boxes, gt_labels=labels, gt_masks=masks,
                num_gts=np.full(batch, n, np.int32),
                num_crowds=np.ones(batch, np.int32))


@contextlib.contextmanager
def deterministic_library():
    """PyTorch's deterministic algorithms where it has them (warnings for
    the rest silenced).  From random weights the first gradients are in the
    thousands, and the run-to-run noise of the library's atomics (bilinear
    upsample, gather and pooling backwards) grows a thousandfold a step:
    without this two runs of the SAME path differ by 10% in a loss at the
    third step, as much as a kernel run from a plain one."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]


def tame_residuals(sd, scale=0.1):
    """Scale the last batch norm of every bottleneck.  Xavier-random
    weights through 33 bottlenecks give a first gradient of 8e6 at conv1 of
    yolact_plus_base (3e3 at yolact_base): one step at any learning rate
    wrecks the network, and what follows is chaos, not training.  With
    residual branches at 0.1 the gradients are of order 1, as from a
    pretrained backbone, and the config's schedule lowers the loss."""
    return {k: v * scale if k.endswith('bn3.weight') else v
            for k, v in sd.items()}


def run_train_steps(cfg, sd, batch, dev, use_kernels, grad_names,
                    captured=None, steps=TRAIN_STEPS):
    """`steps` steps from `sd` with seeded draws: (state, the losses of each
    step, the named gradients of the first step, the kernels' launches of
    each step).  `captured`, a list: the first step's dcn_col2im inputs are
    appended to it (capture_col2im)."""
    state = create_train_state(cfg, device=dev, state_dict=sd)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = dict(state.model.named_parameters())
    losses, launches, grads = [], [], None
    for i in range(steps):
        reset_launches()
        with (capture_col2im() if captured is not None and i == 0
              else contextlib.nullcontext([])) as got:
            out = train_step(state, batch, gen, use_kernels=use_kernels)
        if captured is not None:
            captured.extend(got)
        torch.cuda.synchronize()
        launches.append(read_launches(TRAIN_KERNELS))
        losses.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = {k: params[k].grad.clone() for k in grad_names}
    return state, losses, grads, launches


def grad_checks(tag, names, grads, plain_grads, rel):
    """The named first-step gradients of a kernel run against the plain
    run's: non-zero, and within `rel` of their largest entry."""
    for k in names:
        top = float(plain_grads[k].abs().max())
        err = float((grads[k] - plain_grads[k]).abs().max())
        print(f'{tag} first-step gradient of {k}: max {top!r}, max_abs_err '
              f'against the plain versions {err!r} ({err / top!r} of max; '
              f'criterion {rel!r})')
        check(top > 0 and float(grads[k].abs().max()) > 0,
              f'{tag}: {k} has no gradient')
        check(err <= rel * top, f'{tag}: the gradient of {k} differs')


@contextlib.contextmanager
def plain_stem_as(conv):
    """stem.stem_conv_s2d_plain replaced by `conv` in the block (the plain
    path's stem: the model looks it up at each call)."""
    plain = stem.stem_conv_s2d_plain
    stem.stem_conv_s2d_plain = conv
    try:
        yield
    finally:
        stem.stem_conv_s2d_plain = plain


def recording_stem(record):
    """The plain stem, recording its first call's inputs in `record`."""
    plain = stem.stem_conv_s2d_plain

    def conv(x, w2):
        if not record:
            record.extend((x.detach().clone(), w2.detach().clone()))
        return plain(x, w2)
    return conv


def tf32_round(t):
    """`t` rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away
    from zero, 10 mantissa bits), passing `t`'s gradient through."""
    bits = t.detach().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return t + (r - t).detach()


def stem_calibration(tag, cfg, sd, batch, dev, name, plain_grads,
                     stem_input, limit, card):
    """Two more plain runs of the train check: the stem's output perturbed
    by Gaussian noise of the kernel's own error on the first step's stem
    input (its rms against the plain stem there), and a one-pass TF32 stem
    (input and weight rounded to TF32, float32 sums).  The first-step
    gradient `name` of the first must stay within `limit` of the plain
    run's largest entry, and the second must leave it: the readings that
    place the limit."""
    x, w2 = stem_input
    want = stem.stem_conv_s2d_plain(x, w2)
    diff = stem.stem_conv_s2d(x, w2) - want
    sigma = float(diff.pow(2).mean().sqrt())
    print(f'{tag}: the stem kernel on the first step\'s stem input x'
          f'{list(x.shape)}: rms difference from the plain stem {sigma!r}, '
          f'max {float(diff.abs().max())!r}, max|plain| '
          f'{float(want.abs().max())!r}')
    del diff, want
    plain = stem.stem_conv_s2d_plain

    def noisy(x, w2):
        out = plain(x, w2)
        gen = torch.Generator(device=out.device).manual_seed(1)
        return out + sigma * torch.randn(out.shape, device=out.device,
                                         generator=gen)

    def one_pass_tf32(x, w2):
        return plain(tf32_round(x), tf32_round(w2))

    top = float(plain_grads[name].abs().max())
    readings = {}
    for what, conv in (('noise of the kernel\'s rms error', noisy),
                       ('one-pass TF32 stem', one_pass_tf32)):
        with deterministic_library(), plain_stem_as(conv):
            _, losses, grads, _ = run_train_steps(cfg, sd, batch, dev, False,
                                                  (name,))
        rel = float((grads[name] - plain_grads[name]).abs().max()) / top
        readings[what] = rel
        print(f'{tag} calibration, plain path with {what}: first-step '
              f'gradient of {name} max_abs_err / max {rel!r} (limit '
              f'{limit!r}); losses {json.dumps(losses)} [{card}]')
    low, control = readings.values()
    check(low <= limit, f'{tag}: the limit {limit!r} refuses the plain path '
          f'perturbed at the kernel\'s error level ({low!r})')
    check(control > limit, f'{tag}: the limit {limit!r} admits a one-pass '
          f'TF32 stem ({control!r}): it has no teeth')


def train_path(name, sd, dev, card):
    """One train path (see the module docstring, phase 6).  Returns the
    kernel run's summed launches and its timing numbers."""
    path = TRAIN_PATHS[name]
    # The schedule is the config's at a tenth of its learning rate, warmed
    # up from 1e-7: the backward kernel's atomics make the kernel run
    # differ from the plain one (and from itself) by 3e-6 of a gradient,
    # and the config's own first steps grow that to 4e-4 of the maskiou
    # loss by the third step; at these rates it stays under 1e-5 while
    # each step still moves the losses by several 1e-4.  Both runs take the
    # same steps.
    cfg = get_config(path['config']).copy(lr=1e-4, lr_warmup_init=1e-7,
                                          **path['overrides'])
    batch = make_train_batch(cfg)
    tag = f'{name} 550 b8 f32'
    untamed = create_train_state(cfg, device=dev, state_dict=sd)
    loss_and_grads(untamed, batch, *draw_priorities(
        cfg, 8, untamed.model.priors(cfg.max_size, cfg.max_size,
                                     dev).shape[0],
        torch.Generator(device=dev).manual_seed(11), dev))
    print(f'{tag}: with the Xavier-random weights as they are the first '
          f'gradient of backbone.conv1.weight has max '
          f'{float(untamed.model.backbone.conv1.weight.grad.abs().max())!r}'
          f'; the train phase scales every bottleneck\'s last batch norm '
          f'to 0.1 (tame_residuals)')
    del untamed
    sd = tame_residuals(sd)

    stem_input = []      # the plain run's first stem input
    with deterministic_library():
        with plain_stem_as(recording_stem(stem_input)):
            _, plain_losses, plain_grads, plain_launches = run_train_steps(
                cfg, sd, batch, dev, False, path['grads'])
        check(not any(n for step in plain_launches for n in step.values()),
              f'{tag}: the plain path launched a kernel')
        # the path's run: counts from 0 before each step, read right after
        captured = [] if path['per_step']['dcn_col2im'] else None
        state, losses, grads, launches = run_train_steps(
            cfg, sd, batch, dev, True, path['grads'], captured)
    total = {k: sum(step[k] for step in launches) for k in TRAIN_KERNELS}
    print(f'{tag} launches per step: {json.dumps(launches)}')
    for step in launches:
        check(step == path['per_step'], f'{tag}: launches per step {step}, '
              f'expected {path["per_step"]}')
    for i, (got, want) in enumerate(zip(losses, plain_losses)):
        print(f'{tag} step {i}: kernels {json.dumps(got)}; plain versions '
              f'{json.dumps(want)}')
        check(got['finite'] and want['finite'], f'{tag}: step {i} skipped')
        for k in got:
            check(np.isfinite(got[k]) and
                  abs(got[k] - want[k]) <= 1e-4 * abs(want[k]),
                  f'{tag}: step {i} loss {k} {got[k]!r} against the plain '
                  f'versions\' {want[k]!r}')
    check(state.step == TRAIN_STEPS, f'{tag}: step count {state.step}')
    limit = path.get('stem_limit')
    grad_checks(tag, path['grads'], grads, plain_grads, limit or 1e-3)
    if limit:
        stem_calibration(tag, cfg, sd, batch, dev, path['grads'][0],
                         plain_grads, stem_input, limit, card)
        frozen = cfg.copy(freeze_bn=True)
        with deterministic_library():
            _, plain_losses, plain_grads, _ = run_train_steps(
                frozen, sd, batch, dev, False, path['grads'])
            _, losses, grads, _ = run_train_steps(
                frozen, sd, batch, dev, True, path['grads'])
        for i, (got, want) in enumerate(zip(losses, plain_losses)):
            for k in got:
                check(np.isfinite(got[k]) and
                      abs(got[k] - want[k]) <= 1e-4 * abs(want[k]),
                      f'{tag} frozen batch norm: step {i} loss {k} '
                      f'{got[k]!r} against the plain versions\' {want[k]!r}')
        grad_checks(f'{tag} (frozen batch norm)', path['grads'], grads,
                    plain_grads, 1e-3)
    del plain_grads, grads
    if captured:
        # the backward kernel alone on this step's own inputs (its time
        # inside the step is read below); the inputs are freed before the
        # step is timed, so the step's peak memory is its own
        col2im_in_step(captured, card)
    del captured

    # a non-finite step: nothing moves but the count
    gen = torch.Generator(device=dev).manual_seed(12)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = {k: state.optimizer.state[p]['momentum_buffer'].clone()
                for k, p in state.model.named_parameters()
                if p in state.optimizer.state}
    bad = dict(batch, image=batch['image'].copy())
    bad['image'][0, 7, 7, 0] = np.nan
    out = train_step(state, bad, gen)
    after = state.model.state_dict()
    check(not out['finite'] and not np.isfinite(float(out['total'])),
          f'{tag}: the NaN image gave a finite step')
    check(all(torch.equal(after[k], before[k]) for k in before),
          f'{tag}: the skipped step moved weights or batch-norm statistics')
    check(all(torch.equal(state.optimizer.state[p]['momentum_buffer'],
                          momentum[k])
              for k, p in state.model.named_parameters() if k in momentum),
          f'{tag}: the skipped step moved the momentum')
    check(state.step == TRAIN_STEPS + 1, f'{tag}: the skipped step did not '
          f'advance the count')
    print(f'{tag}: a step on a NaN image was skipped (total '
          f'{float(out["total"])!r}); weights, momentum and batch-norm '
          f'statistics bit-equal, step {state.step}')
    del before, momentum

    # timing: ms per step, peak memory, device busy and idle
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_TIMED_STEPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(state, batch, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times = times[2:]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_kernels(lambda: train_step(state, batch, gen), calls=3,
                           warmup=0)
    busy = ('not measured (the profiler recorded no kernel)' if prof is None
            else f'device busy {prof[0]!r} ms per step, idle share '
                 f'{prof[1]!r} (torch.profiler kernel events, 3 steps)')
    print(f'{tag} step: median {statistics.median(times)!r} ms, min '
          f'{min(times)!r}, max {max(times)!r} ({TRAIN_TIMED_STEPS} steps, '
          f'CUDA events; {8000.0 / statistics.median(times)!r} images/s); '
          f'peak memory allocated {peak!r} GiB; {busy} [{card}]')
    if prof is not None:
        top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:8]
        print(f'{tag} top kernels ms per step: '
              + '; '.join(f'{n[:60]} {t!r}' for n, t in top))
        ours = {k: sum(t for n, t in prof[2].items() if sym in n)
                for k, sym in (('stem_s2d', 'stem_s2d'),
                               ('dcn', 'dcn_im2col_kernel'),
                               ('dcn_col2im', 'dcn_col2im_kernel'))}
        print(f'{tag} hand-written kernels ms per step: {json.dumps(ours)}')
    # the matcher and the loss (forward and backward) on the step's shapes
    tensors = batch_to_device(batch, dev)
    with torch.no_grad():
        preds = state.model(
            torch.randn(8, 12, 275, 275, device=dev) if cfg.stem_s2d
            else torch.randn(8, 3, 550, 550, device=dev), train=True)
    drop_batch_stats(state.model)
    preds = {k: v.detach().requires_grad_(k != 'priors')
             for k, v in preds.items()}
    pri = torch.rand(8, preds['priors'].shape[0], device=dev)
    mpri = torch.rand(8 * cfg.masks_to_train, device=dev)

    def loss_call():
        out, _ = multibox_loss(cfg, preds, tensors, pri, mpri,
                               maskiou_net=state.model.maskiou_net,
                               num_gts=batch['num_gts'])
        sum(out.values()).backward()

    full = dict(tensors)
    full['gt_boxes'] = tensors['gt_boxes'][:, :5].repeat(1, 20, 1)
    full['gt_labels'] = tensors['gt_labels'][:, :5].clamp(min=0).repeat(1, 20)
    timed = {
        f'matcher, {int(batch["num_gts"].max())} gts per image': (
            lambda: match_priors(cfg, tensors['gt_boxes'],
                                 tensors['gt_labels'], preds['priors'],
                                 num_gts=batch['num_gts'])),
        'matcher, 100 gts per image (the whole greedy loop)': (
            lambda: match_priors(cfg, full['gt_boxes'], full['gt_labels'],
                                 preds['priors'])),
        'loss forward and backward (matcher included)': loss_call}
    for what, fn in timed.items():
        ms, p90 = time_ms(fn, runs=10, warmup=2)
        print(f'{tag} {what}: median {ms!r} ms (p90 {p90!r}; 10 calls, CUDA '
              f'events, host-paced) [{card}]')
    return total


def train_remat_none_counts(sd, dev):
    """One yolact_plus_base step without checkpointing: 11 sampling and 11
    backward launches."""
    cfg = get_config('yolact_plus_base').copy(train_remat='none')
    state = create_train_state(cfg, device=dev,
                               state_dict=tame_residuals(sd))
    reset_launches()
    out = train_step(state, make_train_batch(cfg),
                     torch.Generator(device=dev).manual_seed(11))
    torch.cuda.synchronize()
    got = read_launches(TRAIN_KERNELS)
    print(f"train_yolact_plus_base train_remat='none' launches per step: "
          f'{json.dumps(got)}')
    check(out['finite'] and got == dict(stem_s2d=0, dcn=11, dcn_col2im=11),
          f"train_remat='none': launches {got}")


def col2im_timing(dev, card):
    """dcn_col2im at the five yolact_plus_base shapes, b8, in float32 (the
    train step's dtype) and bfloat16, on dcn_inputs' finite offsets: device
    time of the kernel, of the whole wrapper call (the zero fill and the
    rounding of grad_x included) and of the plain version (autograd
    through the plain columns, their forward included), with the bound:
    the bytes of g_cols, x, offsets and mask read once and the three
    gradients written once; and the global reductions into grad_x
    (col2im_reductions_line).  Returns the float32 layers.2 blocks 3-21
    numbers for the kernels line."""
    gen = torch.Generator().manual_seed(13)
    line = {}
    for dtype in (torch.float32, torch.bfloat16):
        per_step = collections.Counter()
        for name, count, cin, h, stride in DCN_SHAPES:
            x, offset, mask = dcn_inputs(gen, dev, 8, cin, h, stride, dtype,
                                         finite=True)
            x = x.contiguous(memory_format=torch.channels_last)
            ho = offset.shape[-1]
            g_cols = torch.randn(8 * ho * ho, 9 * cin, generator=gen)\
                .to(dtype).to(dev)
            call = lambda: dcn.dcn_col2im(g_cols, x, offset, mask, 3, stride)
            all_ms, kern_ms = device_times(call, 'dcn_col2im_kernel')
            plain_ms = device_times(lambda: dcn.dcn_col2im_plain(
                g_cols, x, offset, mask, 3, stride))[0]
            # 4 multiply-adds for the corner sums and 4 products for
            # grad_x per (sample, channel)
            b_ms, b_by = bound(nbytes(g_cols, x, offset, mask) +
                               nbytes(x, offset, mask), 16 * g_cols.numel(),
                               FP32_OPS_PER_S)
            for k, v in (('kernel', kern_ms), ('call', all_ms),
                         ('plain', plain_ms), ('bound', b_ms)):
                per_step[k] += count * v
            print(f'dcn_col2im {name} b8 {str(dtype)[6:]} x[8,{cin},{h},{h}] '
                  f'g_cols{list(g_cols.shape)} (x{count} per step): device '
                  f'ms kernel {kern_ms!r}, whole call {all_ms!r}, plain '
                  f'version {plain_ms!r}; bound {b_ms!r} by {b_by} '
                  f'({b_ms / kern_ms!r} of it) (torch.profiler kernel '
                  f'events, 20 calls); '
                  f'{col2im_reductions_line(x, offset, stride)} [{card}]')
            if count == 7 and dtype == torch.float32:
                line = dict(ms=kern_ms, plain_ms=plain_ms,
                            bound=(b_ms, b_by))
            del x, offset, mask, g_cols
        print(f'dcn_col2im per yolact_plus_base b8 step (11 blocks) '
              f'{str(dtype)[6:]}, device ms: '
              + ', '.join(f'{k} {v!r}' for k, v in per_step.items())
              + f' [{card}]')
    return line


# ---- phase 4b, continued: the registered configs no card run had taken ---

# Each at its own size and full width: inference at b1 f32 through Pipeline
# (the s2d stem for raw frames) with the kernels against the plain
# versions by phase 4's rule, then one b8 f32 train step by phase 6's rule
# (train overrides: the s2d stem on the ResNets without DCN, which
# phase 6 runs on yolact_base; 'dcn' remat on yolact_plus_resnet50, as
# phase 6 runs yolact_plus_base).  yolact_im700 is the first 700 x 700
# input of any kernel; yolact_plus_resnet50's 13 DCN blocks (every block
# of stages 2-4) give both DCN kernels shapes no other config has, among
# them 512 channels at 18 x 18; yolact_resnet50_pascal's 21 classes run the
# IoU max at [20, 200].
A14_CONFIGS = {
    'yolact_im400': dict(stem_s2d=True),
    'yolact_im700': dict(stem_s2d=True),
    'yolact_resnet50': dict(stem_s2d=True),
    'yolact_resnet50_pascal': dict(stem_s2d=True),
    'yolact_plus_resnet50': dict(train_remat='dcn'),
}
# the conf cell: the head scaled by the first of A14_SCALES and biased by
# the first of A14_BIASES that leave A14_CANDIDATES priors of a frame
# passing conf_thresh in float32 (the pruned NMS tail), read in the run
# from the plain model's conf logits on the path's frame (probe_cells.py's
# count).  The biases are an eighth apart: yolact_resnet50_pascal's count
# falls from 4906 at +5 to 55 at +6; yolact_plus_resnet50's random head is
# flatter (no candidate at x3 from +4 on)
A14_SCALES = (3.0, 6.0, 12.0)
A14_BIASES = tuple(k / 8 for k in range(89))
A14_CANDIDATES = (100, 900)


def a14_cell(name, cfg, sd, frame, dev):
    """(scale, background bias) of the first cell of A14_SCALES x
    A14_BIASES that leaves A14_CANDIDATES priors passing conf_thresh."""
    model = load_model(cfg, sd, dev, 'float32')
    with torch.inference_mode():
        conf = model(preprocess_device(cfg, frame))['conf'].float()
    del model
    check(bool(torch.isfinite(conf).all()), f'{name}: non-finite conf logits '
          f'(std {float(conf.nan_to_num().std())!r})')
    counts = {}
    for scale in A14_SCALES:
        for bias in A14_BIASES:
            logits = conf * scale
            logits[..., 0] += bias
            best = torch.softmax(logits, -1)[..., 1:].max(-1).values
            n = counts[scale, bias] = int((best > cfg.nms_conf_thresh).sum())
            if A14_CANDIDATES[0] <= n <= A14_CANDIDATES[1]:
                print(f'{name} conf cell: x{scale} +{bias}, {n} of '
                      f'{conf.shape[1]} priors pass conf_thresh (float32; '
                      f'the count at x{scale} by bias: ' + ', '.join(
                          f'+{b} {c}' for (s, b), c in counts.items()
                          if s == scale and c) + ')')
                return scale, bias
    raise RuntimeError(f'chip_smoke: {name}: no cell of {A14_SCALES} x '
                       f'{A14_BIASES} leaves {A14_CANDIDATES} candidates: '
                       f'{counts}')


def a14_inference(name, sd, dev):
    """b1 f32 on a seeded frame of the config's size, kernels against plain
    (phase 4's rule).  Returns the kernel run's launches."""
    cfg = config_named(name)
    size = (1, cfg.max_size, cfg.max_size, 3)
    frame = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, size).astype(np.float32)).to(dev)
    wsd = shape_conf(sd, cfg.num_classes, *a14_cell(name, cfg, sd, frame,
                                                     dev))
    plain_pipe = Pipeline(cfg, wsd, dev, 'float32', use_kernels=False)
    kernel_pipe = Pipeline(cfg, wsd, dev, 'float32')
    reset_launches()
    plain = plain_pipe(frame)
    torch.cuda.synchronize()
    check(not any(read_launches(KERNELS).values()),
          f'{name}: the plain path launched a kernel')
    # the path's run: counts from 0, read right after
    reset_launches()
    before = dict(detection.branch_counts)
    got = kernel_pipe(frame)
    torch.cuda.synchronize()
    launches = read_launches(KERNELS)
    branch = {k: detection.branch_counts[k] - before[k] for k in before}
    runs = {'fast_nms_iou_max', 'mask_assembly', 'stem_s2d'} | (
        {'dcn'} if any('conv_offset_mask' in k for k in sd) else set())
    print(f'{name} {cfg.max_size} b1 f32 path launches: '
          f'{json.dumps(launches)}; NMS tails {branch}')
    for kname, n in launches.items():
        check(n > 0 if kname in runs else n == 0,
              f'{name}: {kname} launched {n} times on its path')
    check(branch['pruned'] == 1, f'{name}: the pruned NMS tail not taken')
    tag = f'{name} {cfg.max_size} sparse b1 f32'
    check_output(tag, got, cfg, 1)
    check_output(tag + ' plain', plain, cfg, 1)
    compare(tag, got, plain, exact=True, ties_ok=True)
    check(bool(got.valid.any()), f'{name}: no detections')
    del plain_pipe, kernel_pipe
    return launches


def a14_train(name, sd, dev, card):
    """One b8 f32 train step at the config's size, kernels against plain
    (phase 6's rule).  Returns the kernel step's launches."""
    overrides = A14_CONFIGS[name]
    cfg = config_named(name).copy(lr=1e-4, lr_warmup_init=1e-7, **overrides)
    tag = f'{name} {cfg.max_size} b8 f32 train step'
    names = ['backbone.conv1.weight']
    offsets = sorted(k for k in sd if k.endswith('conv_offset_mask.weight'))
    if offsets:
        dcn0 = offsets[0][:-len('conv_offset_mask.weight')]
        names += [dcn0 + 'conv_offset_mask.weight', dcn0 + 'weight']
    blocks = len(offsets)
    want = dict(stem_s2d=int(bool(cfg.stem_s2d)),
                dcn=blocks * (2 if cfg.train_remat in ('dcn', 'all') else 1),
                dcn_col2im=blocks)
    batch = make_train_batch(cfg)
    sd = tame_residuals(sd)
    t0 = time.perf_counter()
    with deterministic_library():
        _, plain_losses, plain_grads, plain_launches = run_train_steps(
            cfg, sd, batch, dev, False, names, steps=1)
        check(not any(plain_launches[0].values()),
              f'{tag}: the plain path launched a kernel')
        _, losses, grads, launches = run_train_steps(
            cfg, sd, batch, dev, True, names, steps=1)
    print(f'{tag}: launches per step {json.dumps(launches[0])} (expected '
          f'{json.dumps(want)}); kernels {json.dumps(losses[0])}; plain '
          f'versions {json.dumps(plain_losses[0])}; '
          f'{time.perf_counter() - t0:.1f} s [{card}]')
    check(launches[0] == want, f'{tag}: launches per step {launches[0]}')
    got, ref = losses[0], plain_losses[0]
    check(got['finite'] and ref['finite'], f'{tag}: the step was skipped')
    for k in got:
        check(np.isfinite(got[k]) and abs(got[k] - ref[k]) <= 1e-4 * abs(
            ref[k]), f'{tag}: loss {k} {got[k]!r} against the plain '
            f'versions\' {ref[k]!r}')
    # under batch statistics the s2d stem's first conv1 gradient is held to
    # STEM_BATCH_STATS_LIMIT, as phase 6 holds yolact_base's
    stem_limit = STEM_BATCH_STATS_LIMIT if cfg.stem_s2d else 1e-3
    grad_checks(tag, names[:1], grads, plain_grads, stem_limit)
    grad_checks(tag, names[1:], grads, plain_grads, 1e-3)
    return launches[0]


def a14_phase(dev, card):
    """Phase 4b's registered configs (A14_CONFIGS): their launches, by
    config, on the inference path (b1 f32) and per train step."""
    out = {}
    for name in A14_CONFIGS:
        t0 = time.perf_counter()
        cfg = config_named(name)
        sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
        if any(k.endswith('conv_offset_mask.weight') for k in sd):
            sd = seed_offsets_state_dict(sd, torch.Generator().manual_seed(3))
        out[name] = dict(inference_b1_f32=a14_inference(name, sd, dev),
                         train_step_b8_f32=a14_train(name, sd, dev, card))
        del sd
        torch.cuda.empty_cache()
        print(f'{name}: {time.perf_counter() - t0:.1f} s [{card}]')
    return out


# ---- phase 9: model options and video -------------------------------------

# the first-step gradients each option path's train check reads: conv1
# behind the stem kernel, and in the heads and the protonet
OPTION_TRAIN_GRADS = {
    'yolact_base_direct': ('backbone.conv1.weight',
                           'prediction_layers.0.mask_layer.weight'),
    'yolact_base_options': ('backbone.conv1.weight',
                            'prediction_layers.0.block.conv1.weight',
                            'prediction_layers.0.gate_layer.weight',
                            'proto_net.0.weight'),
}
VIDEO_FRAMES = 64
VIDEO_HW = (720, 1280)
VIDEO_MULTIFRAME = 4
# the video's conf cell (shape_conf): the frames, squeezed from 720x1280 to
# 550x550 by a bilinear resize without antialiasing, are smoother than
# phase 4's, and the sparse cell's +7 leaves no candidate on them; +5
# leaves 276-328 an image (probe_cells.py --paths video on the card)
VIDEO_CELL = (3.0, 5.0)


def pasted(out, b, w, h):
    """Image b's direct masks pasted into a w x h frame on the host."""
    n = int(out.valid[b].sum())
    boxes = evaluate.sanitize_boxes_np(out.boxes[b, :n].cpu().numpy(), w, h)
    return boxes, finish_masks_direct(out.masks[b, :n], boxes, w, h)


def direct_paste_check(tag, got, want):
    """finish_masks_direct on the direct path's b1 f32 outputs (kernels and
    plain versions, whose detections phase 4's rule held equal): each mask
    inside its box, the two pastes equal on >= 99.9% of the pixels (patch
    values within 1e-4 may straddle 0.5)."""
    t0 = time.perf_counter()
    boxes, masks = pasted(got, 0, 550, 550)
    ms = (time.perf_counter() - t0) * 1e3
    _, plain = pasted(want, 0, 550, 550)
    check(masks.shape == plain.shape and masks.dtype == bool,
          f'{tag}: pasted masks {masks.shape} against {plain.shape}')
    inside = np.zeros_like(masks)
    for j, (x1, y1, x2, y2) in enumerate(boxes):
        inside[j, y1:y2, x1:x2] = True
    check(not (masks & ~inside).any(), f'{tag}: a mask outside its box')
    share = float((masks == plain).mean()) if masks.size else 1.0
    print(f'{tag} finish_masks_direct: {masks.shape[0]} masks, '
          f'{int(masks.sum())} pixels set, kernels against plain versions '
          f'{share!r} of pixels equal; {ms!r} ms on the host')
    check(masks.shape[0] > 0 and masks.any(), f'{tag}: no direct masks')
    check(share >= 0.999, f'{tag}: pasted masks differ')


def option_train(name, sd, dev, card):
    """TRAIN_STEPS steps of a phase-9 path at 550 b8 f32 with the s2d stem,
    kernels against plain versions as phase 6 holds yolact_base (the same
    tamed weights, schedule, batch and draws, deterministic algorithms):
    every loss within 1e-4 relative per step, the stem launched once a
    step, and the first-step gradients of OPTION_TRAIN_GRADS within
    STEM_BATCH_STATS_LIMIT of their largest entry under batch statistics
    (the stem kernel's rounding reaches every one of them through a batch
    norm on batch statistics: conv1's, and the heads' through the DSSD
    block's) and within 1e-3 with frozen batch norm.  Returns the kernel
    run's summed launches."""
    base = config_named(name).copy(lr=1e-4, lr_warmup_init=1e-7,
                                   stem_s2d=True)
    sd = tame_residuals(sd)
    names = OPTION_TRAIN_GRADS[name]
    for cfg, rel in ((base, STEM_BATCH_STATS_LIMIT),
                     (base.copy(freeze_bn=True), 1e-3)):
        batch = make_train_batch(cfg)
        tag = f'train_{name} 550 b8 f32' + (' (frozen batch norm)'
                                            if cfg.freeze_bn else '')
        with deterministic_library():
            _, plain_losses, plain_grads, plain_launches = run_train_steps(
                cfg, sd, batch, dev, False, names)
            check(not any(n for step in plain_launches
                          for n in step.values()),
                  f'{tag}: the plain path launched a kernel')
            state, losses, grads, launches = run_train_steps(
                cfg, sd, batch, dev, True, names)
        print(f'{tag} launches per step: {json.dumps(launches)}')
        for step in launches:
            check(step == dict(stem_s2d=1, dcn=0, dcn_col2im=0),
                  f'{tag}: launches per step {step}')
        for i, (got, want) in enumerate(zip(losses, plain_losses)):
            print(f'{tag} step {i}: kernels {json.dumps(got)}; plain '
                  f'versions {json.dumps(want)}')
            check(got['finite'] and want['finite'] and 'M' in got,
                  f'{tag}: step {i} skipped or without a mask loss')
            for k in got:
                check(np.isfinite(got[k]) and
                      abs(got[k] - want[k]) <= 1e-4 * abs(want[k]),
                      f'{tag}: step {i} loss {k} {got[k]!r} against the '
                      f'plain versions\' {want[k]!r}')
        grad_checks(tag, names, grads, plain_grads, rel)
        if not cfg.freeze_bn:
            total = {k: sum(step[k] for step in launches)
                     for k in TRAIN_KERNELS}
            gen = torch.Generator(device=dev).manual_seed(12)
            torch.cuda.reset_peak_memory_stats()
            ms, p90 = time_ms(lambda: train_step(state, batch, gen), runs=5,
                              warmup=1)
            print(f'{tag} step: median {ms!r} ms, p90 {p90!r} (5 steps, '
                  f'CUDA events; {8000.0 / ms!r} images/s); peak memory '
                  f'allocated {torch.cuda.max_memory_allocated() / 2 ** 30!r}'
                  f' GiB [{card}]')
        del state, grads, plain_grads
    return total


def video_frames(n=VIDEO_FRAMES, hw=VIDEO_HW, seed=5):
    """`n` seeded BGR uint8 frames: one noise frame (uniform, as phase 4's
    frames) with two bright rectangles, shifted a little further each
    frame."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    base[200:420, 300:640] = 230
    base[380:620, 700:1000] = (40, 200, 90)
    return np.stack([np.roll(base, (3 * i, 8 * i), axis=(0, 1))
                     for i in range(n)])


def video_phase(sd, dev, card):
    """eval/video.py:evalvideo on VIDEO_FRAMES in-memory frames of
    VIDEO_HW at yolact_base (VIDEO_CELL, masks shaped by shape_masks,
    the config's float32, fast
    NMS, VIDEO_MULTIFRAME frames a batch, masks upsampled on the card; the
    frames drawn with their masks: no cv2 here for boxes and text), with
    the plain versions and then with the kernels, the launches counted
    from 0 just before the kernel run.  The drawn frames agree on >= 99.9%
    of their pixels, and the first batch's detections by phase 4's f32
    rule.  Returns (the kernel run's launches, frames/s)."""
    cfg = config_named('yolact_base')
    wsd = shape_masks(shape_conf(sd, cfg.num_classes, *VIDEO_CELL))
    frames = video_frames()
    kw = dict(video_multiframe=VIDEO_MULTIFRAME, score_threshold=0.0,
              top_k=15, display_fps=False, display_bboxes=False,
              display_text=False, device=dev)
    drawn, rates = {}, {}
    for label, use_kernels in (('plain versions', False), ('kernels', True)):
        drawn[label] = []
        if use_kernels:
            reset_launches()
        t0 = time.perf_counter()
        fps = video.evalvideo(cfg, wsd, frames, use_kernels=use_kernels,
                              sink=drawn[label].append, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if use_kernels:
            launches = read_launches(KERNELS)
        rates[label] = VIDEO_FRAMES / wall
        print(f'video yolact_base {VIDEO_HW[0]}x{VIDEO_HW[1]} f32 '
              f'multiframe {VIDEO_MULTIFRAME}, {label}: {VIDEO_FRAMES} frames '
              f'in {wall!r} s, {rates[label]!r} frames/s (evalvideo\'s '
              f'moving average {fps!r}, pipeline built in the time) [{card}]')
    print(f'video launches: {json.dumps(launches)}')
    batches = -(-VIDEO_FRAMES // VIDEO_MULTIFRAME)
    for k in ('fast_nms_iou_max', 'mask_assembly', 'stem_s2d'):
        check(launches[k] == batches, f'video: {k} launched {launches[k]} '
              f'times for {batches} batches')
    check(launches['dcn'] == launches['dcn_col2im'] == 0,
          'video: a DCN kernel was launched')
    # the detections of the first batch, by phase 4's float32 rule
    outs = [Pipeline(cfg, wsd, dev, use_kernels=k)(
        frames[:VIDEO_MULTIFRAME].astype(np.float32)) for k in (True, False)]
    compare('video first batch f32', *outs, exact=True, ties_ok=True)
    print(f'video first batch: valid detections per frame '
          f'{outs[0].valid.sum(1).tolist()}, drawn: those with the top '
          f'{kw["top_k"]} scores')
    got, want = drawn['kernels'], drawn['plain versions']
    check(len(got) == len(want) == VIDEO_FRAMES,
          f'video: {len(got)} and {len(want)} frames drawn')
    shares = [float((a == b).all(-1).mean()) for a, b in zip(got, want)]
    changed = [float((a != f).any(-1).mean()) for a, f in zip(got, frames)]
    print(f'video drawn frames, kernels against plain versions: the least '
          f'share of equal pixels {min(shares)!r}, mean '
          f'{float(np.mean(shares))!r}; pixels drawn over per frame '
          f'{min(changed)!r}-{max(changed)!r}')
    check(min(shares) >= 0.999, 'video: drawn frames differ')
    check(min(changed) > 0, 'video: a frame with nothing drawn')
    pipe = Pipeline(cfg, wsd, dev)
    x = torch.from_numpy(frames[:VIDEO_MULTIFRAME].astype(np.float32)).to(dev)
    ms, p90 = time_ms(lambda: pipe(x), runs=20, warmup=3)
    print(f'video step alone: Pipeline on {VIDEO_MULTIFRAME} frames of '
          f'{VIDEO_HW[0]}x{VIDEO_HW[1]} on the card, median {ms!r} ms '
          f'(p90 {p90!r}; 20 calls, CUDA events), '
          f'{VIDEO_MULTIFRAME * 1000.0 / ms!r} frames/s [{card}]')
    # the drawer's share: each batch's masks upsampled to the frame and
    # copied to the host, then one frame composited with its masks
    out = pipe(x)
    t0 = time.perf_counter()
    for _ in range(5):
        masks = upsample_masks_device(out.masks, VIDEO_HW).cpu().numpy()
    copy_ms = (time.perf_counter() - t0) / 5 * 1e3
    n = int(out.valid[0].sum())
    boxes = evaluate.sanitize_boxes_np(out.boxes[0, :n].cpu().numpy(),
                                       VIDEO_HW[1], VIDEO_HW[0])
    t0 = time.perf_counter()
    for _ in range(5):
        video.draw_detections(cfg, frames[0], out.classes[0, :n].cpu().numpy(),
                              out.scores[0, :n].cpu().numpy(), boxes,
                              masks[0, :n], top_k=15, display_bboxes=False,
                              display_text=False)
    draw_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f'video host work: masks {list(masks.shape)} upsampled on the card '
          f'and copied to the host {copy_ms!r} ms a batch, one frame '
          f'drawn with its top 15 masks {draw_ms!r} ms (host clock, 5 '
          f'calls each) [{card}]')
    return launches, rates['kernels']


def options_phase(sds, frames8, dev, card):
    """Phase 9 (see the module docstring).  Returns ({path: launch counts},
    video frames/s)."""
    launches = {}
    for name in OPTION_PATHS:
        t0 = time.perf_counter()
        sds[name] = random_state_dict(config_named(name),
                                      torch.Generator().manual_seed(0))
        print(f'{name} weights: {time.perf_counter() - t0:.2f} s')
        launches[name], outs, pipe = main_path(name, sds[name], frames8, dev)
        cfg = path_config(name)
        if cfg.mask_type == MaskType.DIRECT:
            wsd = shape_conf(sds[name], cfg.num_classes,
                             *PATHS[name]['cells'][0][1:3])
            plain = make_pipeline(name, wsd, dev, 'float32',
                                  use_kernels=False)(frames8[:1])
            direct_paste_check(f'{name} sparse b1 f32',
                               outs['sparse', 'b1 f32'], plain)
        else:
            print(f'{name}: {cfg.mask_dim} prototypes at '
                  f'{proto_size(cfg)}, the heads read '
                  f'{pipe.model.prediction_layers[0].bbox_layer.in_channels}'
                  f' channels')
            check(cfg.mask_dim % 4 != 0, f'{name}: Md {cfg.mask_dim} takes '
                  f'mask assembly\'s 16-byte branch')
        x = frames8
        ms, p90 = time_ms(lambda: pipe(x), runs=50)
        prof = profile_kernels(lambda: pipe(x))
        busy = ('busy not measured (the profiler recorded no kernel)'
                if prof is None else f'busy {prof[0]!r} ms per batch, idle '
                f'share {prof[1]!r} (torch.profiler kernel events, 20 '
                f'batches)')
        print(f'e2e {name} 550 bf16 b8: median {ms!r} ms/batch '
              f'({8000.0 / ms!r} frames/s), p90 {p90!r} (50 calls, CUDA '
              f'events); {busy} [{card}]')
        if prof is not None:
            top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:6]
            print(f'device {name} b8 top kernels ms per batch: '
                  + '; '.join(f'{n[:60]} {t!r}' for n, t in top))
        del pipe, outs
    for name in OPTION_PATHS:
        train = option_train(name, sds[name], dev, card)
        launches[f'train_{name}'] = train
    launches['video'], fps = video_phase(sds['yolact_base'], dev, card)
    return launches, fps


# ---- phase 8: the trainer ------------------------------------------------

# Raw frames of mixed sizes, 3 batches of 8 an epoch
TRAINER_SIZES = ((480, 640), (640, 480), (600, 600))
TRAINER_FRAMES = 24
# (tag, config, flags, iterations, iterations after --resume latest,
# launches per step)
TRAINER_RUNS = (
    ('yolact_base f32', 'yolact_base', ['--stem_s2d'], 20, 10,
     dict(stem_s2d=1, dcn=0, dcn_col2im=0)),
    ('yolact_base bf16', 'yolact_base',
     ['--stem_s2d', '--compute_dtype', 'bfloat16'], 20, 10,
     dict(stem_s2d=1, dcn=0, dcn_col2im=0)),
    ('yolact_plus_base bf16', 'yolact_plus_base',
     ['--compute_dtype', 'bfloat16', '--train_remat', 'dcn'], 10, 0,
     dict(stem_s2d=0, dcn=22, dcn_col2im=11)),
    # the second mode: the augmentation on the card (the loader resizes)
    ('yolact_base bf16 device_augment', 'yolact_base',
     ['--stem_s2d', '--compute_dtype', 'bfloat16', '--device_augment'], 10,
     0, dict(stem_s2d=1, dcn=0, dcn_col2im=0)),
    ('yolact_plus_base bf16 device_augment', 'yolact_plus_base',
     ['--compute_dtype', 'bfloat16', '--train_remat', 'dcn',
      '--device_augment'], 10, 0, dict(stem_s2d=0, dcn=22, dcn_col2im=11)),
)
# each device-augment run beside the host-augment run of its model
TRAINER_MODES = (('yolact_base bf16', 'yolact_base bf16 device_augment'),
                 ('yolact_plus_base bf16',
                  'yolact_plus_base bf16 device_augment'))


class SyntheticTrainSet:
    """`n` seeded raw BGR uint8 frames of `sizes` (in turn), each with 1-3
    objects of random foreground classes and one crowd (rectangular or
    elliptic masks inside their boxes), in the COCODetection item contract
    after `transform` (a training SSDAugmentation, run on the host by the
    loader's workers): pull_item -> (image, gt [k, 5] relative boxes and
    labels with the crowd last at -1, masks [k, S, S], h, w, num_crowds).
    An item whose transform drops every box is replaced by the next."""

    def __init__(self, n, sizes, num_classes, transform, seed=0):
        rng = np.random.RandomState(seed)
        self.transform = transform
        self.raw = []
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            k = rng.randint(1, 4) + 1
            xy1 = rng.rand(k, 2) * 0.6
            xy2 = np.minimum(xy1 + 0.15 + rng.rand(k, 2) * 0.3, 1.0)
            boxes = np.hstack([xy1, xy2])
            yy, xx = np.mgrid[:h, :w] + 0.5
            masks = np.zeros((k, h, w), np.uint8)
            for j, (x1, y1, x2, y2) in enumerate(boxes * [w, h, w, h]):
                if j % 2:
                    cx, cy, rx, ry = ((x1 + x2) / 2, (y1 + y2) / 2,
                                      (x2 - x1) / 2, (y2 - y1) / 2)
                    masks[j] = (((xx - cx) / rx) ** 2
                                + ((yy - cy) / ry) ** 2) <= 1
                else:
                    masks[j, int(y1):int(y2), int(x1):int(x2)] = 1
            labels = np.append(rng.randint(0, num_classes - 1, k - 1), -1)
            self.raw.append((rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                             boxes, masks, labels.astype(np.float64)))

    def __len__(self):
        return len(self.raw)

    def pull_item(self, index):
        frame, boxes, masks, labels = self.raw[index]
        h, w = frame.shape[:2]
        img, masks, boxes, out = self.transform(
            frame, masks.astype(np.float32), boxes.copy(),
            {'num_crowds': 1, 'labels': labels})
        if len(boxes) == 0:
            return self.pull_item((index + 1) % len(self))
        target = np.hstack([boxes, out['labels'][:, None]]).astype(np.float32)
        return img, target, masks, h, w, out['num_crowds']


def batch_bytes(batch):
    """The bytes of a batch's arrays: what it copies to the card."""
    return sum(int(v.nbytes) for v in batch.values() if hasattr(v, 'nbytes'))


class StepRecorder:
    """Stands in for train/step.py:train_step while cli/train.py runs (it
    looks the function up when it starts): per step the step count, the
    schedule's learning rate at it, whether it was applied, and each
    kernel's launches (the counters' difference across the call).  With a
    profiler it steps the profiler's schedule after each step."""

    def __init__(self, prof=None, before=None):
        self.steps = []
        self.prof = prof
        self.before = before

    def __enter__(self):
        self.real = step_module.train_step
        step_module.train_step = self
        return self

    def __exit__(self, *exc):
        step_module.train_step = self.real

    def __call__(self, state, batch, generator):
        if self.before is not None and not self.steps:
            self.before(state)
        before = read_launches(TRAIN_KERNELS)
        step, lr = state.step, learning_rate(state.cfg, state.step)
        out = self.real(state, batch, generator)
        after = read_launches(TRAIN_KERNELS)
        self.steps.append(dict(step=step, lr=lr, finite=out['finite'],
                               launches={k: after[k] - before[k]
                                         for k in after},
                               h2d_bytes=batch_bytes(batch)))
        if self.prof is not None:
            self.prof.step()
        return out


# the profiled iterations of a trainer run: after 3, the next 5
TRAINER_PROFILE = dict(wait=2, warmup=1, active=5, repeat=1)


def run_trainer(argv, dataset, val_dataset=None, profile=False, before=None):
    """cli/train.train(argv) on the in-memory datasets, its output captured:
    (summary, output, steps recorded, the kernels' launches in the run,
    the profiler or None).  `profile` traces TRAINER_PROFILE's iterations
    with torch.profiler; `before(state)` is called before the first step."""
    reset_launches()
    buf = io.StringIO()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(**TRAINER_PROFILE)) \
        if profile else None
    with StepRecorder(prof, before) as rec, contextlib.redirect_stdout(buf), \
            prof or contextlib.nullcontext():
        summary = train_cli.train(argv, dataset=dataset,
                                  val_dataset=val_dataset)
        torch.cuda.synchronize()
    return (summary, buf.getvalue(), rec.steps, read_launches(KERNELS), prof)


def loop_busy(prof):
    """Device busy ms per iteration and idle share over the profiled
    iterations but the first (the iteration spans cli/train.py
    records; validation and set-up fall outside), from the kernel events,
    or None when the profiler recorded no kernel."""
    iters = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name == 'iteration'
                   and e.device_type == torch.autograd.DeviceType.CPU)
    start, end = iters[1][0], iters[-1][1]
    # the union of the device events' intervals inside the window
    busy, reach = 0, start
    for a, b in sorted((max(e.time_range.start, start),
                        min(e.time_range.end, end))
                       for e in device_events(prof)):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    if busy == 0:
        return None
    return busy / 1e3 / (len(iters) - 1), 1 - busy / (end - start)


def states_equal(a, b):
    """(weights and buffers, momentum, step) bit-equal between two train
    states."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    weights = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                             for k in sa)
    ma = {k: a.optimizer.state[p]['momentum_buffer']
          for k, p in a.model.named_parameters() if p in a.optimizer.state}
    mb = {k: b.optimizer.state[p]['momentum_buffer']
          for k, p in b.model.named_parameters() if p in b.optimizer.state}
    momentum = bool(ma) and ma.keys() == mb.keys() and all(
        torch.equal(ma[k], mb[k]) for k in ma)
    return weights, momentum, a.step == b.step


def step_alone_ms(state, cfg, dev, steps=8):
    """Median ms of `steps` train steps on one fixed batch with no loader
    running (CUDA events around each, its host read included): the loop's
    iteration without the loader's threads beside it."""
    batch = make_train_batch(cfg)
    if cfg.use_device_augment:          # what the loader ships then
        batch = raw_batch(batch)
    gen = torch.Generator(device=dev).manual_seed(6)
    train_step(state, batch, gen)
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(state, batch, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def raw_batch(batch, seed=4):
    """`batch` as the device-augment loader ships it: a raw BGR uint8
    image and bit-packed full-resolution masks."""
    rng = np.random.RandomState(seed)
    return pack_batch_masks(dict(batch, image=rng.randint(
        0, 256, batch['image'].shape).astype(np.uint8)))


def trainer_timing(tag, summary, peak, busy, card, note='', steps=()):
    """Print and return the loop's numbers: median ms per iteration (its
    first two left out), the share of it spent waiting on the loader,
    images/s, peak memory, device busy and idle, the bytes each batch
    copies to the card."""
    iters = [t * 1e3 for t in summary['iter_seconds'][2:]]
    waits = [t * 1e3 for t in summary['wait_seconds'][2:]]
    ms = statistics.median(iters)
    h2d = sorted({s['h2d_bytes'] for s in steps})
    out = dict(ms=ms, wait_share=sum(waits) / sum(iters),
               images_s=8000.0 / ms, peak_gib=peak,
               busy=None if busy is None else busy[0],
               idle=None if busy is None else busy[1], h2d_bytes=h2d)
    dev = ('device busy not measured (the profiler recorded no kernel)'
           if busy is None else f'device busy {busy[0]!r} ms per iteration, '
           f'idle share {busy[1]!r} (torch.profiler kernel events, '
           f'{TRAINER_PROFILE["active"] - 1} iterations)')
    print(f'trainer {tag} 550 b8: median {ms!r} ms per iteration (min '
          f'{min(iters)!r}, max {max(iters)!r}; {len(iters)} iterations, '
          f'host clock, each ends in the step\'s host read){note}; loader '
          f'wait {out["wait_share"]!r} of it; {out["images_s"]!r} images/s; '
          f'peak memory allocated {peak!r} GiB; {dev}; host-to-device '
          f'bytes per batch {h2d} [{card}]')
    return out


def trainer_phase(sds, dev, card):
    """Phase 8 (see the module docstring).  Returns the kernels' launches
    summed over the trainer's runs, and the timing of each run."""
    total = collections.Counter()
    timing, per_step_launches = {}, {}
    t_phase = time.perf_counter()

    def stage(what):
        print(f'trainer phase at {time.perf_counter() - t_phase:.1f} s: '
              f'{what} [{card}]')

    with tempfile.TemporaryDirectory(prefix='chip_smoke_trainer_') as tmp:
        for tag, config, flags, iters, more, per_step in TRAINER_RUNS:
            stage(f'{tag} begins')
            name = 'smoke_' + tag.replace(' ', '_')
            # a tenth of the config's learning rate, warmed up from 1e-7
            base = get_config(config).copy(name=name, lr=1e-4,
                                           lr_warmup_init=1e-7)
            cfg = register_config(base.copy(max_iter=iters))
            # the seeded random weights, tamed, as the file a run starts
            # from: a reference-style .pth of weights (a fresh optimizer,
            # the step its name gives)
            weights = f'{tmp}/{name}_0_0.pth'
            torch.save(tame_residuals(sds[config]), weights)
            transform = RawResize(cfg) if '--device_augment' in flags \
                else SSDAugmentation(cfg, rng=np.random.RandomState(7))
            data = SyntheticTrainSet(TRAINER_FRAMES, TRAINER_SIZES,
                                     cfg.num_classes, transform)
            save, logs = f'{tmp}/{name}', f'{tmp}/{name}_logs'
            argv = ['--config', name, '--batch_size', '8', '--num_workers',
                    '4', '--save_folder', save, '--log_folder', logs,
                    '--save_interval', '10', '--keep_latest',
                    '--validation_size', str(EVAL_FRAMES)] + flags
            stage(f'{tag}: weights file and data made')
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            first, out, steps, launches, prof = run_trainer(
                argv + ['--validation_epoch', '0', '--resume', weights], data,
                profile=not more)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            total.update(launches)
            print(f'trainer {tag}: {len(steps)} iterations from {weights} in '
                  f'{time.perf_counter() - t0:.1f} s [{card}] (launches '
                  f'{json.dumps(launches)}); its loss lines:')
            print('\n'.join(l for l in out.splitlines() if '||' in l))
            checks(tag, cfg, first, steps, per_step, 0, iters)
            per_step_launches[tag] = steps[0]['launches']
            check(first['state'].cfg.use_device_augment
                  == ('--device_augment' in flags),
                  f'trainer {tag}: use_device_augment not as the flags ask')
            check(os.listdir(save) == [f'{name}_{first["epoch"]}_{iters}.pth'],
                  f'trainer {tag}: checkpoints {os.listdir(save)}')
            if not more:
                timing[tag] = trainer_timing(tag, first, peak, loop_busy(prof),
                                             card, ' (under torch.profiler)',
                                             steps)
                stage(f'{tag}: profile read')
                step_alone(tag, first['state'], dev, card, timing)
                del first
                stage(f'{tag}: step alone timed')
                continue
            timing[tag] = trainer_timing(tag, first, peak, None, card,
                                         steps=steps)

            # the file loads back bit for bit (the run's config: the flags'
            # overrides applied)
            saved = first['state']
            cfg = saved.cfg
            reloaded = create_train_state(cfg, device=dev)
            checkpoint.load_checkpoint(first['path'], reloaded)
            same = states_equal(reloaded, saved)
            stage(f'{tag}: reloaded')
            print(f'trainer {tag}: {first["path"]} reloaded: weights and '
                  f'buffers, momentum, step bit-equal {same}')
            check(all(same), f'trainer {tag}: the reloaded state differs')
            if 'bfloat16' not in flags:
                # one step from each on a fixed batch and fixed draws
                batch = make_train_batch(cfg)
                with deterministic_library():
                    a = train_step(reloaded, batch,
                                   torch.Generator(device=dev).manual_seed(5))
                    b = train_step(saved, batch,
                                   torch.Generator(device=dev).manual_seed(5))
                torch.cuda.synchronize()
                same = states_equal(reloaded, saved)
                losses = all(float(a[k]) == float(b[k]) for k in a
                             if k != 'finite')
                print(f'trainer {tag}: one step from the state in memory and '
                      f'from the reloaded file (deterministic algorithms): '
                      f'losses bit-equal {losses} ({float(a["total"])!r}), '
                      f'weights and buffers, momentum, step bit-equal {same}')
                check(losses and all(same), f'trainer {tag}: the step from '
                      f'the reloaded state differs from the step from memory')
            del reloaded
            stage(f'{tag}: checks of the reloaded state done')
            step_alone(tag, saved, dev, card, timing)
            del saved, first
            stage(f'{tag}: step alone timed')

            # --resume latest for `more` iterations, then validation
            register_config(base.copy(max_iter=iters + more))
            val = SyntheticEvalSet(EVAL_FRAMES, cfg.max_size, cfg.num_classes,
                                   seed=5)
            t0 = time.perf_counter()
            second, out, steps, launches, prof = run_trainer(
                argv + ['--validation_epoch', '1000', '--resume', 'latest'],
                data, val, profile=True)
            total.update(launches)
            print(f'trainer {tag}: resumed run (under torch.profiler, '
                  f'validation included) {time.perf_counter() - t0:.1f} s '
                  f'[{card}]')
            check(second['start_iter'] == iters and steps[0]['step'] == iters
                  and steps[0]['lr'] == learning_rate(cfg, iters),
                  f'trainer {tag}: resumed at step {steps[0]["step"]}, lr '
                  f'{steps[0]["lr"]!r}')
            checks(tag, cfg, second, steps, per_step, iters, iters + more)
            print(f'trainer {tag}: --resume latest from step {iters} at lr '
                  f'{steps[0]["lr"]!r} for {len(steps)} iterations (launches '
                  f'{json.dumps(launches)}); validation on {EVAL_FRAMES} '
                  f'frames:')
            table = [l for l in out.splitlines() if re.match(
                r'\s*(box|mask|-+\+|\s*\|\s+all)', l)]
            print('\n'.join(table))
            timing[tag]['profiled_ms'] = statistics.median(
                second['iter_seconds'][2:]) * 1e3
            check(set(second['maps'] or ()) == {'box', 'mask'}
                  and len(table) == 5, f'trainer {tag}: no mAP table')
            with open(second['log']) as f:
                kinds = collections.Counter(json.loads(l)['type'] for l in f)
            print(f'trainer {tag}: log {second["log"]}: {dict(kinds)}')
            check(kinds['train'] >= 2 and kinds['val'] == 1,
                  f'trainer {tag}: log entries {dict(kinds)}')
            busy = loop_busy(prof) if prof is not None else None
            stage(f'{tag}: resumed run checked, its profile read')
            if busy is not None:
                print(f'trainer {tag}: resumed run device busy {busy[0]!r} ms '
                      f'per iteration, idle share {busy[1]!r} (torch.profiler '
                      f'kernel events, {TRAINER_PROFILE["active"] - 1} '
                      f'iterations) [{card}]')
                timing[tag].update(busy=busy[0], idle=busy[1])
            del second
    f32, bf16 = timing['yolact_base f32'], timing['yolact_base bf16']
    busy = ('not measured' if not (f32['busy'] and bf16['busy'])
            else repr(bf16['busy'] / f32['busy']))
    print(f'trainer yolact_base bf16 against f32: ms per iteration '
          f'{bf16["ms"]!r} / {f32["ms"]!r} = {bf16["ms"] / f32["ms"]!r}, '
          f'the step alone {bf16["step_alone_ms"]!r} / '
          f'{f32["step_alone_ms"]!r} = '
          f'{bf16["step_alone_ms"] / f32["step_alone_ms"]!r}, device busy '
          f'per iteration {busy} [{card}]')
    for host, device in TRAINER_MODES:
        # both under the profiler: a device-augment run and the host run's
        # profiled iterations (its resumed run, where it has one)
        h, d = timing[host], timing[device]
        h_ms = h.get('profiled_ms', h['ms'])
        print(f'trainer {device} against host augment, both under '
              f'torch.profiler: ms per iteration {d["ms"]!r} / {h_ms!r} = '
              f'{d["ms"] / h_ms!r}; the step alone {d["step_alone_ms"]!r} / {h["step_alone_ms"]!r}; loader '
              f'wait share {d["wait_share"]!r} / {h["wait_share"]!r}; device '
              f'idle share {d["idle"]!r} / {h["idle"]!r}; host-to-device bytes '
              f'per batch {d["h2d_bytes"]} / {h["h2d_bytes"]} [{card}]')
    return dict(total), timing, per_step_launches


def step_alone(tag, state, dev, card, timing):
    ms = step_alone_ms(state, state.cfg, dev)
    timing[tag]['step_alone_ms'] = ms
    print(f'trainer {tag}: the step alone on a fixed batch, no loader '
          f'running: median {ms!r} ms (8 steps, CUDA events) against the '
          f'loop\'s {timing[tag]["ms"]!r} ms per iteration [{card}]')


def checks(tag, cfg, summary, steps, per_step, start, end):
    """A trainer run: every step applied with the expected launches, the
    logged losses finite, the iterations as asked."""
    check(summary['iteration'] == end and len(steps) == end - start,
          f'trainer {tag}: ran {len(steps)} steps to {summary["iteration"]}')
    for s in steps:
        check(s['finite'], f'trainer {tag}: step {s["step"]} skipped')
        check(s['launches'] == per_step, f'trainer {tag}: step {s["step"]} '
              f'launches {s["launches"]}, expected {per_step}')
    check(summary['losses'] and all(
        np.isfinite(v) for e in summary['losses'] for v in e['loss'].values()),
        f'trainer {tag}: logged losses {summary["losses"]}')


# ---- phase 8b: device augmentation and the packed transports --------------

AUGMENT_MAX_GT = 100      # the trainer's --max_gt: padding rows warp too


def augment_batch(cfg, seed=8):
    """Eight of phase 8's frames as the device-augment loader ships them:
    RawResize to 550, padded to AUGMENT_MAX_GT gts, the masks bit-packed,
    the image rounded to uint8 (data/loader.py)."""
    data = SyntheticTrainSet(TRAINER_FRAMES, TRAINER_SIZES, cfg.num_classes,
                             RawResize(cfg), seed=seed)
    items = [data.pull_item(i) for i in range(8)]
    batch = pad_batch([it[0] for it in items], [it[1] for it in items],
                      [it[2] for it in items], [it[5] for it in items],
                      AUGMENT_MAX_GT)
    batch = pack_batch_masks(batch)
    batch['image'] = np.clip(np.round(batch['image']), 0, 255).astype(
        np.uint8)
    return batch


@contextlib.contextmanager
def captured_warps(record):
    """Record the affine map (sx, tx, sy, ty) of each device_augment call
    (its masks' warp) in `record`."""
    real = device_augment_module.affine_warp_masks

    def spy(masks, sx, tx, sy, ty):
        record.append(torch.stack([sx, tx, sy, ty], -1))
        return real(masks, sx, tx, sy, ty)

    device_augment_module.affine_warp_masks = spy
    try:
        yield record
    finally:
        device_augment_module.affine_warp_masks = real


def soft_targets64(cfg, masks, maps, rot_k):
    """The device augment's soft mask targets in float64 on the masks'
    device: the warp with the recorded maps, the turn, the resize to the
    proto and seg sizes (before the 0.5 threshold)."""
    sx, tx, sy, ty = maps.double().unbind(-1)
    soft = device_augment_module.affine_warp_masks(masks.double(), sx, tx,
                                                   sy, ty)
    if cfg.augment_random_flip:
        soft = device_augment_module._rot90(soft, rot_k, (2, 3))
    S = soft.shape[-1]
    out = {}
    for name, hw in (('gt_masks_proto', proto_size(cfg, S)),
                     ('gt_masks_seg', seg_size(cfg, S))):
        wh, ww = (torch.from_numpy(resize_weights(S, n)).double().to(
            masks.device) for n in hw)
        out[name] = torch.matmul(torch.matmul(wh, soft), ww.T)
    return out


def device_augment_phase(sds, dev, card):
    """Phase 8b (see the module docstring)."""
    cfg = get_config('yolact_base').copy(use_device_augment=True,
                                         augment_random_flip=True)
    batch = augment_batch(cfg)
    S = cfg.max_size
    print(f'device augment batch (yolact_base {S} b8, max_gt '
          f'{AUGMENT_MAX_GT}): host-to-device bytes '
          f'{json.dumps({k: int(v.nbytes) for k, v in batch.items()})}, '
          f'{batch_bytes(batch)!r} in all, against '
          f'{8 * AUGMENT_MAX_GT * S * S + 8 * S * S * 3 * 4!r} with '
          f'unpacked masks and a float32 image')
    draws = device_augment_module.draw_augment(
        cfg, 8, torch.Generator(device=dev).manual_seed(9), dev)
    on_card = batch_to_device(batch, dev)
    torch.cuda.synchronize()
    # no host sync inside the unpack and the augmentation
    card_maps = []
    with captured_warps(card_maps):
        torch.cuda.set_sync_debug_mode('error')
        try:
            got = prepare_batch(cfg, on_card, draws)
            try:                # the control: a host read must raise here
                got['gt_boxes'].sum().item()
                armed = False
            except RuntimeError:
                armed = True
        finally:
            torch.cuda.set_sync_debug_mode('default')
    check(armed, 'device augment: a host read did not raise under '
          'set_sync_debug_mode(\'error\'), so the mode checked nothing')
    torch.cuda.synchronize()
    print('device augment ran under torch.cuda.set_sync_debug_mode(\'error\')'
          ': no host sync (a .item() there raised, as it must)')
    cpu_maps = []
    t0 = time.perf_counter()
    with captured_warps(cpu_maps):
        want = prepare_batch(cfg, batch_to_device(batch, 'cpu'),
                             {k: v.cpu() for k, v in draws.items()})
    cpu_s = time.perf_counter() - t0
    check(got.keys() == want.keys()
          and {'gt_masks_proto', 'gt_masks_seg'} <= got.keys(),
          f'device augment keys {sorted(got)} / {sorted(want)}')
    check(torch.equal(card_maps[0].cpu(), cpu_maps[0]),
          'device augment: the affine maps (crop windows, expand offsets) '
          'differ between the card and the CPU')
    for k in ('gt_boxes', 'gt_labels', 'num_gts', 'num_crowds'):
        check(torch.equal(got[k].cpu(), want[k]),
              f'device augment {k} differs between the card and the CPU')
    img_err = float((got['image'].cpu() - want['image']).abs().max())
    check(img_err <= 1e-4, f'device augment image off by {img_err!r}')
    soft = soft_targets64(cfg, unpack_bits_last(on_card['gt_masks_packed'], S),
                          card_maps[0], draws['rot_k'])
    ties = {}
    for k in ('gt_masks_proto', 'gt_masks_seg'):
        diff = got[k].cpu() != want[k]
        gap = float((soft[k].cpu()[diff] - 0.5).abs().max()) \
            if diff.any() else None
        ties[k] = (int(diff.sum()), gap)
        check(gap is None or gap <= 1e-6, f'device augment {k}: '
              f'{int(diff.sum())} pixels differ, the float64 value up to '
              f'{gap!r} from 0.5')
        wrong = ((got[k].bool() != (soft[k] > 0.5))
                 & ((soft[k] - 0.5).abs() > 1e-6)).sum()
        check(int(wrong) == 0, f'device augment {k}: {int(wrong)} pixels on '
              f'the other side of the float64 threshold, beyond 1e-6 of it')
    print(f'device augment on the card against the CPU, same batch and '
          f'draws: maps, boxes, labels equal; image max error {img_err!r}; '
          f'mask targets differing (pixels, float64 distance from 0.5) '
          f'{json.dumps(ties)}; the CPU took {cpu_s:.1f} s [{card}]')
    ms = device_ms(lambda: prepare_batch(cfg, on_card, draws), runs=20)
    print(f'device augment yolact_base {S} b8 max_gt {AUGMENT_MAX_GT} (unpack, '
          f'augment, targets): {ms!r} ms of device time per batch (CUDA '
          f'events, 20 calls) [{card}]')
    del got, want, soft, on_card
    torch.cuda.empty_cache()
    packed_step_check(sds, dev, card)


def packed_step_check(sds, dev, card):
    """A train step on the packed transports equals one on the unpacked
    batch: yolact_base with the s2d stem, f32, deterministic algorithms,
    the same draws; the full-resolution masks (gt_masks_packed, a uint8
    image) and the multires targets (their *_packed)."""
    cfg = get_config('yolact_base').copy(stem_s2d=True)
    plain = make_train_batch(cfg)
    plain['image'] = np.clip(np.round(np.abs(plain['image']) * 60), 0,
                             255).astype(np.float32)
    soft = plain['gt_masks'].astype(np.float32)
    multires = {k: v for k, v in plain.items() if k != 'gt_masks'}
    for name, hw in (('proto', proto_size(cfg)), ('seg', seg_size(cfg))):
        multires[f'gt_masks_{name}'] = (resize_bilinear_np(soft, hw)
                                        > 0.5).astype(np.uint8)
    packed_multires = {k: v for k, v in multires.items()
                       if not k.startswith('gt_masks_')}
    for name in ('proto', 'seg'):
        packed_multires[f'gt_masks_{name}_packed'] = pack_bits_last(
            multires[f'gt_masks_{name}'])
    packed = dict(pack_batch_masks(plain), image=plain['image'].astype(
        np.uint8))
    state = create_train_state(cfg, device=dev,
                               state_dict=tame_residuals(sds['yolact_base']))
    p = state.model.priors(cfg.max_size, cfg.max_size, dev).shape[0]
    draws = draw_priorities(cfg, 8, p, torch.Generator(
        device=dev).manual_seed(2), dev)
    results, conf = {}, state.conf_state
    with deterministic_library():
        for tag, b in (('unpacked', plain), ('gt_masks_packed', packed),
                       ('multires', multires),
                       ('multires_packed', packed_multires)):
            out = loss_and_grads(state, b, *draws)
            results[tag] = {k: float(v) for k, v in out.items()}
            drop_batch_stats(state.model)
            state.conf_state = conf
    for a, b in (('unpacked', 'gt_masks_packed'),
                 ('multires', 'multires_packed')):
        check(results[a] == results[b], f'packed step: {b} losses '
              f'{results[b]} differ from {a} {results[a]}')
    print(f'train step on packed inputs, yolact_base s2d {cfg.max_size} b8 f32 '
          f'(deterministic algorithms): losses bit-equal to the unpacked '
          f'batch\'s: {json.dumps(results)} [{card}]')


# ---- phase 10: data parallelism ------------------------------------------

# Two gloo ranks share the one card (NCCL refuses two ranks on one device):
# yolact_plus_base at 550 with the s2d stem, f32, batch statistics, a
# global batch of 8 (4 a rank), against the one-process b8 step
DP_CONFIG = 'yolact_plus_base'
DP_OVERRIDES = dict(stem_s2d=True, train_remat='dcn', lr=1e-4,
                    lr_warmup_init=1e-7)
DP_WORLD = 2
DP_PER_STEP = dict(stem_s2d=1, dcn=22, dcn_col2im=11)
DP_GRADS = ('backbone.conv1.weight', DCN0 + 'conv_offset_mask.weight',
            DCN0 + 'weight')
DP_TIMED_STEPS = 3
DP_SECONDS = 600     # a rank that gives no result in this long fails
# Phase 12: the same config, batch and seeds on data 1 x space 2 (two gloo
# ranks on the card, each the rows of all 8 images); per rank per step the
# same launches as one process (the DCN blocks' replays included)
SP_SPACE = 2
SP_TIMED_STEPS = 2
# phase 12(a)'s checked steps: one, so that phase 13 fits the run's time
# limit; losses, gradients, the ranks' bit-equality, the control and the
# launches are all checked on it
SP_CHECKED_STEPS = 1
SP_INFER_RUNS = (('b1 f32', 'float32', 1), ('b8 bf16', 'bfloat16', 8))


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def state_digest(state):
    """A sha256 of every weight and buffer (the rank's bits)."""
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(state.model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_collectives(record):
    """torch.distributed's collectives timed into `record` (seconds, the
    card synchronised before and after each, so that a collective's time
    is its own and not the queued work's it waits for)."""
    import torch.distributed as dist
    real = {name: getattr(dist, name)
            for name in ('all_reduce', 'all_gather', 'broadcast', 'barrier')}

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            record.append(time.perf_counter() - t0)
            return out
        return call
    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        yield record
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def dp_config():
    return get_config(DP_CONFIG).copy(**DP_OVERRIDES)


def dp_steps(state, batch, generator, grad_names, steps=TRAIN_STEPS):
    """`steps` steps of `batch` (a rank's rows, or the global batch): the
    losses and launches of each, the named first-step gradients (on the
    host) and the state's digest after each."""
    params = dict(state.model.named_parameters())
    losses, launches, digests, grads = [], [], [], None
    for _ in range(steps):
        reset_launches()
        out = train_step(state, batch, generator)
        torch.cuda.synchronize()
        launches.append(read_launches(TRAIN_KERNELS))
        losses.append({k: float(v) for k, v in out.items()})
        digests.append(state_digest(state))
        if grads is None:
            grads = {k: params[k].grad.detach().cpu().clone()
                     for k in grad_names}
    return losses, launches, digests, grads


def dp_rank(rank, port, sd_path, results):
    """One rank of phase 10(a), in a process of its own (spawn): the gloo
    group on cuda:0, TRAIN_STEPS steps on its rows of the global batch,
    then a step with a NaN pixel in rank 1's first image, then
    DP_TIMED_STEPS timed steps with the collectives timed, then the
    control: the first step again from the same weights with each rank's
    own batch-norm moments (what DistributedDataParallel computes).  Puts
    (rank, True, result) or (rank, False, traceback) on `results`."""
    import traceback
    from yolact_tpu_torch.parallel import mesh as parallel
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    try:
        dev = torch.device('cuda', 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load()
        mesh = parallel.init_from_env('gloo', device=dev)
        cfg = dp_config()
        sd = torch.load(sd_path)
        state = create_train_state(cfg, state_dict=sd, mesh=mesh)
        batch = parallel.shard_batch(make_train_batch(cfg), rank, DP_WORLD)
        gen = torch.Generator(device=dev).manual_seed(11)
        with deterministic_library():
            losses, launches, digests, grads = dp_steps(state, batch, gen,
                                                        DP_GRADS)
            bad = dict(batch, image=batch['image'].copy())
            if rank == 1:
                bad['image'][0, 5, 5, 0] = np.nan
            nan = train_step(state, bad, gen)
            nan = dict(finite=nan['finite'],
                       total=float(nan['total']), digest=state_digest(state))
        times, collective = [], []
        train_step(state, batch, gen)                   # warm
        for _ in range(DP_TIMED_STEPS):
            record = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timed_collectives(record):
                train_step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            collective.append(sum(record))
            count = len(record)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del state
        control = create_train_state(cfg, state_dict=sd, mesh=mesh)
        for m in control.model.modules():
            if isinstance(m, BatchNorm2d):
                m.mesh = None
        with deterministic_library():
            c_losses, _, _, c_grads = dp_steps(
                control, batch, torch.Generator(device=dev).manual_seed(11),
                DP_GRADS, steps=1)
        results.put((rank, True, dict(
            losses=losses, launches=launches, digests=digests,
            grads={k: v.numpy() for k, v in grads.items()}, nan=nan,
            ms=[t * 1e3 for t in times],
            collective_ms=[t * 1e3 for t in collective],
            collectives=count, peak_gib=peak,
            control=dict(losses=c_losses[0], grads={
                k: v.numpy() for k, v in c_grads.items()}))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        parallel.destroy()


def run_dp_ranks(sd_path):
    """DP_WORLD spawned dp_rank processes; their results in rank order.
    A rank that fails, or gives nothing in DP_SECONDS, fails the phase
    (every rank is stopped)."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=dp_rank, args=(rank, port, sd_path, results))
             for rank in range(DP_WORLD)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < DP_WORLD:
            try:
                rank, ok, value = results.get(timeout=DP_SECONDS)
            except queue.Empty:
                raise RuntimeError(f'chip_smoke: phase 10 ranks '
                                   f'{sorted(set(range(DP_WORLD)) - set(got))}'
                                   f' gave no result in {DP_SECONDS} s')
            check(ok, f'phase 10 rank {rank} failed:\n{value}')
            got[rank] = value
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [got[r] for r in range(DP_WORLD)]


def one_process_steps(sd, dev, timed=SP_TIMED_STEPS):
    """The one-process b8 step that phases 10 and 12 hold their ranks to:
    TRAIN_STEPS steps of dp_config() from tame_residuals(sd) on
    make_train_batch's global batch (dp_steps: losses, launches, the
    DP_GRADS of the first step), then `timed` more timed; with the peak
    memory allocated over what the process held before (GiB) and the
    median ms a step (host clock, synchronised)."""
    cfg = dp_config()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = make_train_batch(cfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    with deterministic_library():
        state = create_train_state(cfg, device=dev,
                                   state_dict=tame_residuals(sd))
        losses, launches, _, grads = dp_steps(state, batch, gen, DP_GRADS)
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del state
    torch.cuda.empty_cache()
    return dict(losses=losses, launches=launches, grads=grads, peak_gib=peak,
                ms=ms)


def dp_two_ranks(sd, dev, card):
    """Phase 10(a), see the module docstring.  Returns the launches per
    rank per step and the one-process run (one_process_steps)."""
    tag = f'dp {DP_CONFIG} 550 b8 f32 ({DP_WORLD} gloo ranks on one card)'
    one = one_process_steps(sd, dev)
    losses, launches, grads = one['losses'], one['launches'], one['grads']
    sd = tame_residuals(sd)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_') as tmp:
        path = os.path.join(tmp, 'weights.pth')
        torch.save(sd, path)
        t0 = time.perf_counter()
        ranks = run_dp_ranks(path)
    print(f'{tag}: ranks done in {time.perf_counter() - t0:.1f} s [{card}]')
    for step in range(TRAIN_STEPS):
        print(f'{tag} step {step}: one process {json.dumps(losses[step])}; '
              f'ranks {json.dumps([r["losses"][step] for r in ranks])}')
        check(len({r['digests'][step] for r in ranks}) == 1,
              f'{tag}: the ranks\' weights differ after step {step}')
        for rank, run in enumerate(ranks):
            got = run['losses'][step]
            check(got['finite'] and got.keys() == losses[step].keys(),
                  f'{tag}: rank {rank} step {step} {got}')
            for k, v in losses[step].items():
                if k in ('finite', 'lr'):
                    continue
                check(np.isfinite(got[k]) and abs(got[k] - v) <= 1e-4 * abs(v),
                      f'{tag}: rank {rank} step {step} loss {k} {got[k]!r} '
                      f'against {v!r}')
            check(run['launches'][step] == DP_PER_STEP,
                  f'{tag}: rank {rank} step {step} launches '
                  f'{run["launches"][step]}, expected {DP_PER_STEP}')
        check(launches[step] == DP_PER_STEP,
              f'{tag}: one-process launches {launches[step]}')
    print(f'{tag}: both ranks\' weights bit-equal after each of '
          f'{TRAIN_STEPS} steps; launches per rank per step '
          f'{json.dumps(ranks[0]["launches"][0])}')
    # Under batch statistics the two runs' forwards differ by rounding from
    # the first batch norm on (the moments are summed in another order),
    # and the random network carries that to its first gradients as it
    # carries the stem kernel's: phase 9's rule, every gradient within
    # STEM_BATCH_STATS_LIMIT.  The control (each rank's own moments, what
    # DistributedDataParallel computes) must fail it or the losses' 1e-4.
    rel = STEM_BATCH_STATS_LIMIT
    gaps = {}
    for name in DP_GRADS:
        want = grads[name]
        top = float(want.abs().max())
        err, control = (float(np.abs(g - want.numpy()).max()) for g in (
            ranks[0]['grads'][name], ranks[0]['control']['grads'][name]))
        gaps[name] = control / top
        print(f'{tag} first-step gradient of {name}: max {top!r}, '
              f'max_abs_err against one process {err!r} ({err / top!r} of '
              f'max; criterion {rel!r}); with each rank\'s own batch-norm '
              f'moments {control!r} ({control / top!r} of max)')
        check(top > 0 and err <= rel * top,
              f'{tag}: the gradient of {name} differs')
    loss_gap = max(abs(ranks[0]['control']['losses'][k] - v) / abs(v)
                   for k, v in losses[0].items() if k not in ('finite', 'lr'))
    print(f'{tag}: control with each rank\'s own batch-norm moments: first '
          f'losses {json.dumps(ranks[0]["control"]["losses"])}, largest '
          f'relative difference {loss_gap!r}')
    check(loss_gap > 1e-4 or max(gaps.values()) > rel,
          f'{tag}: per-rank batch-norm moments pass the checks: they have '
          f'no teeth')
    nans = [r['nan'] for r in ranks]
    print(f'{tag}: a NaN pixel in rank 1\'s image: {json.dumps(nans)}')
    check(not any(n['finite'] for n in nans), f'{tag}: a rank did not skip '
          f'the NaN step')
    check(all(n['digest'] == r['digests'][-1] for n, r in zip(nans, ranks)),
          f'{tag}: the skipped step moved the weights')
    for rank, run in enumerate(ranks):
        ms, coll = statistics.median(run['ms']), \
            statistics.median(run['collective_ms'])
        print(f'{tag} rank {rank}: median {ms!r} ms per step ({run["ms"]}, '
              f'host clock, synchronised), collectives {coll!r} ms of it '
              f'(share {coll / ms!r}; {run["collectives"]} collectives a '
              f'step, each timed between two synchronisations); peak memory '
              f'{run["peak_gib"]!r} GiB [{card}]')
    return ranks[0]['launches'][0], one


def dp_trainer(sd, dev, card, one_device_ms):
    """Phase 10(b): cli/train.train(['--distributed', ...]) at world size 1
    over NCCL, yolact_base --stem_s2d bf16 550 b8, 10 iterations on phase
    8's in-memory frames."""
    from yolact_tpu_torch.parallel import mesh as parallel
    tag = 'dp trainer yolact_base bf16 (NCCL, world size 1)'
    iters = 10
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_trainer_') as tmp:
        name = 'smoke_dp_trainer'
        cfg = register_config(get_config('yolact_base').copy(
            name=name, lr=1e-4, lr_warmup_init=1e-7, max_iter=iters))
        weights = f'{tmp}/{name}_0_0.pth'
        torch.save(tame_residuals(sd), weights)
        data = SyntheticTrainSet(TRAINER_FRAMES, TRAINER_SIZES,
                                 cfg.num_classes, SSDAugmentation(
                                     cfg, rng=np.random.RandomState(7)))
        save = f'{tmp}/w'
        env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()))
        # the machine has no network: NCCL's bootstrap takes the loopback
        env.setdefault('NCCL_SOCKET_IFNAME', os.environ.get(
            'NCCL_SOCKET_IFNAME', 'lo'))
        before = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            summary, out, steps, launches, _ = run_trainer(
                ['--distributed', '--config', name, '--batch_size', '8',
                 '--num_workers', '4', '--save_folder', save, '--log_folder',
                 f'{tmp}/logs', '--validation_epoch', '0', '--resume',
                 weights, '--stem_s2d', '--compute_dtype', 'bfloat16'], data)
        finally:
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            parallel.destroy()
        checks(tag, cfg, summary, steps,
               dict(stem_s2d=1, dcn=0, dcn_col2im=0), 0, iters)
        check(summary['path'] and os.path.exists(summary['path'])
              and os.listdir(save) == [os.path.basename(summary['path'])],
              f'{tag}: checkpoints {os.listdir(save)}')
        ms = statistics.median(t * 1e3 for t in summary['iter_seconds'][2:])
        print(f'{tag}: {len(steps)} iterations, every step applied and every '
              f'logged loss finite, {summary["path"]} written by rank 0; '
              f'median {ms!r} ms per iteration against phase 8\'s one-device '
              f'run {one_device_ms!r} (host clock; launches '
              f'{json.dumps(launches)}) [{card}]')
        print('\n'.join(l for l in out.splitlines() if '||' in l))


def dp_eval(sd, dev, card):
    """Phase 10(c): evaluate_dataset with n_devices=0 (every local device:
    one here) against n_devices=1 on phase 5's frames."""
    cfg = get_config('yolact_base').copy(stem_s2d=True)
    data = SyntheticEvalSet(EVAL_FRAMES, cfg.max_size, cfg.num_classes,
                            seed=5)
    wsd = shape_conf(sd, cfg.num_classes, 3.0, 7.0)
    check(evaluate.eval_devices(dev, 0) == [dev],
          f'n_devices=0 resolves to {evaluate.eval_devices(dev, 0)}')
    maps = {}
    for n in (1, 0):
        with contextlib.redirect_stdout(io.StringIO()):
            maps[n] = evaluate_dataset(cfg, wsd, data, dev, eval_batch_size=8,
                                       n_devices=n)
    print(f'dp eval: n_devices=0 resolves to {torch.cuda.device_count()} '
          f'device(s); all_maps equal to n_devices=1: {maps[0] == maps[1]} '
          f'(box all {maps[0]["box"]["all"]!r}, mask all '
          f'{maps[0]["mask"]["all"]!r}) [{card}]')
    check(maps[0] == maps[1], 'dp eval: n_devices=0 and 1 differ')


def c5_pipeline(sd, frames8, dev, want):
    """Phase 10(d): Pipeline(yolact_base) f32 b1 built under the process's
    default TF32 flags against phase 4's TF32-off output, by phase 4's f32
    rule."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = get_config('yolact_base')
    pipe = Pipeline(cfg, shape_conf(sd, cfg.num_classes, 3.0, 7.0), dev,
                    'float32')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    print(f'C5: after Pipeline(float32) the TF32 flags (cudnn, matmul) are '
          f'{flags}')
    check(flags == (False, False), 'C5: a float32 Pipeline left TF32 on')
    compare('C5 Pipeline(yolact_base) f32 b1 under the default flags vs '
            'phase 4', pipe(frames8[:1]), want, exact=True, ties_ok=True)
    # the control: the same pipeline with TF32 turned back on
    torch.backends.cudnn.allow_tf32 = True
    tf32 = pipe(frames8[:1])
    torch.backends.cudnn.allow_tf32 = False
    both = tf32.valid & want.valid
    err = float((tf32.scores - want.scores)[both].abs().max())
    print(f'C5 control, the same Pipeline with cuDNN\'s TF32 on: scores '
          f'{err!r} from phase 4\'s (f32 rule {TOL["scores"]!r}), '
          f'{int((tf32.valid != want.valid).sum())} validity differences')
    check(err > TOL['scores'] or bool((tf32.valid != want.valid).any()),
          'C5: TF32 leaves the f32 output within the f32 rule: the check '
          'has no teeth')


def dp_phase(sds, frames8, dev, card, one_device_ms, c5_want):
    """Phase 10 (see the module docstring).  Returns the launches per rank
    per step of the two-rank run and the one-process run it was held to
    (one_process_steps)."""
    t0 = time.perf_counter()
    launches, one = dp_two_ranks(sds[DP_CONFIG], dev, card)
    print(f'phase 10(a): {time.perf_counter() - t0:.1f} s')
    dp_trainer(sds['yolact_base'], dev, card, one_device_ms)
    dp_eval(sds['yolact_base'], dev, card)
    c5_pipeline(sds['yolact_base'], frames8, dev, c5_want)
    return launches, one


# ---- phase 11: export ------------------------------------------------------

# The exported model: yolact_plus_base launches all four forward kernels
# (the s2d stem, DCN sampling, the IoU max and mask assembly)
EXPORT_PATH = 'yolact_plus_base'
EXPORT_RUNS = (('b1 f32', 'float32', 1), ('b8 bf16', 'bfloat16', 8))
EXPORT_KERNELS = ('fast_nms_iou_max', 'mask_assembly', 'dcn', 'stem_s2d')
EXPORT_SECONDS = 900   # the fresh process's limit
# The fresh process that loads the artifacts and runs them beside a
# Pipeline on the same weights: it imports torch and the port, nothing else
# of the repo; argv[1] is a JSON spec (config, state dict, frames,
# artifacts, timed runs, where to save its results)
EXPORT_WORKER = r'''
import json, statistics, sys, time
import numpy as np
import torch
from yolact_tpu_torch import get_config
from yolact_tpu_torch.convert.export import load_exported
from yolact_tpu_torch.detect import detection
from yolact_tpu_torch.infer import Pipeline
from yolact_tpu_torch.kernels import dcn, mask_assembly, nms, stem

spec = json.loads(sys.argv[1])
counters = {'fast_nms_iou_max': (nms, 'launches'),
            'mask_assembly': (mask_assembly, 'launches'),
            'dcn': (dcn, 'launches'), 'stem_s2d': (stem, 'launches'),
            'dcn_col2im': (dcn, 'col2im_launches')}
cfg = get_config(spec['config'])
state_dict = torch.load(spec['state_dict'])
frames = torch.load(spec['frames'])


def counted(fn, x):
    for module, attr in counters.values():
        setattr(module, attr, 0)
    out = fn(x)
    torch.cuda.synchronize()
    return out, {k: getattr(m, a) for k, (m, a) in counters.items()}


def time_ms(fn, x):
    for _ in range(5):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(spec['runs']):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), float(np.percentile(times, 90))


results = {}
for tag, path, batch, dtype in spec['artifacts']:
    t0 = time.perf_counter()
    runner = load_exported(path)
    load_s = time.perf_counter() - t0
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    pipe = Pipeline(cfg, state_dict, runner.device, dtype)
    x = frames[:batch].to(runner.device)
    out, launches = counted(runner, x)
    branches = dict(detection.branch_counts)
    want, pipe_launches = counted(pipe, x)
    branches = {k: detection.branch_counts[k] - n
                for k, n in branches.items()}
    ms = {'artifact': [], 'pipeline': []}
    for which in ('pipeline', 'artifact', 'artifact', 'pipeline'):
        ms[which].append(time_ms(runner if which == 'artifact' else pipe, x))
    results[tag] = dict(
        load_s=load_s, tf32=tf32, meta=runner.meta, launches=launches,
        pipeline_launches=pipe_launches, branches=branches, ms=ms,
        out=[t.cpu() for t in out],
        pipeline_out={k: v.cpu() for k, v in want._asdict().items()
                      if v is not None})
    del runner, pipe, out, want
torch.save(results, spec['out'])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'flax', 'yolact_tpu', 'chip_smoke'))
assert not bad, bad
print('export worker ok')
'''


def on_card(fields, tensors):
    """InferenceOutput(**dict(zip(fields, tensors))), moved to the card."""
    return InferenceOutput(**{name: t.to(torch.device('cuda', 0))
                              for name, t in zip(fields, tensors)})


def export_phase(sd, frames8, dev, card):
    """Phase 11 (see the module docstring).  Returns the artifact's
    launches per call by run."""
    cfg = config_named(EXPORT_PATH)
    _, scale, bias, branch = [c for c in PATHS[EXPORT_PATH]['cells']
                              if c[0] == 'sparse'][0]
    wsd = shape_conf(sd, cfg.num_classes, scale, bias)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_export_') as tmp:
        artifacts = []
        for tag, dtype, batch in EXPORT_RUNS:
            path = os.path.join(tmp, tag.replace(' ', '_') + '.pt2')
            t0 = time.perf_counter()
            meta = export_inference(cfg, wsd, path, batch_size=batch,
                                    device=dev, compute_dtype=dtype)
            seconds = time.perf_counter() - t0
            check(meta['fields'][-1] == 'mask_scores'
                  and meta['compute_dtype'] == dtype,
                  f'export {tag}: meta {meta}')
            print(f'export {EXPORT_PATH} {cfg.max_size} {tag}: export and '
                  f'save {seconds!r} s, {os.path.getsize(path)} bytes '
                  f'[{card}]')
            artifacts.append((tag, path, batch, dtype))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        paths = {name: os.path.join(tmp, name + '.pt')
                 for name in ('frames', 'state_dict', 'worker')}
        torch.save(frames8.cpu(), paths['frames'])
        torch.save(wsd, paths['state_dict'])
        spec = dict(config=cfg.name, state_dict=paths['state_dict'],
                    frames=paths['frames'], out=paths['worker'],
                    artifacts=artifacts, runs=RUNS)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', EXPORT_WORKER, json.dumps(spec)],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=EXPORT_SECONDS)
        print(f'export worker: {time.perf_counter() - t0!r} s (a fresh '
              f'process: start, load both artifacts, run and time them '
              f'beside Pipeline)')
        check(proc.returncode == 0, f'export worker failed:\n'
              f'{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}')
        results = torch.load(paths['worker'])

    # the same Pipeline in this process (information: another process
    # may pick other cuDNN algorithms)
    res = results[EXPORT_RUNS[0][0]]
    here = Pipeline(cfg, wsd, dev, EXPORT_RUNS[0][1])(
        frames8[:EXPORT_RUNS[0][2]])
    there = on_card(res['meta']['fields'], [res['pipeline_out'][k] for k in
                                            res['meta']['fields']])
    score_gap = float((here.scores - there.scores).abs().max())
    print(f'export: Pipeline {EXPORT_RUNS[0][0]} in this process against the '
          f'fresh one\'s: {int((here.valid != there.valid).sum())} validity '
          f'and {int((here.classes != there.classes).sum())} class slots '
          f'differ, scores by {score_gap!r} (not checked) [{card}]')
    del here, there

    launches = {}
    for tag, dtype, batch in EXPORT_RUNS:
        res = results[tag]
        fields = res['meta']['fields']
        got = on_card(fields, res['out'])
        want = on_card(fields, [res['pipeline_out'][k] for k in fields])
        check_output(f'export {tag}', got, cfg, batch)
        check(res['branches'][branch] == 1,
              f'export {tag}: Pipeline took {res["branches"]}, not the '
              f'{branch} NMS tail')
        if dtype == 'float32':
            check(res['tf32'] == (False, False),
                  f'export {tag}: loading left TF32 on {res["tf32"]}')
            compare(f'export {tag} artifact vs Pipeline', got, want,
                    exact=True, ties_ok=True)
        else:
            match(f'export {tag} artifact vs Pipeline', got, want)
        print(f'export {tag} launches per call: artifact '
              f'{json.dumps(res["launches"])}, Pipeline '
              f'{json.dumps(res["pipeline_launches"])}')
        for name in KERNELS:
            n = res['launches'][name]
            check(n == res['pipeline_launches'][name],
                  f'export {tag}: {name} launched {n} times a call, '
                  f'Pipeline {res["pipeline_launches"][name]}')
            check((n > 0) == (name in EXPORT_KERNELS),
                  f'export {tag}: {name} launched {n} times a call')
        launches[tag] = res['launches']
        (a1, a1_90), (a2, a2_90) = res['ms']['artifact']
        (p1, p1_90), (p2, p2_90) = res['ms']['pipeline']
        print(f'export {EXPORT_PATH} {cfg.max_size} {tag}: artifact median '
              f'{a1!r} / {a2!r} ms/batch, p90 {a1_90!r} / {a2_90!r}; '
              f'Pipeline median {p1!r} / {p2!r} ms/batch, p90 {p1_90!r} / '
              f'{p2_90!r} (one process, Pipeline, artifact, artifact, '
              f'Pipeline; {RUNS} calls each, CUDA events); load '
              f'{res["load_s"]!r} s [{card}]')
    dispatch_timing(dev, card)
    return launches


def host_us(fn, calls=200):
    """Host microseconds per call of `fn`, queued behind a device spin so
    that the card never holds the host back (no synchronisation inside)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(5 * QUEUE_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def dispatch_timing(dev, card):
    """Each custom op's call against its bare ctypes launch at b1 shapes
    (yolact_plus_base 550, bf16; dcn_col2im f32 as in training): host us
    per call (op, launch, launch, op) and device ms per call."""
    g = torch.Generator().manual_seed(12)
    proto, coeffs, boxes = mask_inputs(g, dev, 1, 100)
    nms_boxes = iou_inputs(g, dev, 80, 200)
    x, w2 = (torch.randn(shape, generator=g).to(dev, torch.bfloat16)
             for shape in ((1, 12, 275, 275), (64, 12, 4, 4)))
    # the layers.2 blocks 3-21 shape (DCN_SHAPES)
    dims = (1, 256, 35, 35, 35, 35, 3, 1, 1, 1, 0)
    xb, offset, dmask = dcn_inputs(g, dev, 1, 256, 35, 1, torch.bfloat16,
                                   finite=True)
    xh = xb.permute(0, 2, 3, 1).contiguous()
    xf, mf = xh.float(), dmask.float()
    g_cols = torch.randn(35 * 35, 9 * 256, generator=g).to(dev)
    ops = torch.ops.yolact_tpu_torch
    cases = {
        'mask_assembly': (lambda: ops.mask_assembly(proto, coeffs, boxes, 1),
                          lambda: mask_assembly._launch(proto, coeffs, boxes,
                                                        1)),
        'fast_nms_iou_max': (lambda: ops.nms_iou_max(nms_boxes),
                             lambda: nms._launch(nms_boxes)),
        'stem_s2d': (lambda: ops.stem_s2d(x, w2),
                     lambda: stem._launch(x, w2)),
        'dcn': (lambda: ops.dcn_columns(xh, offset, dmask, list(dims)),
                lambda: dcn._launch_im2col(xh, offset, dmask, dims)),
        'dcn_col2im': (lambda: ops.dcn_col2im(g_cols, xf, offset, mf,
                                              list(dims)),
                       lambda: dcn._launch_col2im(g_cols, xf, offset, mf,
                                                  dims)),
    }
    for name, (op, launch) in cases.items():
        got, want = ((out,) if torch.is_tensor(out) else out
                     for out in (op(), launch()))
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            if name == 'dcn_col2im' and i == 0:
                # grad_x: atomics add in another order from run to run
                same = torch.allclose(a, b, rtol=0,
                                      atol=1e-5 * float(b.abs().max()))
            else:
                same = bool(((a == b) | (a.isnan() & b.isnan())).all())
            check(same and a.dtype == b.dtype,
                  f'dispatch {name}: the op and the launch disagree')
        us = {'op': [], 'launch': []}
        for which in ('op', 'launch', 'launch', 'op'):
            us[which].append(host_us(op if which == 'op' else launch))
        dev_ms = {which: device_ms(fn) for which, fn in
                  (('op', op), ('launch', launch))}
        op_us, launch_us = (statistics.mean(us[k]) for k in ('op', 'launch'))
        print(f'dispatch {name} b1: op {us["op"]} us, bare launch '
              f'{us["launch"]} us a call (host, 200 calls queued behind a '
              f'device spin); op - launch {op_us - launch_us!r} us; device '
              f'{dev_ms["op"]!r} / {dev_ms["launch"]!r} ms a call [{card}]')


# ---- phase 11b: deformable PSRoI pooling ----------------------------------

# R-FCN's position-sensitive layout at the stride-8 map of a 550 frame:
# 7 x 7 bins, 7 x 7 groups, 8 channels each, 128 RoIs, 4 x 4 samples a bin
PSROI = dict(spatial_scale=1 / 8, pooled_size=7, output_dim=8, group_size=7,
             sample_per_part=4, trans_std=0.1)
PSROI_TOL = 1e-4


def psroi_phase(dev, card):
    """kernels/psroi.py (plain PyTorch; no CUDA kernel) on the card against
    the CPU on the same seeded inputs: the function (deformable and not),
    its gradients in x and trans, and the module with seeded weights (the
    last FC non-zero).  Outputs within PSROI_TOL, gradients within
    PSROI_TOL of their largest entry: the sample coordinates reach 69 px,
    where a float32 ulp is 7.6e-6, and the card rounds them (fused
    multiply-adds) otherwise than the CPU, which moves a bilinear weight
    by an ulp times the map's local slope (a few units here); the card's
    gather backward adds with atomics in another order."""
    gen = torch.Generator().manual_seed(13)
    n, h = 128, 69
    x = torch.randn(2, h, h, 8 * 49, generator=gen)
    xy = torch.rand(n, 2, generator=gen) * 500
    wh = torch.rand(n, 2, generator=gen) * 280 + 16
    rois = torch.cat([torch.randint(0, 2, (n, 1), generator=gen).float(),
                      xy, xy + wh], 1)
    trans = torch.randn(n, 2, 7, 7, generator=gen)
    cot = torch.randn(n, 8, 7, 7, generator=gen)
    errs = {}
    for no_trans in (True, False):
        outs = []
        for d in ('cpu', dev):
            leaves = [t.detach().to(d).requires_grad_() for t in (x, trans)]
            out = psroi.deform_psroi_pool(
                leaves[0], rois.to(d), None if no_trans else leaves[1],
                no_trans=no_trans, **PSROI)
            (out * cot.to(d)).sum().backward()
            outs.append([out.detach().cpu()] + [
                t.grad.cpu() if t.grad is not None else None for t in leaves])
        (cpu, card_) = outs
        errs[no_trans] = float((cpu[0] - card_[0]).abs().max())
        check(errs[no_trans] <= PSROI_TOL
              and float(cpu[0].abs().max()) > 0.1,
              f'psroi no_trans={no_trans}: card and CPU differ by '
              f'{errs[no_trans]!r}')
        for i, name in ((1, 'x'), (2, 'trans')):
            if cpu[i] is None:
                continue
            gerr = float((cpu[i] - card_[i]).abs().max())
            top = float(cpu[i].abs().max())
            print(f'psroi no_trans={no_trans} grad_{name}: card vs CPU '
                  f'{gerr!r} (max {top!r})')
            check(top > 0 and gerr <= PSROI_TOL * top,
                  f'psroi grad_{name} differs by {gerr!r}')
    torch.manual_seed(14)
    mod = psroi.DeformRoIPooling(deform_fc_dim=1024, **PSROI)
    with torch.no_grad():
        mod.offset_mask_fc[4].weight.normal_(0, 0.02)
        mod.offset_mask_fc[4].bias.normal_(0, 0.5)
        want = mod(x, rois)
        mod.to(dev)
        got = mod(x.to(dev), rois.to(dev)).cpu()
        xd, rd = x.to(dev), rois.to(dev)
        ms = device_ms(lambda: mod(xd, rd), runs=20)
    merr = float((got - want).abs().max())
    check(merr <= PSROI_TOL and float((want - 0.5 * psroi.deform_psroi_pool(
        x, rois, None, no_trans=True, **PSROI)).abs().max()) > 1e-3,
        f'psroi module: card and CPU differ by {merr!r}')
    print(f'psroi [2,69,69,392], 128 RoIs, 7x7: card vs CPU forward '
          f'{errs[True]!r} (no_trans), {errs[False]!r} (deformable), module '
          f'{merr!r}; the module {ms!r} ms a call on the card (plain PyTorch, '
          f'no kernel) [{card}]')


# ---- phase 12: spatial partitioning --------------------------------------

def sp_infer_config():
    """Phase 12(b)'s inference: yolact_plus_base with the s2d stem (as
    Pipeline takes raw frames) and its sparse cell's weights shaping."""
    cfg = config_named(DP_CONFIG)
    _, scale, bias, branch = [c for c in PATHS[DP_CONFIG]['cells']
                              if c[0] == 'sparse'][0]
    return cfg, scale, bias


def sp_rank(rank, port, paths, results):
    """One rank of phase 12, in a process of its own (spawn): the gloo
    group on cuda:0 split data 1 x space SP_SPACE; (a) SP_CHECKED_STEPS steps
    of the global b8 batch, its rows of every map on this rank, then
    SP_TIMED_STEPS timed steps, one more with its collectives timed, then
    the control (the first step again with the head outputs' gather taking
    the 'own' gradient, summed over the ranks); (b) Pipeline under the
    mesh on the raw frames, per SP_INFER_RUNS.  Puts (rank, True, result)
    or (rank, False, traceback) on `results`."""
    import traceback
    from yolact_tpu_torch.models import heads
    from yolact_tpu_torch.parallel import mesh as parallel
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SP_SPACE),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    try:
        dev = torch.device('cuda', 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load()
        mesh = parallel.make_mesh_2d(
            parallel.init_from_env('gloo', device=dev), SP_SPACE)
        cfg = dp_config()
        sd = torch.load(paths['train_sd'])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(cfg, state_dict=sd, mesh=mesh)
        batch = make_train_batch(cfg)        # data 1: all of the batch
        gen = torch.Generator(device=dev).manual_seed(11)
        with deterministic_library():
            losses, launches, digests, grads = dp_steps(
                state, batch, gen, DP_GRADS, steps=SP_CHECKED_STEPS)
        times = []
        for _ in range(SP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        # the collectives' share from one more step with each collective
        # timed (two synchronisations each, so this step runs slower)
        record = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_collectives(record):
            train_step(state, batch, gen)
        torch.cuda.synchronize()
        timed_step = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del state
        real = heads.gather_rows
        heads.gather_rows = lambda x, rows, grad: real(x, rows, 'own')
        try:
            control = create_train_state(cfg, state_dict=sd, mesh=mesh)
            with deterministic_library():
                c_losses, _, _, c_grads = dp_steps(
                    control, batch,
                    torch.Generator(device=dev).manual_seed(11), DP_GRADS,
                    steps=1)
        finally:
            heads.gather_rows = real
        del control
        torch.cuda.empty_cache()
        icfg, _, _ = sp_infer_config()
        frames = torch.load(paths['frames']).to(dev)
        wsd = torch.load(paths['infer_sd'])
        infer = {}
        for tag, dtype, b in SP_INFER_RUNS:
            pipe = Pipeline(icfg, wsd, dev, dtype, mesh=mesh)
            pipe(frames[:b])                                  # warm
            reset_launches()
            out = pipe(frames[:b])
            torch.cuda.synchronize()
            calls = read_launches(KERNELS)
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe(frames[:b])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            # numpy: a tensor on the queue would be shared through a file
            # descriptor that dies with this process
            infer[tag] = dict(out={k: v.cpu().numpy() for k, v
                                   in out._asdict().items() if v is not None},
                              launches=calls, ms=ms)
            del pipe
        results.put((rank, True, dict(
            losses=losses, launches=launches, digests=digests,
            grads={k: v.numpy() for k, v in grads.items()},
            ms=[t * 1e3 for t in times], timed_step_ms=timed_step * 1e3,
            collective_ms=sum(record) * 1e3, collectives=len(record),
            peak_gib=peak,
            control=dict(losses=c_losses[0], grads={
                k: v.numpy() for k, v in c_grads.items()}),
            infer=infer)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        parallel.destroy()


def run_ranks(target, paths, label):
    """SP_SPACE spawned `target(rank, port, paths, results)` processes (a
    spatial phase's ranks); their results in rank order (as run_dp_ranks,
    `label` naming the phase in its errors)."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(rank, port, paths, results))
             for rank in range(SP_SPACE)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < SP_SPACE:
            try:
                rank, ok, value = results.get(timeout=DP_SECONDS)
            except queue.Empty:
                raise RuntimeError(f'chip_smoke: {label} ranks '
                                   f'{sorted(set(range(SP_SPACE)) - set(got))}'
                                   f' gave no result in {DP_SECONDS} s')
            check(ok, f'{label} rank {rank} failed:\n{value}')
            got[rank] = value
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [got[r] for r in range(SP_SPACE)]


def sp_steps(ranks, one, card):
    """Phase 12(a)'s checks and lines."""
    tag = (f'spatial {DP_CONFIG} 550 b8 f32 (data 1 x space {SP_SPACE}, '
           f'gloo ranks on one card)')
    losses, launches, grads = one['losses'], one['launches'], one['grads']
    for step in range(SP_CHECKED_STEPS):
        print(f'{tag} step {step}: one process {json.dumps(losses[step])}; '
              f'ranks {json.dumps([r["losses"][step] for r in ranks])}')
        check(len({r['digests'][step] for r in ranks}) == 1,
              f'{tag}: the ranks\' weights differ after step {step}')
        for rank, run in enumerate(ranks):
            got = run['losses'][step]
            check(got['finite'] and got.keys() == losses[step].keys(),
                  f'{tag}: rank {rank} step {step} {got}')
            for k, v in losses[step].items():
                if k in ('finite', 'lr'):
                    continue
                check(np.isfinite(got[k]) and abs(got[k] - v) <= 1e-4 * abs(v),
                      f'{tag}: rank {rank} step {step} loss {k} {got[k]!r} '
                      f'against {v!r}')
            check(run['launches'][step] == launches[step] == DP_PER_STEP,
                  f'{tag}: rank {rank} step {step} launches '
                  f'{run["launches"][step]}, one process {launches[step]}, '
                  f'expected {DP_PER_STEP}')
    print(f'{tag}: both ranks\' weights bit-equal after each of '
          f'{SP_CHECKED_STEPS} steps; launches per rank per step '
          f'{json.dumps(ranks[0]["launches"][0])} (one process '
          f'{json.dumps(launches[0])})')
    # as phase 10: the rounding of the row-sharded convs and of the global
    # moments passes through the random network to the first gradients;
    # every gradient within STEM_BATCH_STATS_LIMIT.  The control (the head
    # outputs' gather with the other transpose: every gradient before it
    # counted twice) must fail it.
    rel = STEM_BATCH_STATS_LIMIT
    gaps = {}
    for name in DP_GRADS:
        want = grads[name]
        top = float(want.abs().max())
        err, control = (float(np.abs(g - want.cpu().numpy()).max())
                        for g in (ranks[0]['grads'][name],
                                  ranks[0]['control']['grads'][name]))
        gaps[name] = control / top
        print(f'{tag} first-step gradient of {name}: max {top!r}, '
              f'max_abs_err against one process {err!r} ({err / top!r} of '
              f'max; criterion {rel!r}); control with the gather\'s '
              f'gradient summed over the ranks {control!r} '
              f'({control / top!r} of max)')
        check(top > 0 and err <= rel * top,
              f'{tag}: the gradient of {name} differs')
    check(min(gaps.values()) > rel, f'{tag}: the control passes the '
          f'gradient check on {min(gaps, key=gaps.get)}: it has no teeth')
    one_ms = statistics.median(one['ms'])
    for rank, run in enumerate(ranks):
        ms, coll, step = (statistics.median(run['ms']), run['collective_ms'],
                          run['timed_step_ms'])
        peak = run['peak_gib']
        print(f'{tag} rank {rank}: median {ms!r} ms per step ({run["ms"]}, '
              f'host clock, synchronised; one process {one_ms!r}); in one '
              f'more step with each collective timed between two '
              f'synchronisations ({step!r} ms) {run["collectives"]} '
              f'collectives took {coll!r} ms (share {coll / step!r}); peak '
              f'memory allocated {peak!r} GiB against one process\'s '
              f'{one["peak_gib"]!r} GiB (share {peak / one["peak_gib"]!r}) '
              f'and one process\'s on the global batch-norm path '
              f'{one["global_bn_peak_gib"]!r} GiB (share '
              f'{peak / one["global_bn_peak_gib"]!r}) [{card}]')
    return ranks[0]['launches'][0]


class LoneRank:
    """A stand-in mesh for one process's batch norms: their global-moment
    path (``models/layers.py:BatchNorm2d._global_batch_norm``) with an
    identity all-reduce and an empty second slot, so the moments are this
    process's batch's and the memory is that path's."""
    rank, size = 0, 2

    @staticmethod
    def all_sum_grad(t):
        return t


def global_bn_peak(sd, dev):
    """The peak memory allocated (GiB, over what the process held before)
    of TRAIN_STEPS one-process b8 steps of dp_config() with every batch
    norm on the global-moment path that the ranks take (LoneRank): what
    the split's per-rank peak is measured against, apart from that
    path's own cost."""
    from yolact_tpu_torch.models.layers import BatchNorm2d
    cfg = dp_config()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, device=dev, state_dict=tame_residuals(sd))
    for m in state.model.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = LoneRank()
    batch = make_train_batch(cfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    for _ in range(TRAIN_STEPS):
        out = train_step(state, batch, gen)
        check(bool(out['finite']), 'phase 12: the one-process step on the '
              'global batch-norm path is not finite')
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del state
    torch.cuda.empty_cache()
    return peak


def sp_infer(ranks, sd, frames8, dev, card):
    """Phase 12(b): each rank's detections against Pipeline in this
    process on the same frames (f32 by phase 4's rule, bf16 as matched
    sets), every rank the same, and the launches a call equal."""
    cfg, scale, bias = sp_infer_config()
    wsd = shape_conf(sd, cfg.num_classes, scale, bias)
    for tag, dtype, b in SP_INFER_RUNS:
        pipe = Pipeline(cfg, wsd, dev, dtype)
        pipe(frames8[:b])
        reset_launches()
        want = pipe(frames8[:b])
        torch.cuda.synchronize()
        calls = read_launches(KERNELS)
        ms = time_ms(lambda: pipe(frames8[:b]), runs=5, warmup=1)[0]
        del pipe
        outs = []
        for rank, run in enumerate(ranks):
            res = run['infer'][tag]
            got = InferenceOutput(**{k: torch.from_numpy(v).to(dev)
                                     for k, v in res['out'].items()})
            outs.append(got)
            name = f'spatial {DP_CONFIG} 550 {tag} rank {rank} vs Pipeline'
            check_output(name, got, cfg, b)
            if dtype == 'float32':
                compare(name, got, want, exact=True, ties_ok=True)
            else:
                match(name, got, want)
            check(res['launches'] == calls, f'{name}: launches a call '
                  f'{res["launches"]}, Pipeline {calls}')
            print(f'{name}: launches a call {json.dumps(res["launches"])} '
                  f'(Pipeline the same); median {statistics.median(res["ms"])!r} '
                  f'ms a call against Pipeline\'s {ms!r} (host clock) [{card}]')
        same = all(torch.equal(getattr(outs[0], f), getattr(o, f))
                   for o in outs[1:] for f in ('valid', 'classes', 'scores',
                                               'boxes', 'masks'))
        print(f'spatial {tag}: every rank\'s detections bit-equal: {same}')
        check(same, f'spatial {tag}: the ranks\' detections differ')


def sp_kernels(dev):
    """Phase 12(c): the DCN sampling and dcn_col2im on rank 1's output
    rows of a 2-way split (row0 > 0, the whole map as x) at the five
    yolact_plus_base shapes, f32 and bf16 b8, finite offsets: the columns
    bit-equal to the plain version's and to the whole call's rows; the
    backward against its plain version (phase 3's tolerances) and against
    the whole call with the column gradient zero outside the rows.
    Returns the largest f32 error of the backward against its plain
    version."""
    gen = torch.Generator().manual_seed(12)
    tol = KERNELS['dcn_col2im']['tol']
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, _, cin, h, stride in DCN_SHAPES:
            x, offset, mask = dcn_inputs(gen, dev, 8, cin, h, stride, dtype,
                                         finite=True)
            ho = offset.shape[-1]
            r0, r1 = own(ho, 1, SP_SPACE)
            sub = [t[:, :, r0:r1].contiguous() for t in (offset, mask)]
            tag = (f'spatial kernels {name} {str(dtype)[6:]} b8 rows '
                   f'[{r0}, {r1}) of {ho}')
            cols = dcn.dcn_columns(x, *sub, 3, stride, 1, 1, r0)
            plain = dcn.dcn_columns_plain(x, *sub, 3, stride, 1, 1, r0)
            whole = dcn.dcn_columns(x, offset, mask, 3, stride).view(
                8, ho, ho, -1)[:, r0:r1].reshape(cols.shape)
            torch.cuda.synchronize()
            check(torch.equal(cols, plain), f'{tag}: the columns differ '
                  f'from the plain version\'s')
            check(torch.equal(cols, whole), f'{tag}: the columns differ '
                  f'from the whole call\'s rows')
            g = torch.randn(8, ho, ho, 9 * cin, generator=gen).to(dtype)\
                .to(dev)
            g_rows = g[:, r0:r1].reshape(-1, 9 * cin).contiguous()
            got = dcn.dcn_col2im(g_rows, x, *sub, 3, stride, 1, 1, r0)
            want = dcn.dcn_col2im_plain(g_rows, x, *sub, 3, stride, 1, 1,
                                        r0)
            zeroed = torch.zeros_like(g)
            zeroed[:, r0:r1] = g[:, r0:r1]
            full = dcn.dcn_col2im(zeroed.view(-1, 9 * cin), x, offset, mask,
                                  3, stride)
            full = (full[0], full[1][:, :, r0:r1], full[2][:, :, r0:r1])
            torch.cuda.synchronize()
            line = []
            for gname, a, p, f in zip(('grad_x', 'grad_offset', 'grad_mask'),
                                      got, want, full):
                top = float(p.float().abs().max())
                errs = [float((a.float() - o.float()).abs().max())
                        for o in (p, f)]
                if dtype == torch.bfloat16:
                    limit = bf16_ulp(p.float()) + 1e-2 * top
                    ok = all(bool(((a.float() - o.float()).abs() <= limit)
                                  .all()) for o in (p, f))
                else:
                    ok = max(errs) <= tol * top
                    worst = max(worst, errs[0])
                line.append(f'{gname} max_abs_err vs plain {errs[0]!r}, vs '
                            f'the whole call {errs[1]!r} (max {top!r}, bit-'
                            f'equal to the whole call: '
                            f'{bool(torch.equal(a, f))})')
                check(ok, f'{tag}: {gname} differs ({line[-1]})')
            print(f'{tag}: columns bit-equal to the plain version and to the '
                  f'whole call\'s rows; dcn_col2im ' + '; '.join(line))
            del x, offset, mask, g, got, want, full
    return worst


def spatial_phase(sds, frames8, dev, card, one=None):
    """Phase 12 (see the module docstring).  `one`: phase 10's one-process
    run (one_process_steps), made here when None.  Returns the launches per
    rank per step of the spatial run."""
    t0 = time.perf_counter()
    sd = sds[DP_CONFIG]
    if one is None:
        one = one_process_steps(sd, dev)
    one = dict(one, global_bn_peak_gib=global_bn_peak(sd, dev))
    cfg, scale, bias = sp_infer_config()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_sp_') as tmp:
        paths = {name: os.path.join(tmp, name + '.pt')
                 for name in ('train_sd', 'infer_sd', 'frames')}
        torch.save(tame_residuals(sd), paths['train_sd'])
        torch.save(shape_conf(sd, cfg.num_classes, scale, bias),
                   paths['infer_sd'])
        torch.save(frames8.cpu(), paths['frames'])
        ranks = run_ranks(sp_rank, paths, 'phase 12')
    print(f'phase 12 ranks done in {time.perf_counter() - t0:.1f} s [{card}]')
    launches = sp_steps(ranks, one, card)
    sp_infer(ranks, sd, frames8, dev, card)
    err = sp_kernels(dev)
    print(f'phase 12(c): dcn_col2im from row0 > 0, largest f32 error '
          f'against its plain version {err!r}')
    return launches


# ---- phase 12b: spatial partitioning of every other config ----------------

# Phase 12b: the configs outside phase 12's ResNet slice on the same two
# gloo ranks (data 1 x space 2), each at 550 and full width, one f32 b8
# step with batch statistics on phase 10's batch, draws and schedule, and
# Pipeline under the mesh; the ResNets take the s2d stem, as Pipeline does
SPC_CONFIGS = ('yolact_darknet53', 'yolact_vgg16', 'yolact_base_gn',
               'yolact_base_direct', 'yolact_base_options')
# the first-step gradients held per config: the first conv, a norm where
# the backbone's is group norm, and the heads and the protonet
SPC_GRADS = {
    'yolact_darknet53': ('backbone._preconv.0.weight',
                         'backbone.layers.2.0.1.weight',
                         'prediction_layers.0.mask_layer.weight',
                         'proto_net.0.weight'),
    # (the stride-8 head's anchors, ~40 px, match none of this batch's
    # boxes, and the last head's priors are neither positive nor mined:
    # their mask and conf layers get no gradient)
    'yolact_vgg16': ('backbone.layers.0.0.weight', 'backbone.norms.0.weight',
                     'prediction_layers.0.conf_layer.weight',
                     'prediction_layers.1.mask_layer.weight',
                     'proto_net.0.weight'),
    'yolact_base_gn': ('backbone.conv1.weight', 'backbone.bn1.weight',
                       'backbone.layers.3.0.bn2.weight',
                       'prediction_layers.0.mask_layer.weight',
                       'proto_net.0.weight'),
    'yolact_base_direct': OPTION_TRAIN_GRADS['yolact_base_direct'],
    # and the protonet's last conv, which the prototype features' gradient
    # reaches first
    'yolact_base_options': OPTION_TRAIN_GRADS['yolact_base_options']
    + ('proto_net.10.weight',),
}
# the two controls that must fail the gradient check: group norm's
# moments over each rank's own rows, and the prototype features gathered
# with the loss's 'shared' gradient (each rank's feature gradient of the
# other ranks' prototype rows dropped)
SPC_CONTROLS = {'yolact_base_gn': 'local_gn',
                'yolact_base_options': 'shared_features'}


def spc_config(name):
    """Phase 12b's train config of `name`: phase 10's schedule, batch
    statistics, the s2d stem on the ResNets."""
    cfg = config_named(name).copy(lr=1e-4, lr_warmup_init=1e-7)
    return maybe_enable_stem_s2d(cfg)


@contextlib.contextmanager
def spatial_control(control):
    """Break one piece of the spatial step (SPC_CONTROLS), or nothing for
    None."""
    from yolact_tpu_torch.models import layers, yolact
    from yolact_tpu_torch.parallel import mesh as parallel
    real_gn, real_gather = layers.GroupNorm.forward, parallel.gather_rows
    if control == 'local_gn':
        layers.GroupNorm.forward = \
            lambda self, x, train=False, rows=None: real_gn(self, x, train)
    elif control == 'shared_features':
        yolact.gather_rows = \
            lambda x, rows, grad: real_gather(x, rows, 'shared')
    try:
        yield
    finally:
        layers.GroupNorm.forward, yolact.gather_rows = real_gn, real_gather


@contextlib.contextmanager
def native_convolutions():
    """PyTorch's own convolutions instead of cuDNN's.  cuDNN picks its
    algorithm by shape, and on a rank's row windows its float32 weight
    gradients round otherwise than on the whole map: VGG's proto_net.0
    gradient (a sum that cancels to 1e-3 of its terms) lands 7.0e-3 of
    its max from the float64 step on the ranks against 1.5e-3 in one
    process, and 1.5e-3 on both with cuDNN off (PERF.md §6 PR 15)."""
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before


def spc_step(cfg, sd, dev, names, mesh=None, control=None,
             convolutions=native_convolutions):
    """One f32 b8 train step of `cfg` from `sd` on make_train_batch's batch
    (phase 10's seeds), on this rank's rows under `mesh`, under
    `convolutions` (native ones on both sides of the comparison; a
    probe may pass contextlib.nullcontext for cuDNN's): the state and the
    losses, the launches, the named gradients, the weights' digest and
    the memory allocated before the state (bytes)."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with spatial_control(control), deterministic_library(), convolutions():
        state = create_train_state(cfg, device=dev, state_dict=sd, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(11)
        losses, launches, digests, grads = dp_steps(
            state, make_train_batch(cfg), gen, names, steps=1)
    return state, dict(losses=losses[0], launches=launches[0],
                       digest=digests[0], base=base,
                       grads={k: v.numpy() for k, v in grads.items()})


def spc_timed_step(state, cfg, dev, base):
    """One more step of `state` as the main path runs it (cuDNN's
    convolutions): its ms (host clock, synchronised) and its peak memory
    allocated over `base`, what the process held before the state (GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step(state, make_train_batch(cfg),
               torch.Generator(device=dev).manual_seed(12))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(ms=ms,
                peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)


def spc_float64_grads(cfg, sd, dev, names):
    """The one-process step's first gradients of `names` in float64 on the
    card (the plain versions of the kernels, which have no float64 build;
    ``.float()`` meaning float64, as the CPU tests' float64 runs), on
    spc_step's batch and draws: the yardstick of float32's rounding."""
    state = create_train_state(cfg, device=dev, state_dict=sd)
    model = state.model.double()
    model.compute_dtype = torch.float64
    if state.conf_state is not None:
        state.conf_state = {k: v.double() for k, v in state.conf_state.items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    batch = make_train_batch(cfg)
    mask_pri, miou_pri = (d.double() for d in draw_priorities(
        cfg, len(batch['image']), model.priors(cfg.max_size, cfg.max_size,
                                               dev).shape[0], gen, dev))
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        with deterministic_library(), native_convolutions():
            tensors = batch_to_device(
                dict(batch, image=batch['image'].astype(np.float64)), dev)
            step_module.forward_loss(state, tensors, mask_pri, miou_pri,
                                     use_kernels=False,
                                     num_gts=batch['num_gts'])['total'] \
                .backward()
    finally:
        torch.Tensor.float = real
    params = dict(model.named_parameters())
    grads = {k: params[k].grad.cpu().numpy() for k in names}
    del state, model, params
    torch.cuda.empty_cache()
    return grads


def spc_infer(name, wsd, frames8, dev, mesh=None):
    """Pipeline of `name` (under `mesh`) per SP_INFER_RUNS on the raw
    frames: the detections (numpy), the launches of one call counted from
    0 and the ms of two more calls (host clock, synchronised)."""
    out = {}
    for tag, dtype, b in SP_INFER_RUNS:
        pipe = Pipeline(config_named(name), wsd, dev, dtype, mesh=mesh)
        pipe(frames8[:b])                                 # warm
        reset_launches()
        got = pipe(frames8[:b])
        torch.cuda.synchronize()
        calls = read_launches(KERNELS)
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe(frames8[:b])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[tag] = dict(out={k: v.cpu().numpy() for k, v
                             in got._asdict().items() if v is not None},
                        launches=calls, ms=ms)
        del pipe
    return out


def spc_rank(rank, port, paths, results):
    """One rank of phase 12b, in a process of its own (spawn): the gloo
    group on cuda:0 split data 1 x space SP_SPACE; per config of
    ``paths['configs']`` the checked step (spc_step), a timed one
    (spc_timed_step), one more with its collectives timed, the config's
    control where it has one, and Pipeline under the mesh (spc_infer).  Puts (rank, True, result) or (rank, False, traceback)
    on `results`."""
    import traceback
    from yolact_tpu_torch.parallel import mesh as parallel
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SP_SPACE),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    try:
        dev = torch.device('cuda', 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load()
        mesh = parallel.make_mesh_2d(
            parallel.init_from_env('gloo', device=dev), SP_SPACE)
        frames8 = torch.load(paths['frames']).to(dev)
        got = {}
        for name in paths['configs']:
            cfg = spc_config(name)
            sd = torch.load(paths[name, 'train'])
            state, run = spc_step(cfg, sd, dev, SPC_GRADS[name], mesh,
                                  convolutions=paths['convolutions'])
            run.update(spc_timed_step(state, cfg, dev, run['base']))
            record = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timed_collectives(record):
                train_step(state, make_train_batch(cfg),
                           torch.Generator(device=dev).manual_seed(12))
            torch.cuda.synchronize()
            run.update(timed_step_ms=(time.perf_counter() - t0) * 1e3,
                       collective_ms=sum(record) * 1e3,
                       collectives=len(record))
            del state
            if name in SPC_CONTROLS:
                control, c_run = spc_step(cfg, sd, dev, SPC_GRADS[name],
                                          mesh, SPC_CONTROLS[name],
                                          paths['convolutions'])
                del control
                run['control'] = dict(losses=c_run['losses'],
                                      grads=c_run['grads'])
            run['infer'] = spc_infer(name, torch.load(paths[name, 'infer']),
                                     frames8, dev, mesh)
            got[name] = run
        results.put((rank, True, got))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        parallel.destroy()


def spc_train_checks(name, ranks, one, card):
    """Phase 12b(a)'s checks and lines for one config."""
    cfg = spc_config(name)
    tag = (f'spatial {name} 550 b8 f32 (data 1 x space {SP_SPACE}, gloo '
           f'ranks on one card)')
    print(f'{tag}: one process {json.dumps(one["losses"])}; ranks '
          f'{json.dumps([r[name]["losses"] for r in ranks])}')
    check(len({r[name]['digest'] for r in ranks}) == 1,
          f'{tag}: the ranks\' weights differ after the step')
    for rank, run in enumerate(ranks):
        got = run[name]['losses']
        check(got['finite'] and got.keys() == one['losses'].keys(),
              f'{tag}: rank {rank} {got}')
        for k, v in one['losses'].items():
            if k in ('finite', 'lr'):
                continue
            check(np.isfinite(got[k]) and abs(got[k] - v) <= 1e-4 * abs(v),
                  f'{tag}: rank {rank} loss {k} {got[k]!r} against {v!r}')
        check(run[name]['launches'] == one['launches'],
              f'{tag}: rank {rank} launches {run[name]["launches"]}, one '
              f'process {one["launches"]}')
    # From random weights under batch statistics float32's rounding alone
    # moves the first gradients by up to 7e-2 of their max (one process,
    # float32 against float64 on the card, yolact_darknet53's first conv;
    # PERF.md §6 PR 15), so the split is held to be as accurate as one
    # process: its distance from the float64 step within twice the
    # one-process float32 step's own, plus 1e-3 of the max
    gaps = {}
    for g in SPC_GRADS[name]:
        exact, want = one['grads64'][g], one['grads'][g]
        top = float(np.abs(exact).max())
        check(top > 0, f'{tag}: the gradient of {g} is zero')
        top = max(top, 1e-30)
        noise = float(np.abs(want - exact).max())
        limit = 2 * noise + 1e-3 * top
        got = ranks[0][name]['grads'][g]
        err, gap = (float(np.abs(got - ref).max()) for ref in (exact, want))
        line = (f'{tag} first-step gradient of {g}: max {top!r}; one process '
                f'f32 against f64 {noise / top!r} of max, the ranks against '
                f'f64 {err / top!r} (criterion {limit / top!r}), against '
                f'one process f32 {gap / top!r}')
        if 'control' in ranks[0][name]:
            c = float(np.abs(ranks[0][name]['control']['grads'][g]
                             - exact).max())
            gaps[g] = c - limit
            line += (f'; control {SPC_CONTROLS[name]} against f64 '
                     f'{c / top!r}')
        print(line)
        check(err <= limit, f'{tag}: the gradient of {g} differs')
    if gaps:
        check(max(gaps.values()) > 0, f'{tag}: the control '
              f'{SPC_CONTROLS[name]} passes the gradient check: it has no '
              f'teeth')
    for rank, run in enumerate(ranks):
        r = run[name]
        print(f'{tag} rank {rank}: {r["ms"]!r} ms for a second step (host '
              f'clock, synchronised; one process {one["ms"]!r}); in a third '
              f'step with each collective timed '
              f'({r["timed_step_ms"]!r} ms) {r["collectives"]} collectives '
              f'took {r["collective_ms"]!r} ms (share '
              f'{r["collective_ms"] / r["timed_step_ms"]!r}); peak memory '
              f'allocated {r["peak_gib"]!r} GiB against one process\'s '
              f'{one["peak_gib"]!r} (share {r["peak_gib"] / one["peak_gib"]!r}'
              f') [{card}]')
    return ranks[0][name]['launches']


def spc_infer_checks(name, ranks, want, card):
    """Phase 12b(b)'s checks and lines for one config: each rank against
    Pipeline in this process (f32 by phase 4's rule, bf16 as matched
    sets), every rank the same, the launches a call equal."""
    cfg = config_named(name)
    launches = {}
    for tag, dtype, b in SP_INFER_RUNS:
        outs = []
        ref = InferenceOutput(**{k: torch.from_numpy(v) for k, v
                                 in want[tag]['out'].items()})
        for rank, run in enumerate(ranks):
            res = run[name]['infer'][tag]
            got = InferenceOutput(**{k: torch.from_numpy(v)
                                     for k, v in res['out'].items()})
            outs.append(got)
            line = f'spatial {name} 550 {tag} rank {rank} vs Pipeline'
            check_output(line, got, cfg, b)
            if dtype == 'float32':
                compare(line, got, ref, exact=True, ties_ok=True)
            else:
                match(line, got, ref)
            check(res['launches'] == want[tag]['launches'],
                  f'{line}: launches a call {res["launches"]}, Pipeline '
                  f'{want[tag]["launches"]}')
            print(f'{line}: launches a call {json.dumps(res["launches"])} '
                  f'(Pipeline the same); {res["ms"]!r} ms a call against '
                  f'Pipeline\'s {want[tag]["ms"]!r} (host clock) [{card}]')
        check(bool(ref.valid.any()), f'spatial {name} {tag}: no detections')
        same = all(torch.equal(getattr(outs[0], f), getattr(o, f))
                   for o in outs[1:] for f in ('valid', 'classes', 'scores',
                                               'boxes', 'masks'))
        print(f'spatial {name} {tag}: every rank\'s detections bit-equal: '
              f'{same}')
        check(same, f'spatial {name} {tag}: the ranks\' detections differ')
        launches[tag] = want[tag]['launches']
    return launches


def spatial_configs_phase(sds, frames8, dev, card, configs=SPC_CONFIGS,
                          convolutions=native_convolutions):
    """Phase 12b (see the module docstring): the one-process references,
    then `configs` on the two ranks, the checked steps under
    `convolutions` (spc_step).  Returns per config the launches per rank
    per step and per call."""
    t0 = time.perf_counter()
    one, want = {}, {}
    paths = {'configs': tuple(configs), 'convolutions': convolutions}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_spc_') as tmp:
        for name in configs:
            cfg = config_named(name)
            sd = tame_residuals(sds[name])
            _, scale, bias, _ = [c for c in PATHS[name]['cells']
                                 if c[0] == 'sparse'][0]
            wsd = shape_conf(sds[name], cfg.num_classes, scale, bias)
            for kind, d in (('train', sd), ('infer', wsd)):
                paths[name, kind] = os.path.join(tmp, f'{name}_{kind}.pt')
                torch.save(d, paths[name, kind])
            state, one[name] = spc_step(spc_config(name), sd, dev,
                                        SPC_GRADS[name],
                                        convolutions=convolutions)
            one[name].update(spc_timed_step(state, spc_config(name), dev,
                                            one[name]['base']))
            del state
            one[name]['grads64'] = spc_float64_grads(
                spc_config(name), sd, dev, SPC_GRADS[name])
            want[name] = spc_infer(name, wsd, frames8, dev)
        paths['frames'] = os.path.join(tmp, 'frames.pt')
        torch.save(frames8.cpu(), paths['frames'])
        torch.cuda.empty_cache()
        print(f'phase 12b one-process references done in '
              f'{time.perf_counter() - t0:.1f} s [{card}]')
        ranks = run_ranks(spc_rank, paths, 'phase 12b')
    print(f'phase 12b ranks done in {time.perf_counter() - t0:.1f} s '
          f'[{card}]')
    launches = {}
    for name in configs:
        launches[name] = dict(
            per_step=spc_train_checks(name, ranks, one[name], card),
            per_call=spc_infer_checks(name, ranks, want[name], card))
    return launches


# ---- phase 13: the horizon tools ------------------------------------------

# yolact_plus_resnet50_horizon (yolact_tpu_torch/scripts/train_horizon.py)
# at 550 b8 bf16 from the trainer's seeded random weights on the 64
# synthetic images: a segment that ends in a checkpoint, then --resume
# latest; the long run (2400 iterations) is the tool's own, not this one
HORIZON_CONFIG = 'yolact_plus_resnet50'
HORIZON_ITERS = (20, 40)
FLOPS_CONFIGS = ('yolact_base', 'yolact_plus_base')


def horizon_phase(dev, card):
    """Phase 13 (see the module docstring).  Returns the launches per step
    of the horizon's training."""
    from yolact_tpu_torch.scripts import flops as flops_tool
    from yolact_tpu_torch.scripts import map_ab
    from yolact_tpu_torch.scripts import train_horizon as th
    t0 = time.perf_counter()
    cfg = register_config(th.horizon_config(HORIZON_CONFIG, HORIZON_ITERS[0]))
    train_set, val_set = th.horizon_datasets(cfg)
    blocks = sum(isinstance(m, DCNLayer) for m in Yolact(cfg).modules())
    per_step = dict(stem_s2d=0, dcn=2 * blocks, dcn_col2im=blocks)
    print(f'phase 13: {len(train_set)} synthetic images '
          f'({sum(len(v) for v in train_set.coco.img_to_anns.values())} '
          f'objects) made in {time.perf_counter() - t0:.1f} s')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_horizon_') as tmp:
        flags = ['--batch', '8', '--out_dir', f'{tmp}/out',
                 '--save_folder', f'{tmp}/weights/',
                 '--cuda', str(dev.type == 'cuda')]
        first, start, loaded = None, 0, []
        for end in HORIZON_ITERS:
            cfg = register_config(th.horizon_config(HORIZON_CONFIG, end))
            args = th.parse_args([HORIZON_CONFIG, '--iters', str(end)] + flags
                                 + (['--resume', 'latest'] if first else []))
            before = None if first is None else (
                lambda state, saved=first['state']:
                loaded.append(states_equal(state, saved)))
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            summary, out, steps, launches, _ = run_trainer(
                th.trainer_argv(args), train_set, val_set, before=before)
            tag = f'horizon {cfg.name} {start}-{end}'
            print(f'{tag}: {len(steps)} iterations in '
                  f'{time.perf_counter() - t1:.1f} s, median '
                  f'{statistics.median(summary["iter_seconds"][2:]) * 1e3!r}'
                  f' ms per iteration (host clock), peak memory allocated '
                  f'{torch.cuda.max_memory_allocated() / 2 ** 30!r} GiB; '
                  f'launches per step {json.dumps(steps[0]["launches"])} '
                  f'[{card}]; its loss lines:')
            print('\n'.join(l for l in out.splitlines() if '||' in l))
            checks(tag, cfg, summary, steps, per_step, start, end)
            check(os.path.exists(summary['path']) and summary['path']
                  .endswith(f'_{end}.pth'), f'{tag}: checkpoint '
                  f'{summary["path"]}')
            if first is not None:
                print(f'{tag}: resumed at step {steps[0]["step"]} at lr '
                      f'{steps[0]["lr"]!r}; the state it loaded against '
                      f'segment 1\'s final state: weights and buffers, '
                      f'momentum, step bit-equal {loaded}')
                check(summary['start_iter'] == start
                      and steps[0]['step'] == start
                      and steps[0]['lr'] == learning_rate(cfg, start),
                      f'{tag}: resumed at step {steps[0]["step"]}, lr '
                      f'{steps[0]["lr"]!r}')
                check(loaded == [(True, True, True)],
                      f'{tag}: the resumed state differs from the saved one')
            first, start = summary, end
        th.print_loss_blocks(summary['log'], th.JAX_LOG.format(HORIZON_CONFIG))
        path = summary['path']
        del first, summary
        torch.cuda.empty_cache()

        # --eval, then map_ab's rows, on the final checkpoint
        t1 = time.perf_counter()
        reset_launches()
        maps = th.evaluate_checkpoint(cfg, path, val_set, 8, dev, quiet=True)
        print(f'horizon --eval {os.path.basename(path)} with the kernels: box '
              f'{maps["box"]["all"]!r} mask {maps["mask"]["all"]!r} mAP; '
              f'launches {json.dumps(read_launches(KERNELS))}; '
              f'{time.perf_counter() - t1:.1f} s [{card}]')
        rows = map_ab.ab_rows(cfg, checkpoint.load_weights(cfg, path), val_set,
                              dev, 8)
        clean, lines = map_ab.verdict(rows)
        print('\n'.join(lines))
        rows = dict(rows)
        check(clean, 'horizon map_ab: DIRTY')
        check(maps == rows['mask assembly kernel/default']
              == rows['mask assembly plain'],
              'horizon --eval: the kernels\' mAP differs from the plain '
              'versions\'')

    # flops: inference at b1 and b8, the b8 train step
    for name in FLOPS_CONFIGS:
        for batch in (1, 8):
            print(json.dumps(dict(flops_tool.forward_flops(name, batch,
                                                           device=dev),
                                  card=card)))
        print(json.dumps(dict(flops_tool.train_step_flops(name, 8, device=dev),
                              card=card)))
        torch.cuda.empty_cache()
    return steps[0]['launches']


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'test needs an NVIDIA GPU', file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = {}
    t_run = t_phase = time.perf_counter()

    def phase_done(label):
        nonlocal t_phase
        now = time.perf_counter()
        phases[label] = now - t_phase
        print(f'phase {label}: {phases[label]:.1f} s')
        t_phase = now

    _build.load()
    print(f'build (nvcc, {len(_build._sources())} sources in parallel) and '
          f'load: {time.perf_counter() - t_phase:.2f} s')
    phase_done('2 build')

    errs = kernel_vs_plain(dev)
    phase_done('3 kernels vs plain')

    rng = np.random.RandomState(0)
    frames8 = torch.from_numpy(rng.randint(0, 256, (8, 550, 550, 3))
                               .astype(np.float32)).to(dev)
    pipes, launches, outs, sds = {}, {}, {}, {}
    for name in PATHS:
        if name in OPTION_PATHS:
            continue
        if name == OTHER_BACKBONES[0]:
            phase_done('4 main paths')
        config = PATHS[name]['config']
        if config not in sds:
            t0 = time.perf_counter()
            sd = random_state_dict(config_named(config),
                                   torch.Generator().manual_seed(0))
            sds[config] = seed_offsets_state_dict(
                sd, torch.Generator().manual_seed(3))
            print(f'{config} weights: {time.perf_counter() - t0:.2f} s')
        launches[name], outs[name], pipes[name] = main_path(
            name, sds[config], frames8, dev)
    a14_launches = a14_phase(dev, card)
    phase_done('4b other backbones')
    # the s2d stem against the plain stem, same weights and frames
    for cell in ('dense', 'sparse'):
        s2d, plain = (outs[name][cell, 'b1 f32']
                      for name in ('yolact_base_s2d', 'yolact_base'))
        compare(f's2d vs plain stem {cell} b1 f32', s2d, plain, exact=True,
                ties_ok=True)
        s2d, plain = (outs[name][cell, 'b8 bf16']
                      for name in ('yolact_base_s2d', 'yolact_base'))
        match(f's2d vs plain stem {cell} b8 bf16', s2d, plain)
    c5_want = outs['yolact_base_s2d']['sparse', 'b1 f32']
    del outs

    # ---- phase 9: model options and video ----
    option_launches, video_fps = options_phase(sds, frames8, dev, card)
    phase_done('9 model options and video')

    # ---- phase 5: eval ----
    eval_rates = eval_phase(sds['yolact_base'], dev, card)
    eval_rates.update(eval_sizes_phase(sds['yolact_base'], dev, card))
    phase_done('5 eval')

    # ---- phase 6: the train step ----
    for name, path in TRAIN_PATHS.items():
        launches[name] = train_path(name, sds[path['config']], dev, card)
    train_remat_none_counts(sds['yolact_plus_base'], dev)
    phase_done('6 train step')

    # ---- phase 8: the trainer (cli/train.py) ----
    trainer_launches, trainer_timing_, trainer_per_step = trainer_phase(
        sds, dev, card)
    torch.cuda.empty_cache()
    phase_done('8 trainer')

    # ---- phase 8b: device augmentation and the packed transports ----
    device_augment_phase(sds, dev, card)
    torch.cuda.empty_cache()
    phase_done('8b device augmentation')

    # ---- phase 10: data parallelism, multi-device eval, C5 ----
    dp_launches, one_process = dp_phase(sds, frames8, dev, card,
                           trainer_timing_['yolact_base bf16']['ms'], c5_want)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    phase_done('10 data parallelism')

    # ---- phase 11: export; 11b: deformable PSRoI pooling ----
    export_launches = export_phase(sds['yolact_plus_base'], frames8, dev,
                                   card)
    torch.cuda.empty_cache()
    phase_done('11 export')
    psroi_phase(dev, card)
    phase_done('11b psroi')

    # ---- phase 12: spatial partitioning ----
    sp_launches = spatial_phase(sds, frames8, dev, card, one_process)
    del one_process
    torch.cuda.empty_cache()
    phase_done('12 spatial partitioning')
    spc_launches = spatial_configs_phase(sds, frames8, dev, card)
    del sds
    torch.cuda.empty_cache()
    phase_done('12b spatial partitioning, other configs')

    # ---- phase 13: the horizon tools ----
    horizon_launches = horizon_phase(dev, card)
    torch.cuda.empty_cache()
    phase_done('13 horizon tools')

    # ---- phase 7: timing; the s2d A/B in the order plain, s2d, s2d, plain
    order = ('yolact_base', 'yolact_base_s2d', 'yolact_base_s2d',
             'yolact_base', 'yolact_plus_base') + OTHER_BACKBONES
    for batch in (1, 8):
        x = frames8[:batch]
        for name in order:
            ms, p90 = time_ms(lambda: pipes[name](x))
            print(f'e2e {name} 550 bf16 b{batch}: median {ms!r} ms/batch '
                  f'({batch * 1000.0 / ms!r} frames/s), p90 {p90!r} ms '
                  f'({RUNS} calls, CUDA events) [{card}]')
    for batch in (8, 1):
        x = frames8[:batch]
        busy = collections.defaultdict(list)
        for name in order:
            prof = profile_kernels(lambda: pipes[name](x))
            if prof is None:
                print(f'device {name} b{batch}: not measured (the profiler '
                      f'recorded no kernel)')
                continue
            busy[name].append(prof[0])
            top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:6]
            print(f'device {name} 550 bf16 b{batch}: busy {prof[0]!r} ms per '
                  f'batch, idle share {prof[1]!r} (torch.profiler kernel '
                  f'events, 20 batches) [{card}]; top kernels ms per batch: '
                  + '; '.join(f'{n[:60]} {t!r}' for n, t in top))
            if name == 'yolact_plus_base':
                gemm = {n: t for n, t in prof[2].items()
                        if ('gemm' in n or 'nvjet' in n)
                        and not any(c in n for c in ('fprop', 'conv',
                                                     'implicit'))}
                print(f'yolact_plus_base b{batch} per batch: DCN sampling '
                      f'{sum(t for n, t in prof[2].items() if "dcn_im2col" in n)!r}'
                      f' ms; GEMM kernels (not convs) ' + json.dumps(gemm))
        if len(busy['yolact_base']) == 2 and len(busy['yolact_base_s2d']) == 2:
            plain_ms = statistics.mean(busy['yolact_base'])
            s2d_ms = statistics.mean(busy['yolact_base_s2d'])
            print(f's2d A/B b{batch} device busy per batch: plain stem '
                  f'{busy["yolact_base"]} (mean {plain_ms!r}), s2d '
                  f'{busy["yolact_base_s2d"]} (mean {s2d_ms!r}); s2d - plain '
                  f'{s2d_ms - plain_ms!r} ms [{card}]')
    dcn_line = dcn_timing(dev, card, pipes['yolact_plus_base'], frames8)
    del pipes
    stem_ms = stem_timing(dev, card)[torch.bfloat16, 8]
    lines = dict(small_kernel_timing(dev, card), dcn=dcn_line,
                 dcn_col2im=col2im_timing(dev, card),
                 stem_s2d=dict(ms=stem_ms['kernel'], plain_ms=stem_ms['plain'],
                               bound=stem_ms['bound'],
                               library_ms=stem_ms['cudnn_4x4']))
    report = []
    for name, info in KERNELS.items():
        t = lines[name]
        report.append({'name': name, 'route': 'cuda', 'source': info['source'],
                       'replaces': info['replaces'],
                       'launches': launches[info['path']][name],
                       'trainer_launches': trainer_launches.get(name, 0),
                       'device_augment_launches_per_step': {
                           tag: counts[name]
                           for tag, counts in trainer_per_step.items()
                           if 'device_augment' in tag and counts.get(name)},
                       'dp_launches_per_rank_step': dp_launches.get(name, 0),
                       'spatial_launches_per_rank_step': sp_launches.get(
                           name, 0),
                       'spatial_config_launches': {
                           config: dict(per_step=counts['per_step'].get(
                               name, 0), per_call={
                                   tag: calls[name] for tag, calls
                                   in counts['per_call'].items()})
                           for config, counts in spc_launches.items()},
                       'export_launches': {
                           tag: counts[name]
                           for tag, counts in export_launches.items()},
                       'a14_launches': {
                           config: {run: counts.get(name, 0)
                                    for run, counts in runs.items()}
                           for config, runs in a14_launches.items()},
                       'horizon_launches_per_step': horizon_launches.get(
                           name, 0),
                       'option_launches': {
                           path: counts[name]
                           for path, counts in option_launches.items()
                           if counts.get(name)},
                       'max_abs_err': errs[name], 'ms': t['ms'],
                       'plain_ms': t['plain_ms'], 'bound_ms': t['bound'][0],
                       'bound_by': t['bound'][1],
                       'library_ms': t.get('library_ms')})
    phase_done('7 timing')
    print(f'eval frames/s: {json.dumps(eval_rates)}; video frames/s '
          f'{video_fps!r} [{card}]')
    print(f'phase seconds: {json.dumps(phases)}; '
          f'{time.perf_counter() - t_run:.1f} s after the device check')
    print(f'torch.profiler lost kernel events in '
          f'{PROFILES["with lost events"]} of {PROFILES["profiles"]} '
          f'profiles; '
          f'kernel times are the mean recorded event times launches per call '
          f'(profile_kernels) [{card}]')
    print(json.dumps({'kernels': report}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
