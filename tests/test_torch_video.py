"""The port's video entry point (yolact_tpu_torch.eval.video, cli/eval
--video) against the JAX package's, on a tiny clip written here with cv2,
in float32 on the CPU.

JAX's drawn frames are caught by replacing ``cv2.VideoWriter`` in this test
(the clip is read back by both packages through ``cv2.VideoCapture``).
The clip's frames are at the tiny config's 128x128, so neither package
resizes them (JAX antialiases a downscale, the port does not).  With the
same weights the drawn frames agree on >= 99.9% of their pixels (mask
edges where the two forwards' values straddle 0.5); the port's writer, its
frame sink and its in-memory sources (an array, an iterator) give the same
frames bit for bit."""

import builtins
import sys

import jax
import numpy as np
import pytest
import torch

from _tiny import tiny_resnet_config
from yolact_tpu.config import MaskType
from yolact_tpu.config import register_config as jax_register_config
from yolact_tpu.eval import video as jax_video
from yolact_tpu.infer import random_variables
from yolact_tpu_torch.cli import eval as cli_eval
from yolact_tpu_torch.config import register_config
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.eval import video

torch.set_num_threads(2)

N_FRAMES = 10          # video_multiframe 4: batches of 4, 4 and 2 (padded)


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    """A 10-frame MJPG clip of 128x128 noise with two bright rectangles,
    and its frames as cv2 reads them back."""
    import cv2
    path = str(tmp_path_factory.mktemp('clip') / 'clip.avi')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 30,
                             (128, 128))
    rng = np.random.RandomState(0)
    for i in range(N_FRAMES):
        frame = rng.randint(0, 120, (128, 128, 3)).astype(np.uint8)
        frame[20 + i:60 + i, 30:90] = 230
        frame[70:110, 10 + 2 * i:50 + 2 * i] = (40, 200, 90)
        writer.write(frame)
    writer.release()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    assert len(frames) == N_FRAMES
    return path, np.stack(frames)


class _Writer:
    """Stands in for cv2.VideoWriter: keeps the written frames."""
    written = {}

    def __init__(self, path, fourcc, fps, size):
        self.frames = _Writer.written.setdefault(path, [])
        self.size = size

    def write(self, img):
        assert (img.shape[1], img.shape[0]) == tuple(self.size)
        self.frames.append(img.copy())

    def release(self):
        pass


@pytest.fixture
def writer(monkeypatch):
    import cv2
    _Writer.written = {}
    monkeypatch.setattr(cv2, 'VideoWriter', _Writer)
    return _Writer.written


def _setup(direct=False):
    cfg = tiny_resnet_config(mask_type=MaskType.DIRECT) if direct \
        else tiny_resnet_config()
    v = jax.tree_util.tree_map(np.array, random_variables(cfg, seed=3))
    v = {'params': v['params'], 'batch_stats': v['batch_stats']}
    head = v['params']['prediction_layers_0']['conf_layer']['conv']
    b = head['bias'].reshape(-1, cfg.num_classes)
    b[:, 0] += 2.0            # tens of candidates a frame (a sparse cell)
    head['bias'] = b.reshape(-1)
    return cfg, v, jax_variables_to_state_dict(P(cfg), v)


def _agree(got, want):
    assert len(got) == len(want) == N_FRAMES
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
    same = sum(int((g == w).all(-1).sum()) for g, w in zip(got, want))
    total = sum(w.shape[0] * w.shape[1] for w in want)
    assert same >= 0.999 * total, (same, total)


KW = dict(video_multiframe=4, score_threshold=0.0, top_k=15,
          display_fps=False)


@pytest.mark.parametrize('case', ['fast', 'traditional', 'direct'])
def test_evalvideo_matches_jax(clip, writer, tmp_path, case):
    """A file through both packages' evalvideo: the port's written frames
    against JAX's; the port's frame sink and its in-memory sources against
    its writer, bit for bit; and something was drawn."""
    path, frames = clip
    cfg, v, sd = _setup(direct=case == 'direct')
    fast = case != 'traditional'
    jax_video.evalvideo(cfg, v, path, str(tmp_path / 'jax.mp4'),
                        fast_nms=fast, **KW)
    sunk = []
    fps = video.evalvideo(P(cfg), sd, path, str(tmp_path / 'port.mp4'),
                          fast_nms=fast, device='cpu', sink=sunk.append,
                          **KW)
    assert fps > 0
    want, got = (writer[str(tmp_path / f'{s}.mp4')] for s in ('jax', 'port'))
    _agree(got, want)
    assert all(np.array_equal(a, b) for a, b in zip(sunk, got))
    assert sum(int((g != f).any(-1).sum()) for g, f in zip(got, frames)) \
        > 1000
    for source in (frames, iter(list(frames))):
        mem = []
        video.evalvideo(P(cfg), sd, source, fast_nms=fast, device='cpu',
                        sink=mem.append, **KW)
        assert len(mem) == N_FRAMES
        assert all(np.array_equal(a, b) for a, b in zip(mem, got))
    # max_frames stops the reader after a part batch
    mem = []
    video.evalvideo(P(cfg), sd, frames, max_frames=6, device='cpu',
                    sink=mem.append, fast_nms=fast, **KW)
    assert len(mem) == 6
    assert all(np.array_equal(a, b) for a, b in zip(mem, got))


def test_cli_video_matches_evalvideo(clip, writer, tmp_path):
    """``cli/eval --video=in:out`` on a .pth: the frames evalvideo writes
    with the CLI's defaults (score threshold 0, top 5, one frame per
    batch)."""
    path, _ = clip
    cfg, v, sd = _setup()
    cfg = cfg.copy(name='tinyportvideo')
    jax_register_config(cfg)
    register_config(P(cfg))
    pth = tmp_path / 'tinyportvideo_1_2.pth'
    torch.save(sd, pth)
    out = str(tmp_path / 'cli.mp4')
    fps = cli_eval.main([f'--trained_model={pth}', '--cuda=False',
                         f'--video={path}:{out}'])
    assert fps > 0
    sunk = []
    video.evalvideo(P(cfg), sd, path, video_multiframe=1, score_threshold=0,
                    top_k=5, display_fps=False, device='cpu',
                    sink=sunk.append)
    assert len(writer[out]) == N_FRAMES
    assert all(np.array_equal(a, b) for a, b in zip(sunk, writer[out]))
    # video runs on one device whatever --eval_devices says, as in JAX
    again = str(tmp_path / 'cli2.mp4')
    cli_eval.main([f'--trained_model={pth}', '--cuda=False',
                   '--eval_devices=2', f'--video={path}:{again}'])
    assert len(writer[again]) == N_FRAMES
    assert all(np.array_equal(a, b) for a, b in zip(writer[again],
                                                    writer[out]))


def test_playback_stabilizer_matches_jax():
    """The sleep targets of a seeded run of buffer sizes and frame times,
    for a file and a webcam, and after the video is done."""
    rng = np.random.RandomState(0)
    for fps, webcam in ((30, False), (24, True), (60, False)):
        got = video.PlaybackStabilizer(fps, 4, is_webcam=webcam)
        want = jax_video.PlaybackStabilizer(fps, 4, is_webcam=webcam)
        for i in range(200):
            size, avg = int(rng.randint(0, 9)), float(rng.rand() * 0.05)
            done = i > 180
            assert got.sleep_target(size, avg, done) == \
                want.sleep_target(size, avg, done)
        assert got.stabilized == want.stabilized


def test_display_falls_back_headless(clip, monkeypatch, capsys):
    """``display=True`` without a display: the same check as JAX's
    (no DISPLAY on Linux: no window is tried), a printed warning, and the
    video runs without a window."""
    monkeypatch.setattr(sys, 'platform', 'linux')
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.delenv('WAYLAND_DISPLAY', raising=False)
    assert video._display_available() is False
    assert jax_video._display_available() is False
    _, frames = clip
    cfg, _, sd = _setup()
    mem = []
    video.evalvideo(P(cfg), sd, frames, display=True, device='cpu',
                    sink=mem.append, **KW)
    assert len(mem) == N_FRAMES
    assert 'No display available' in capsys.readouterr().out


def test_evalvideo_without_cv2(clip, monkeypatch, tmp_path):
    """With cv2 not importable: in-memory frames run and draw their masks
    (boxes and text need cv2), and a file path, an output path or a
    display raise an ImportError that names OpenCV."""
    _, frames = clip
    cfg, _, sd = _setup()
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == 'cv2' or name.startswith('cv2.'):
            raise ImportError(f'No module named {name!r}')
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, 'cv2', raising=False)
    monkeypatch.setattr(builtins, '__import__', no_cv2)
    kw = dict(KW, display_bboxes=False, display_text=False, device='cpu')
    mem = []
    video.evalvideo(P(cfg), sd, frames, sink=mem.append, **kw)
    assert len(mem) == N_FRAMES
    assert sum(int((m != f).any(-1).sum()) for m, f in zip(mem, frames)) > 0
    for call in (lambda: video.evalvideo(P(cfg), sd, 'clip.avi', **kw),
                 lambda: video.evalvideo(P(cfg), sd, frames,
                                         str(tmp_path / 'o.mp4'), **kw)):
        with pytest.raises(ImportError, match='OpenCV'):
            call()
    monkeypatch.setattr(sys, 'platform', 'linux')
    monkeypatch.setenv('DISPLAY', ':0')
    with pytest.raises(ImportError, match='OpenCV'):
        video._display_available()
    with pytest.raises(ImportError):          # drawing boxes needs cv2
        video.evalvideo(P(cfg), sd, frames,
                        **dict(kw, display_bboxes=True))
