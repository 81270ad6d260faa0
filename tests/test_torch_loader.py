"""The port's ``BatchLoader`` (``yolact_tpu_torch/data/loader.py``) against
the JAX package's, and the JAX package's loader regression cases
(``tests/test_loader_checkpoint_regressions.py``) re-run on the port.

With one dataset, seed and a deterministic transform the two loaders give
equal batches in the same order, with the full-resolution masks and with
the pre-downsampled ``multires`` targets (JAX ships those bit-packed: they
are unpacked for the comparison)."""

import numpy as np
import pytest

from yolact_tpu.data.loader import BatchLoader as JaxBatchLoader
from yolact_tpu.ops.bits import unpack_bits_last
from yolact_tpu_torch.data.loader import BatchLoader


class _FakeDataset:
    """Minimal pull_item-compatible dataset of n tiny images
    (test_loader_checkpoint_regressions.py)."""

    def __init__(self, n=8, size=32, fail_at=None):
        self.n = n
        self.size = size
        self.fail_at = fail_at

    def __len__(self):
        return self.n

    def pull_item(self, i):
        if self.fail_at is not None and i == self.fail_at:
            raise RuntimeError('corrupt image (synthetic)')
        S = self.size
        img = np.zeros((S, S, 3), np.float32)
        target = np.array([[0.1, 0.1, 0.5, 0.5, 0]], np.float32)
        masks = np.ones((1, S, S), np.float32)
        return img, target, masks, S, S, 0


class _SeededDataset:
    """Items that depend on the index alone: an image, 1-4 boxes (the last
    a crowd when there are several) and soft masks."""

    def __init__(self, n=11, size=32):
        self.items = []
        for i in range(n):
            rng = np.random.RandomState(i)
            k = 1 + i % 4
            boxes = np.sort(rng.rand(k, 2, 2), axis=1).reshape(k, 4)
            labels = rng.randint(0, 4, (k, 1)).astype(np.float32)
            if k > 1:
                labels[-1] = -1
            self.items.append((
                rng.randn(size, size, 3).astype(np.float32),
                np.hstack([boxes[:, [0, 2, 1, 3]], labels]).astype(np.float32),
                rng.rand(k, size, size).astype(np.float32),
                size, size, int(k > 1)))

    def __len__(self):
        return len(self.items)

    def pull_item(self, i):
        return self.items[i]


def _batches(loader, n):
    try:
        return [loader.next_batch() for _ in range(n)]
    finally:
        loader.stop()


@pytest.mark.parametrize('multires', [None, {'proto': (8, 8), 'seg': (4, 4)}],
                         ids=['full_masks', 'multires'])
def test_batches_match_jax(multires):
    kw = dict(batch_size=3, max_gt=4, num_workers=3, seed=5,
              multires=multires)
    got = _batches(BatchLoader(_SeededDataset(), drop_last=False, **kw), 9)
    want = _batches(JaxBatchLoader(_SeededDataset(), drop_last=False,
                                   pack_masks=False, **kw), 9)
    for g, w in zip(got, want):
        for name in ('proto', 'seg'):
            packed = w.pop(f'gt_masks_{name}_packed', None)
            if packed is not None:
                w[f'gt_masks_{name}'] = np.asarray(unpack_bits_last(
                    packed, multires[name][1]))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert any('num_valid' in b for b in got)      # 11 = 3 * 3 + 2


def test_loader_worker_error_propagates():
    loader = BatchLoader(_FakeDataset(n=8, fail_at=3), batch_size=4,
                         num_workers=1, shuffle=False)
    with pytest.raises(RuntimeError, match='corrupt image'):
        for _ in range(10):
            loader.next_batch()
    loader.stop()


def test_loader_tiny_dataset_guard():
    with pytest.raises(ValueError, match='drop_last'):
        BatchLoader(_FakeDataset(n=3), batch_size=8)
    loader = BatchLoader(_FakeDataset(n=3), batch_size=8, drop_last=False,
                         num_workers=1)
    batch = loader.next_batch()
    assert batch['image'].shape[0] == 8
    loader.stop()


def test_loader_deterministic_order_across_workers():
    class _IdDataset(_FakeDataset):
        def pull_item(self, i):
            img, target, masks, h, w, nc = super().pull_item(i)
            return img + float(i), target, masks, h, w, nc

    def first_ids(workers):
        loader = BatchLoader(_IdDataset(n=16), batch_size=4,
                             num_workers=workers, seed=7)
        return [b['image'][:, 0, 0, 0].round().tolist()
                for b in _batches(loader, 8)]

    assert first_ids(1) == first_ids(4)


def test_loader_next_batch_raises_after_stop():
    loader = BatchLoader(_FakeDataset(n=8), batch_size=4, num_workers=1)
    loader.next_batch()
    loader.stop()
    with pytest.raises(RuntimeError, match='stopped'):
        for _ in range(16):
            loader.next_batch()


def test_loader_short_batch_marks_num_valid():
    loader = BatchLoader(_FakeDataset(n=6), batch_size=4, num_workers=1,
                         drop_last=False, shuffle=False)
    b1, b2 = _batches(loader, 2)
    assert 'num_valid' not in b1
    assert b2['num_valid'] == 2


def test_unported_transports_raise():
    with pytest.raises(NotImplementedError, match='A6b'):
        BatchLoader(_FakeDataset(), batch_size=4, pack_masks=True)
    with pytest.raises(NotImplementedError, match='A9'):
        BatchLoader(_FakeDataset(), batch_size=4, pack_images=True)
