"""Host batch loader with a RAM cache and a prefetch thread (counterpart of
the JAX package's ``data/pipeline.py``).

Decoded uint8 examples are cached in RAM (LRU under a byte cap); batches are
shuffled with a seeded numpy RNG, edge-padded to the model's stride with
``valid=0`` on the pad, and stacked as uint8 (normalization happens on the
device, see ``data.augment``). A thread assembles host batches into pinned
memory; the device copy of the next batch is queued on a side stream while
the current one trains.

With a grid of ranks (``mesh=``, ``parallel/mesh.py``) every rank shuffles
the same way and loads only its data slice of each batch (the JAX package's
``pipeline.py:149-162``), pads it to the stride and keeps its rows.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

class BatchLoader:
    """Shuffled, padded, prefetched uint8 batches from a KITTI-style dataset
    on an explicit ``device``.

    Spatial dims are edge-padded up to ``pad_multiple``; padded pixels get
    valid=0 so they are invisible to loss and metrics. ``drop_remainder=
    False`` wrap-pads the last batch and marks the repeated examples
    entirely invalid. ``mesh``: a ``parallel.mesh.Grid``; this rank's images
    and rows of every batch (``batch_size`` is global and must divide over
    the grid's data ranks; the padded height splits at ``pad_multiple``
    over its spatial ranks, unevenly where the blocks do not divide
    (``Grid.row_splits``), and a batch with fewer blocks than ranks
    raises). ``workers``: decode each
    batch's examples on a pool of this many threads (0: inline); PNG
    decode releases the GIL, and the batches are bit-identical to
    ``workers=0``.
    """

    DEFAULT_CACHE_BYTES = 2 << 30

    def __init__(self, dataset, batch_size: int, pad_multiple: int = 32,
                 seed: int = 0, *, device, drop_remainder: bool = True,
                 cache: bool = True, cache_bytes: int | None = None,
                 mesh=None, workers: int = 0):
        if mesh is not None and batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"grid's {mesh.data} data ranks")
        self.mesh = mesh
        self.ds = dataset
        self.batch_size = batch_size
        self.pad_multiple = pad_multiple
        self.device = torch.device(device)
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        self._cache: OrderedDict | None = OrderedDict() if cache else None
        self._cache_bytes = (self.DEFAULT_CACHE_BYTES if cache_bytes is None
                             else int(cache_bytes))
        self._cache_used = 0
        self._cache_lock = threading.Lock()
        self.workers = int(workers)
        self._pool: ThreadPoolExecutor | None = None

    # -- host-side example assembly -------------------------------------
    @staticmethod
    def _example_nbytes(ex: tuple) -> int:
        return sum(int(a.nbytes) for a in ex)

    def _get(self, path: str):
        # the decode pool shares the LRU behind a lock; the decode itself
        # runs outside it, so a rare race decodes one path twice (the same
        # result; the second insert is skipped)
        if self._cache is not None:
            with self._cache_lock:
                if path in self._cache:
                    self._cache.move_to_end(path)  # LRU: recent at the end
                    return self._cache[path]
        ex = self.ds.load_example(path)
        if self._cache is not None:
            size = self._example_nbytes(ex)
            if size <= self._cache_bytes:  # never admit > the whole budget
                with self._cache_lock:
                    if path not in self._cache:
                        self._cache[path] = ex
                        self._cache_used += size
                    while self._cache_used > self._cache_bytes:
                        _, old = self._cache.popitem(last=False)
                        self._cache_used -= self._example_nbytes(old)
        return ex

    def _pad(self, img, lbl, val):
        m = self.pad_multiple
        h, w = lbl.shape
        ph, pw = (-h) % m, (-w) % m
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
            lbl = np.pad(lbl, ((0, ph), (0, pw)))
            val = np.pad(val, ((0, ph), (0, pw)))  # padded -> invalid
        return img, lbl, val

    def _stack(self, paths: list[str]) -> dict[str, np.ndarray]:
        if self.workers > 0:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.workers,
                                                thread_name_prefix="seg-decode")
            examples = list(self._pool.map(self._get, paths))  # in order
        else:
            examples = [self._get(p) for p in paths]
        imgs, lbls, vals = [], [], []
        for ex in examples:
            i, l, v = self._pad(*ex)
            imgs.append(i); lbls.append(l); vals.append(v)
        batch = {"image": np.stack(imgs), "label": np.stack(lbls),
                 "valid": np.stack(vals)}
        if self.mesh is not None and self.mesh.spatial > 1:
            rows = self.mesh.rows(batch["label"].shape[1], self.pad_multiple)
            batch = {k: v[:, rows] for k, v in batch.items()}
        return batch

    def _host_epoch(self) -> Iterator[dict[str, np.ndarray]]:
        paths = list(self.ds.train_images)
        self._rng.shuffle(paths)
        bs = self.batch_size
        for i in range(0, len(paths), bs):
            chunk = paths[i:i + bs]
            n_real = len(chunk)
            if n_real < bs:
                if self.drop_remainder:
                    break
                # wrap-pad to keep shapes static, but mark the duplicated
                # examples entirely invalid so loss/metrics never count them
                chunk = chunk + paths[: bs - n_real]
            idx = np.arange(bs)
            if self.mesh is not None:          # this rank's images only
                idx = idx[self.mesh.images(bs)]
                chunk = [chunk[j] for j in idx]
            batch = self._stack(chunk)
            if n_real < bs:
                batch["valid"] &= ~(idx >= n_real)[:, None, None]
            yield batch

    # -- device staging, one batch ahead ---------------------------------
    def _pinned(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def epoch(self) -> Iterator[dict[str, torch.Tensor]]:
        """Yields batches on ``self.device``: image u8 [N,H,W,3], label
        int32 [N,H,W], valid bool [N,H,W]. A producer thread decodes and
        pins; the copy of batch i+1 is queued (on a side stream, on CUDA)
        before batch i is handed out."""
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            """False once the consumer has gone (it stops reading)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # failures (corrupt PNG, missing GT) reach the consumer instead
            # of silently ending the epoch early
            try:
                for b in self._host_epoch():
                    if not put(self._pinned(b)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                put(e)
            else:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        copy_stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

        def fetch():
            b = q.get()
            if b is None or isinstance(b, BaseException):
                return b
            if copy_stream is None:
                return {k: v.to(self.device) for k, v in b.items()}
            with torch.cuda.stream(copy_stream):
                return {k: v.to(self.device, non_blocking=True)
                        for k, v in b.items()}

        try:
            nxt = fetch()
            while True:
                cur = nxt
                if isinstance(cur, BaseException):
                    raise cur
                if cur is None:
                    return
                if copy_stream is not None:
                    main = torch.cuda.current_stream(self.device)
                    main.wait_stream(copy_stream)
                    for v in cur.values():
                        v.record_stream(main)
                nxt = fetch()
                yield cur
        finally:
            stop.set()
            t.join(timeout=30)

    def steps_per_epoch(self) -> int:
        n = len(self.ds.train_images)
        return (n // self.batch_size if self.drop_remainder
                else -(-n // self.batch_size))


class _SubsetDataset:
    """A dataset restricted to an explicit train-image list (how
    ``scripts/train.py --val-frac`` holds out a validation split; KITTI road
    has no labeled val split). Everything else delegates."""

    def __init__(self, ds, paths):
        self._ds = ds
        self._paths = list(paths)

    @property
    def train_images(self) -> list[str]:
        return list(self._paths)

    def load_example(self, path: str):
        return self._ds.load_example(path)

    def __getattr__(self, name):
        return getattr(self._ds, name)


def subset_dataset(ds, paths) -> _SubsetDataset:
    return _SubsetDataset(ds, paths)


def class_pixel_counts(dataset, num_classes: int) -> np.ndarray:
    """[C] labeled-pixel counts over the train split (ignore pixels
    excluded): the input to ``train.loss.median_frequency_weights``."""
    counts = np.zeros(num_classes, np.int64)
    for path in dataset.train_images:
        _, ids, valid = dataset.load_example(path)
        counts += np.bincount(ids[valid].ravel(),
                              minlength=num_classes)[:num_classes]
    return counts
