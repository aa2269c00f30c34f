"""Input pipeline for decentralized data-parallel training on virtual ranks.

Counterpart of ``bluefog_tpu/data/loader.py``.  The host side is the same
numpy code and gives the same arrays, bit for bit:

- **Disjoint rank shards**: one permutation per epoch, seeded by ``(seed,
  epoch)``; rank ``r`` takes ``perm[r::num_ranks]`` (the
  ``DistributedSampler`` contract: every example seen once per epoch
  across the ranks, shards disjoint).
- **Static shapes**: fixed-size batches, the remainder dropped.
- **Stacked layout**: each item is a tuple of ``(num_ranks, batch, ...)``
  arrays, the rank-stacked layout of the port's trainers.

The device side replaces the reference's ``rank_shard`` by a copy to one
device (the virtual ranks share it): each batch is copied into pinned host
memory and sent with ``non_blocking=True`` on a copy stream of its own, from
the prefetch thread, ``prefetch`` batches ahead of the consumer.  The
consumer's stream waits on the copy's event before it reads the batch, and
the batch's device memory is recorded on that stream.  PyTorch's pinned-memory
allocator records the copy on each pinned block and reuses the block only
after the copy has finished.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ArraySource",
    "Subset",
    "SyntheticClassificationSource",
    "DistributedLoader",
    "prefetch_to_device",
]


class Subset:
    """Index-range view over a source: the train/test split of one dataset
    (a test tail held out of a ``TFRecordSource`` without copying it)."""

    def __init__(self, source, lo: int, hi: int):
        if not 0 <= lo <= hi <= len(source):
            raise ValueError(
                f"bad subset [{lo}, {hi}) of a {len(source)}-example source")
        self.source, self.lo = source, lo
        self.n = hi - lo

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        if np.any(idx < 0) or np.any(idx >= self.n):
            raise IndexError(
                f"index out of range for {self.n}-example subset")
        return self.source[idx + self.lo]


class ArraySource:
    """Index-gatherable source over parallel arrays (features, labels, ...).

    Accepts numpy arrays or anything ``np.asarray`` takes, including
    ``np.load(..., mmap_mode="r")`` memory-maps for larger-than-RAM data.
    ``source[idx_array]`` gathers a batch from every array.
    """

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("ArraySource needs at least one array")
        self.arrays = tuple(
            a if isinstance(a, np.memmap) else np.asarray(a) for a in arrays)
        n = len(self.arrays[0])
        for a in self.arrays:
            if len(a) != n:
                raise ValueError(
                    f"array lengths disagree: {[len(a) for a in self.arrays]}")
        self._len = n

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx):
        out = tuple(np.asarray(a[idx]) for a in self.arrays)
        return out if len(out) > 1 else out[0]


class SyntheticClassificationSource:
    """Procedural labelled data: ``num_classes`` fixed prototypes plus noise.

    Deterministic per index (no stored dataset): example ``i`` draws its
    label and noise from ``default_rng((seed, 1, i))``, the prototype of
    label ``c`` comes from ``default_rng((seed, 2, c))``.  Shapes default to
    ImageNet's; pass ``shape=(28, 28, 1), num_classes=10`` for MNIST.
    """

    def __init__(self, num_examples: int, *, shape=(224, 224, 3),
                 num_classes: int = 1000, seed: int = 0, noise: float = 0.3,
                 dtype=np.float32):
        self._len = int(num_examples)
        self.shape = tuple(shape)
        self.num_classes = int(num_classes)
        self.noise = float(noise)
        self.dtype = dtype
        self._seed = seed
        # prototypes are made per touched class: 1000 ImageNet-sized f32
        # prototypes would be about 574 MB
        self._protos: dict = {}

    def __len__(self) -> int:
        return self._len

    def _proto(self, label: int) -> np.ndarray:
        p = self._protos.get(label)
        if p is None:
            rng = np.random.default_rng((self._seed, 2, label))
            p = rng.standard_normal(self.shape).astype(self.dtype) * 0.8
            self._protos[label] = p
        return p

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        labels = np.empty(idx.shape, np.int32)
        imgs = np.empty(idx.shape + self.shape, self.dtype)
        flat = imgs.reshape((-1,) + self.shape)
        for pos, i in enumerate(idx.reshape(-1)):
            rng = np.random.default_rng((self._seed, 1, int(i)))
            lab = int(rng.integers(0, self.num_classes))
            labels.reshape(-1)[pos] = lab
            flat[pos] = self._proto(lab) + self.noise * rng.standard_normal(
                self.shape).astype(self.dtype)
        return imgs, labels


def _epoch_perm(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng((seed, epoch)).permutation(n)


class _DevicePut:
    """Host batch -> device batch: pinned memory and a ``non_blocking`` copy
    on a copy stream for CUDA, ``torch.from_numpy`` for the CPU.  ``put``
    runs on the producer thread and returns ``(tensors, event)``; ``take``
    runs on the consumer and returns the tensors, ready to use on its
    current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, batch: Tuple[np.ndarray, ...]):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        if self.stream is None:
            return tuple(t.to(self.device) for t in host), None
        with torch.cuda.stream(self.stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def take(self, item):
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out:
                t.record_stream(stream)
        return out


class DistributedLoader:
    """Epoch iterator yielding rank-stacked batches.

    Each item is a tuple of ``(num_ranks, batch, ...)`` arrays; with
    ``device_put=True`` (the default) tensors on the context's device,
    copied ``prefetch`` batches ahead on a background thread; with
    ``device_put=False`` the host's numpy arrays.

    Index discipline (as torch's ``DistributedSampler``): one permutation per
    epoch, seeded by ``(seed, epoch)``, rank ``r`` takes
    ``perm[r::num_ranks]``, the remainder dropped so every rank and every
    step sees the same static shapes.
    """

    def __init__(self, source, per_rank_batch: int, *,
                 num_ranks: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, device_put: bool = True, prefetch: int = 2):
        from bluefog_tpu_torch.parallel.context import get_context

        self.source = source
        self.batch = int(per_rank_batch)
        self.device = None
        if num_ranks is None:
            num_ranks = get_context().size
        if device_put:
            ctx = get_context()
            if num_ranks != ctx.size:
                raise ValueError(
                    f"num_ranks={num_ranks} != context size {ctx.size}; "
                    "pass device_put=False for host-only loading")
            self.device = ctx.device
        self.num_ranks = int(num_ranks)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.device_put = device_put
        self.prefetch = max(int(prefetch), 0)
        per_rank = len(source) // self.num_ranks
        self.steps_per_epoch = per_rank // self.batch
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"source of {len(source)} examples < one batch per rank "
                f"({self.num_ranks} ranks x {self.batch})")

    def _host_batches(self, epoch: int) -> Iterator[Any]:
        perm = _epoch_perm(len(self.source), self.seed, epoch, self.shuffle)
        shards = [perm[r::self.num_ranks] for r in range(self.num_ranks)]
        for step in range(self.steps_per_epoch):
            lo = step * self.batch
            idx = np.stack([s[lo:lo + self.batch] for s in shards])  # (R, B)
            got = self.source[idx.reshape(-1)]
            if not isinstance(got, tuple):
                got = (got,)
            yield tuple(
                a.reshape((self.num_ranks, self.batch) + a.shape[1:])
                for a in got)

    def epoch(self, epoch: int = 0) -> Iterator[Any]:
        """Iterate one epoch (pass the epoch number for a fresh shuffle)."""
        it = self._host_batches(epoch)
        if not self.device_put:
            return it
        put = _DevicePut(self.device)
        return map(put.take, prefetch_to_device(map(put.put, it),
                                                self.prefetch))

    def __iter__(self):
        return self.epoch(0)


def prefetch_to_device(it: Iterator[Any], size: int) -> Iterator[Any]:
    """Run ``it`` on a daemon thread, keeping up to ``size`` items queued.

    Items are produced (and any device copy inside ``it`` issued) ahead of
    the consumer, overlapping host work and host-to-device copies with
    device compute.  Exceptions on the worker re-raise at the consumer's
    next ``next()``.
    """
    if size <= 0:
        yield from it
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    END, ERR = object(), object()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(END)
        except BaseException as e:  # noqa: BLE001 -- reraised at consumer
            put((ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is ERR:
                raise item[1]
            yield item
    finally:
        # consumer done or gone early (break, exception, GeneratorExit):
        # unblock and join the worker, then drop the queued batches so
        # their device memory frees promptly
        stop.set()
        t.join(timeout=5.0)
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
