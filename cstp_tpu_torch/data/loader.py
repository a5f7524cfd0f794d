"""Host-side clip loaders and the prefetch onto the device: the port of
the JAX package's ``data/loader.py``.

* per-epoch deterministic shuffling seeded by epoch, sharded per process
  (``process_index::process_count``);
* a thread pool for frame decode (PIL releases the GIL);
* :func:`prefetch_to_device`: a background thread copies each host batch
  through a small ring of pinned buffers into device tensors on its own
  CUDA stream while the previous step computes.

``PretrainLoader`` and ``FinetuneLoader`` yield the JAX package's batches
bitwise: the same numpy draws, in the same order, from the same seeds.
They emit raw uint8 frames and host-side pretext labels; the augmentation
runs on the device inside the step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from cstp_tpu_torch.pretext.sampling import (
    sample_clip_pair_host,
    strided_frame_indices,
    wraparound_frame_indices,
)


def _epoch_permutation(n: int, epoch: int, seed: int,
                       shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    rng = np.random.default_rng(seed * 1_000_003 + epoch)
    return rng.permutation(n)


class PretrainLoader:
    """Yields pretrain batches: two raw clips and the temporal pretext
    labels.

    ``echo > 1`` is data echoing: each host-loaded batch is yielded
    ``echo`` times (the same object), and since the augmentation runs on
    the device from the step's generator, every echo trains on a different
    view pair.
    """

    def __init__(self, dataset, batch_size: int, sample_duration: int,
                 seed: int = 1, num_workers: int = 4, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 echo: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.sample_duration = sample_duration
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.echo = max(1, echo)

    def __len__(self):
        n = self.ds.num_videos() // self.process_count
        batches = (n // self.batch_size if self.drop_last
                   else -(-n // self.batch_size))
        return batches * self.echo

    def _load_one(self, vid: int, rng: np.random.Generator):
        nframes, _ = self.ds.video_meta(vid)
        s = sample_clip_pair_host(rng, nframes, self.sample_duration)
        f1 = self.ds.read_frames(vid, s.indices_1)
        f2 = self.ds.read_frames(vid, s.indices_2)
        return f1, f2, s

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        perm = _epoch_permutation(self.ds.num_videos(), epoch, self.seed,
                                  True)
        perm = perm[self.process_index::self.process_count]
        bs = self.batch_size
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(perm) - (bs - 1 if self.drop_last
                                               else 0), bs):
                ids = perm[start:start + bs]
                rngs = [np.random.default_rng((self.seed, epoch, int(v)))
                        for v in ids]
                results = list(pool.map(self._load_one, ids, rngs))
                samples = [r[2] for r in results]
                batch = {
                    "frames1": np.stack([r[0] for r in results]),
                    "frames2": np.stack([r[1] for r in results]),
                    "rot1": np.asarray([s.rot_label_1 for s in samples],
                                       np.int32),
                    "rot2": np.asarray([s.rot_label_2 for s in samples],
                                       np.int32),
                    "tem": np.asarray([s.tem_label for s in samples],
                                      np.int32),
                    "pb": np.asarray([s.pb_label for s in samples], np.int32),
                }
                for _ in range(self.echo):
                    yield batch


class FinetuneLoader:
    """Single-clip loader for finetune and validation: clips at a fixed
    ``pb_rate`` stride, from a random start in training and from the centre
    in validation. With ``drop_last=False`` (validation) the tail batch is
    padded by repeating its last clip, and ``mask`` is 0 on the padding."""

    def __init__(self, dataset, batch_size: int, sample_duration: int,
                 pb_rate: int = 4, train: bool = True, seed: int = 1,
                 num_workers: int = 4, drop_last: Optional[bool] = None,
                 process_index: int = 0, process_count: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.sample_duration = sample_duration
        self.pb_rate = pb_rate
        self.train = train
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = train if drop_last is None else drop_last
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self):
        if self.drop_last:
            return (self.ds.num_videos() // self.process_count
                    ) // self.batch_size
        # every process iterates the largest shard's batch count
        max_shard = -(-self.ds.num_videos() // self.process_count)
        return -(-max_shard // self.batch_size)

    def _clip_indices(self, nframes: int,
                      rng: Optional[np.random.Generator]):
        cr = (self.sample_duration - 1) * self.pb_rate
        if nframes - cr <= 0:
            return wraparound_frame_indices(nframes, self.sample_duration,
                                            self.pb_rate)
        if rng is None:  # deterministic centre clip for validation
            start = (nframes - cr - 1) // 2
        else:
            start = int(rng.integers(0, nframes - cr))
        return strided_frame_indices(start, self.sample_duration,
                                     self.pb_rate)

    def _load_one(self, vid: int, epoch: int):
        nframes, label = self.ds.video_meta(vid)
        rng = (np.random.default_rng((self.seed, epoch, int(vid)))
               if self.train else None)
        idx = self._clip_indices(nframes, rng)
        return self.ds.read_frames(vid, idx), label

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        perm = _epoch_permutation(self.ds.num_videos(), epoch, self.seed,
                                  self.train)
        perm = perm[self.process_index::self.process_count]
        bs = self.batch_size
        if self.drop_last:
            stop = max(len(perm) - (bs - 1), 0)
        else:
            # every process runs the same number of eval steps: iterate to
            # the largest shard's batch count, a process past its own
            # videos emitting fully masked padding batches
            max_shard = -(-self.ds.num_videos() // self.process_count)
            stop = -(-max_shard // bs) * bs if max_shard else 0
        with ThreadPoolExecutor(self.num_workers) as pool:
            prev_frames = None
            for start in range(0, stop, bs):
                ids = perm[start:start + bs]
                if len(ids) == 0:
                    if prev_frames is None:
                        f0, _ = self._load_one(int(perm[0]) if len(perm)
                                               else 0, epoch)
                        prev_frames = f0[None]
                    frames = np.repeat(prev_frames[-1:], bs, axis=0)
                    yield {"frames": frames,
                           "labels": np.zeros((bs,), np.int32),
                           "mask": np.zeros((bs,), np.float32)}
                    continue
                results = list(pool.map(self._load_one, ids,
                                        [epoch] * len(ids)))
                frames = np.stack([r[0] for r in results])
                labels = np.asarray([r[1] for r in results], np.int32)
                mask = np.ones((len(ids),), np.float32)
                if len(ids) < bs:
                    pad = bs - len(ids)
                    frames = np.concatenate(
                        [frames, np.repeat(frames[-1:], pad, axis=0)])
                    labels = np.concatenate(
                        [labels, np.repeat(labels[-1:], pad)])
                    mask = np.concatenate([mask, np.zeros((pad,),
                                                          np.float32)])
                prev_frames = frames
                yield {"frames": frames, "labels": labels, "mask": mask}


class _PinnedRing:
    """A ring of ``size`` pinned host buffers shaped like one batch, reused
    in turn; a slot is refilled only after the copy out of it, recorded by
    its event, has finished."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.events = [None] * size
        self.i = 0

    def fill(self, batch: Dict[str, np.ndarray]
             ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Copy ``batch`` into the next slot; returns the slot's buffers
        and its number."""
        i = self.i
        self.i = (i + 1) % len(self.slots)
        if self.events[i] is not None:
            self.events[i].synchronize()
        slot = self.slots[i]
        if slot is None or slot.keys() != batch.keys() or any(
                slot[k].shape != v.shape or slot[k].dtype != _dtype(v)
                for k, v in batch.items()):
            slot = {k: torch.empty(v.shape, dtype=_dtype(v), pin_memory=True)
                    for k, v in batch.items()}
            self.slots[i] = slot
        for k, v in batch.items():
            slot[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        return slot, i

    def record(self, i: int, event) -> None:
        self.events[i] = event


def _dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(a[:0]).dtype


def prefetch_to_device(iterator, device, depth: int = 2):
    """Yield the batches of ``iterator`` (dicts of numpy arrays) as dicts of
    tensors on ``device``, landed ``depth`` batches ahead by one background
    thread.

    On CUDA the thread copies each batch into a pinned buffer of a small
    reused ring, then into device tensors with ``non_blocking=True`` on its
    own stream, and records an event; the consumer's current stream waits
    on that event and ``record_stream`` keeps the caching allocator from
    reusing the tensors' memory while the consumer still uses them. On the
    CPU the batches become tensors sharing the arrays' memory, in the same
    order. A batch that is the same host object as the one before (data
    echoing) reuses the tensors already landed. An exception in the loader
    is raised again here.
    """
    dev = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    done = object()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                ring = _PinnedRing(2)
            last_host = last_item = None
            for batch in iterator:
                if stop.is_set():
                    return
                if batch is last_host:
                    if not put(last_item):
                        return
                    continue
                if dev.type == "cuda":
                    pinned, slot = ring.fill(batch)
                    with torch.cuda.stream(stream):
                        landed = {k: v.to(dev, non_blocking=True)
                                  for k, v in pinned.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                    ring.record(slot, event)
                    item = (landed, event)
                else:
                    item = ({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in batch.items()}, None)
                last_host, last_item = batch, item
                if not put(item):
                    return
        except Exception as e:  # raised again on the consumer's thread
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            landed, event = item
            if event is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                for v in landed.values():
                    v.record_stream(current)
            yield landed
    finally:
        stop.set()
        t.join()
