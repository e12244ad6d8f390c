"""Dataset routing + batching.

Parity: the reference's datasets/dataset.py. `SingleFrameData` skips known-bad
frames (dataset.py:39-47); `SequenceData` chunks frame lists into sequences by
`num_frames` (SimGrasp) or sequence boundaries (HO3D/DexYCB) and repairs None
frames with the nearest later good frame (dataset.py:86-99). Tracking batches
are whole sequences (batch_size forced to 1 sequence, dataset.py:106-107).

No torch DataLoader: batches are stacked numpy RawFrames produced by a plain
iterator with optional background-thread prefetch — device transfer and all
tensor preprocessing happen in prepare_batch.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from .schema import stack_frames


class SingleFrameData:
    """Random-access single frames with invalid-frame caching."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.invalid = set()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        for probe in range(len(self.dataset)):
            i = (index + probe) % len(self.dataset)
            if i in self.invalid:
                continue
            frame, meta = self.dataset[i]
            if bool(frame.valid):
                return frame, meta
            self.invalid.add(i)
        raise RuntimeError("no valid frames in dataset")


class SequenceData:
    """Groups frames into sequences; one item = (stacked RawFrame (T, ...),
    metas list)."""

    def __init__(self, dataset, num_frames: int | None = None):
        self.dataset = dataset
        if hasattr(dataset, "seq_start"):
            # explicit boundaries (HO3D/DexYCB loaders, dataset.py:58-62)
            starts = list(dataset.seq_start)
            ends = starts[1:] + [len(dataset)]
            self.sequences = [list(range(s, e)) for s, e in zip(starts, ends)]
        else:
            assert num_frames, "num_frames required without seq_start"
            n = len(dataset)
            self.sequences = [list(range(s, min(s + num_frames, n)))
                              for s in range(0, n, num_frames)]

    def __len__(self):
        return len(self.sequences)

    def __getitem__(self, index):
        # threaded frame loading: npz/png decode releases the GIL in
        # numpy/cv2 and per-frame host reads dominate eval wall-clock —
        # workers scale with available cores (a pool on a 1-core host only
        # adds contention, hence the serial path)
        import os as _os
        idxs = self.sequences[index]
        workers = min(8, _os.cpu_count() or 1)
        if workers > 1:
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                items = list(pool.map(self.dataset.__getitem__, idxs))
        else:
            items = [self.dataset[i] for i in idxs]
        frames, metas = [], []
        for frame, meta in items:
            frames.append(frame if bool(frame.valid) else None)
            metas.append(meta)
        # repair None frames with the nearest later good frame (dataset.py:86-99)
        last_good = None
        for i in reversed(range(len(frames))):
            if frames[i] is None:
                frames[i] = last_good
            else:
                last_good = frames[i]
        frames = [f for f in frames if f is not None] or frames
        if any(f is None for f in frames):
            raise RuntimeError(f"sequence {index} has no valid frames")
        return stack_frames(frames), metas


class BatchIterator:
    """Batches SingleFrameData into stacked RawFrames with thread prefetch."""

    def __init__(self, data: SingleFrameData, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.data) // self.batch_size
        if not self.drop_last and len(self.data) % self.batch_size:
            n += 1
        return n

    def _order(self):
        order = np.arange(len(self.data))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def __iter__(self):
        order = self._order()
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            for idx_batch in batches:
                items = [self.data[i] for i in idx_batch]
                frames = stack_frames([f for f, _ in items])
                metas = [m for _, m in items]
                q.put((frames, metas))
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def get_dataset(cfg, mode: str):
    name = cfg["data_cfg"]["dataset_name"]
    if name == "SimGrasp":
        from .simgrasp import SimGraspDataset
        return SimGraspDataset(cfg, mode)
    if name == "HO3D":
        from .ho3d import HO3DDataset
        return HO3DDataset(cfg, mode)
    if name == "DexYCB":
        from .dexycb import DexYCBDataset
        return DexYCBDataset(cfg, mode)
    raise NotImplementedError(name)


def get_dataloader(cfg, mode: str, shuffle: bool | None = None):
    """Tracking configs get SequenceData (whole sequences); training gets a
    batched single-frame iterator (dataset.py:104-114)."""
    dataset = get_dataset(cfg, mode)
    if cfg.get("track"):
        return SequenceData(dataset, cfg["data_cfg"].get("num_frames"))
    single = SingleFrameData(dataset)
    if shuffle is None:
        shuffle = mode == "train"
    # The reference's DataLoader never drops the ragged tail batch
    # (datasets/dataset.py:114: no drop_last) — at 350 samples / batch 32
    # that is 11 optimizer steps per epoch to a drop_last trainer's 10, a
    # systematic 10% step deficit that an IKNet quat-L1 bisect traced a
    # measurable quality gap to. The default is reference-faithful; set
    # `drop_last: true` for strict static shapes — REQUIRED with
    # dp_devices > 1, where the batch axis must stay divisible
    # (Trainer._shard_batch asserts).
    drop_last = cfg.get("drop_last")
    if drop_last is None:
        drop_last = bool(cfg.get("dp_devices", 0)) and mode == "train"
    return BatchIterator(single, cfg["batch_size"], shuffle=shuffle,
                         seed=cfg.get("seed", 0), drop_last=drop_last)
