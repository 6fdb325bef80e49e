"""Host-side data loading: samplers, collation, threaded prefetch.

The port's own copy of ``unirestore_tpu/data/loader.py``: ``WeightedMixture``,
``collate`` and ``DataLoader`` (threaded iterator included) are copied as they
are, so the same seeds give the same arrays; ``device_prefetch`` stages
batches onto the card (pinned memory, a side stream) in place of the JAX
file's ``jax.device_put``. The loader produces fixed-shape NHWC numpy batches
on a background thread pool so host preprocessing overlaps device steps.
Replaces torch DataLoader + WeightedRandomSampler (reference
data/__init__.py:113-132).
"""

from __future__ import annotations

import numpy as np


class WeightedMixture:
    """ConcatDataset + WeightedRandomSampler(replacement=True) equivalent.

    ``datasets`` with per-DATASET weights applied per-sample, exactly like
    the reference's per-sample weight lists [0.2, 10, 1]
    (data/__init__.py:113-120). Sampling is two-stage — dataset by total
    probability mass, then a uniform index — which is distribution-
    identical to a flat per-sample draw (weights are constant within a
    dataset) without rng.choice re-validating a ~1.3M-entry probability
    vector on every sample.
    """

    def __init__(self, datasets, weights, seed: int = 0):
        self.datasets = list(datasets)
        sizes = np.array([len(d) for d in self.datasets], np.float64)
        mass = sizes * np.asarray(weights, np.float64)
        self.p_dataset = mass / mass.sum()
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return int(self.offsets[-1])

    def sample_dataset(self):
        return int(self.rng.choice(len(self.datasets), p=self.p_dataset))

    def sample_in(self, ds_idx: int):
        return int(self.rng.integers(len(self.datasets[ds_idx])))

    def sample_index(self):
        ds_idx = self.sample_dataset()
        return ds_idx, self.sample_in(ds_idx)


def collate(samples):
    """Stack same-shape samples into a batch dict. Ragged 'gt' (detection
    dicts) stays a list; None 'gt'/'hq' are dropped."""
    out = {}
    first = samples[0]
    for key in ("lq", "hq"):
        if first.get(key) is not None:
            out[key] = np.stack([s[key] for s in samples]).astype(np.float32)
    gt = [s.get("gt") for s in samples]
    if gt[0] is not None:
        if isinstance(gt[0], (np.ndarray, np.integer, int)) and not \
                isinstance(gt[0], dict):
            out["gt"] = np.stack([np.asarray(g) for g in gt])
        else:
            out["gt"] = gt
    out["fname"] = [s["fname"] for s in samples]
    tasks = {s["task"] for s in samples}
    if len(tasks) > 1:  # batches must be task-homogeneous (one jitted
        # step per task; the loader draws the dataset once per batch)
        raise ValueError(f"mixed-task batch: {sorted(tasks)}")
    out["task"] = first["task"]
    return out


class DataLoader:
    """Minimal iterator over a dataset or WeightedMixture.

    - shuffle/sequential or weighted-with-replacement sampling
    - drop_last for fixed shapes (no recompiles)
    - background thread prefetch (``num_workers`` threads decode/corrupt
      ahead; with replacement sampling the stream is infinite)
    """

    def __init__(self, source, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0,
                 prefetch: int = 4, seed: int = 0, infinite: bool = False):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.infinite = infinite or isinstance(source, WeightedMixture)
        self.epoch = 0
        # monotone per-sample draw counter for mixture streams: each visit
        # of a sample index gets a FRESH deterministic augmentation
        # (passed as that sample's `epoch` seed component). Without it an
        # infinite stream pins epoch=0 forever and every revisit replays
        # the bit-identical crop/corruption for the whole training run.
        self._draw = 0

    def __len__(self):
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_stream(self, epoch: int):
        if self.infinite:
            while True:
                yield -1
        else:
            n = len(self.source)
            order = np.arange(n)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
            yield from order.tolist()

    def _draw_sample(self, idx, epoch, ds_for_batch=None):
        """Resolve (dataset, local index, per-sample epoch seed)."""
        if isinstance(self.source, WeightedMixture):
            ds_idx = (self.source.sample_dataset()
                      if ds_for_batch is None else ds_for_batch)
            local = self.source.sample_in(ds_idx)
            seed_epoch = self._draw
            self._draw += 1
            return self.source.datasets[ds_idx], local, seed_epoch, ds_idx
        return self.source, idx, epoch, None

    def __iter__(self):
        # the epoch is counted at ITERATOR CREATION: a consumer that
        # breaks out early must not replay the identical shuffle order and
        # augmentations on its next iteration
        epoch = self.epoch
        self.epoch += 1
        if self.num_workers <= 0:
            yield from self._iter_sync(epoch)
        else:
            yield from self._iter_threaded(epoch)

    def _iter_sync(self, epoch):
        buf = []
        ds_for_batch = None
        for idx in self._index_stream(epoch):
            ds, local, e, ds_for_batch = self._draw_sample(
                idx, epoch, ds_for_batch)
            buf.append(ds.__getitem__(local, epoch=e))
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf = []
                ds_for_batch = None  # mixture: next batch redraws the task
        if buf and not self.drop_last:
            yield collate(buf)

    def _iter_threaded(self, epoch):
        """True worker-pool prefetch: ``num_workers`` threads decode/corrupt
        samples concurrently (numpy/cv2 and the native corruption kernels
        release the GIL), batches are assembled in order. Sampling decisions
        (weighted draws / shuffle order) stay on the consumer thread, so the
        stream is identical to the synchronous iterator; per-sample work is
        deterministic via index-seeded RNGs (datasets.py ``_Base.rng``)."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        depth = max(self.num_workers,
                    self.prefetch * max(1, self.batch_size))
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            futures: collections.deque = collections.deque()
            stream = self._index_stream(epoch)
            exhausted = False
            submitted = 0
            ds_for_batch = None

            def refill():
                nonlocal exhausted, submitted, ds_for_batch
                while not exhausted and len(futures) < depth:
                    try:
                        idx = next(stream)
                    except StopIteration:
                        exhausted = True
                        return
                    # batch boundary in SUBMISSION order == assembly order
                    if submitted % self.batch_size == 0:
                        ds_for_batch = None
                    ds, local, e, ds_for_batch = self._draw_sample(
                        idx, epoch, ds_for_batch)
                    futures.append(pool.submit(ds.__getitem__, local,
                                               epoch=e))
                    submitted += 1

            refill()
            buf = []
            while futures:
                buf.append(futures.popleft().result())
                refill()
                if len(buf) == self.batch_size:
                    yield collate(buf)
                    buf = []
            if buf and not self.drop_last:
                yield collate(buf)
        finally:
            # abandoning the iterator early (break / Ctrl-C) must not block
            # on ~depth in-flight decode jobs — drop everything not started
            pool.shutdown(wait=False, cancel_futures=True)


def device_prefetch(iterator, device, depth: int = 2):
    """Overlap host batch production with device execution by staging
    ``depth`` batches onto ``device`` ahead of consumption (the counterpart of
    the JAX loader's ``device_prefetch``, which staged them by
    ``jax.device_put``).

    Each batch's numpy arrays, and those of a dict in it (the padded
    detection targets), become tensors; the other entries pass through. On a
    CUDA device the arrays are copied into pinned host memory and from there,
    with ``non_blocking=True``, on a side stream; the batch carries an event
    recorded after its copies. When the batch is handed out, the consuming
    stream waits on that event (no host wait) and every tensor is marked with
    ``record_stream``, so its memory is not reused before the consumer is done
    with it. On the CPU the arrays are only converted.
    """
    import collections

    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    buf = collections.deque()

    def convert(b, fn):
        return {k: fn(v) if isinstance(v, np.ndarray)
                else convert(v, fn) if isinstance(v, dict) else v for k, v in b.items()}

    def tensors(b):
        for v in b.values():
            if isinstance(v, torch.Tensor):
                yield v
            elif isinstance(v, dict):
                yield from tensors(v)

    def put(b):
        if not cuda:
            return convert(b, lambda v: torch.from_numpy(np.ascontiguousarray(v))), None
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            b = convert(b, lambda v: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                        .to(device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(side)
        return b, ready

    def take(item):
        b, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for v in tensors(b):
                v.record_stream(stream)
        return b

    it = iter(iterator)
    try:
        for _ in range(depth):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield take(out)
