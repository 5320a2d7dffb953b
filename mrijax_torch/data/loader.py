"""Batching, epoch shuffling, and device prefetch.

Counterpart of ``mrijax/data/loader.py``, in one process:

* a seeded permutation per epoch (``set_epoch`` semantics match
  ``DistributedSampler.set_epoch``; the same index order as the JAX package);
* a background prefetch thread keeps ``prefetch`` batches ahead. On the card
  the thread stacks a batch into pinned host memory and starts its copy with
  ``non_blocking=True`` on a side stream; the consumer's stream waits on that
  copy's event before the batch is handed out, so the host-to-device copy
  overlaps the step that is running;
* ``device_put=False`` yields host numpy batches, for host-side consumers and
  for timing the host pipeline alone.

Sharding a batch over several devices or processes comes with the parallel
port.
"""

import queue
import threading
from typing import Optional, Union

import numpy as np
import torch

from mrijax_torch._device import require_device


def epoch_permutation(n: int, epoch: int, seed: int = 0) -> np.ndarray:
    """Deterministic per-epoch shuffle (``DistributedSampler`` parity:
    generator seeded with seed+epoch)."""
    return np.random.default_rng(seed + epoch).permutation(n)


def _stack_batch(samples):
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples], axis=0)
    return out


class BatchLoader:
    """Iterates a map-style dataset in batches of dicts.

    Yields dicts of tensors on ``device`` (default the card; ``"cpu"`` where
    the caller asks for it), or of numpy arrays with ``device_put=False``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        transform=None,
        device_put: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.transform = transform
        self.device_put = device_put
        self.device = require_device(device) if device_put else None
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # propagate to datasets with per-epoch state (e.g. VolumeDataset3D
        # crop seeding) — including through subset/split views
        ds = self.dataset
        seen = set()
        while ds is not None and id(ds) not in seen:
            seen.add(id(ds))
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)
            ds = getattr(ds, "dataset", None)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        n = len(self.dataset)
        idx = (
            epoch_permutation(n, self.epoch, self.seed)
            if self.shuffle
            else np.arange(n)
        )
        for b in range(len(self)):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def _host_batch(self, chunk: np.ndarray):
        batch = _stack_batch([self.dataset[int(i)] for i in chunk])
        if self.transform is not None:
            batch = self.transform(batch)
        return batch

    def _to_device(self, batch, stream=None):
        """Tensors of ``batch`` on the loader's device. On the card: pinned
        host copies sent with ``non_blocking=True`` on ``stream`` (or the
        current stream), and the event that marks the copies' end."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}, None
        with torch.cuda.stream(stream or torch.cuda.current_stream(self.device)):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record()
        return out, done

    def _hand_over(self, item):
        """The batch as the consumer may use it: on the card, its stream
        waits for the copy, and the copies are marked as used on that stream
        (they were allocated on the side stream)."""
        batch, done = item
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for v in batch.values():
                v.record_stream(current)
        return batch

    def _materialize(self, chunk: np.ndarray, stream=None):
        batch = self._host_batch(chunk)
        if not self.device_put:
            return batch, None
        return self._to_device(batch, stream)

    def __iter__(self):
        if self.prefetch <= 0:
            for chunk in self._batches():
                yield self._hand_over(self._materialize(chunk))
            return

        # Bounded prefetch with a clean-shutdown contract: the consumer may
        # abandon iteration at any point (debug_max_steps, preemption, an
        # exception in train_step) — the generator's finally block then sets
        # the stop event and DRAINS the queue so the producer's blocked
        # q.put wakes up, sees the event, and exits instead of leaking a
        # thread that pins `prefetch` materialized batches forever.
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error = []
        on_card = self.device_put and self.device.type == "cuda"
        stream = torch.cuda.Stream(device=self.device) if on_card else None

        def producer():
            try:
                for chunk in self._batches():
                    item = self._materialize(chunk, stream)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                while not stop.is_set():  # consumer stops on event otherwise
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield self._hand_over(item)
            t.join()
            if error:
                raise error[0]
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            try:
                t.join(timeout=5.0)
            except TypeError:
                # generator finalized during interpreter shutdown:
                # threading internals are already torn down and join()'s
                # machinery is gone; the daemon thread dies with the process
                pass


class _IndexView:
    """Read-only view of a dataset through an index array (shared by
    ``take_subset`` and ``split_dataset``; ``BatchLoader.set_epoch``
    propagates through the ``dataset`` attribute)."""

    def __init__(self, ds, indices):
        self.dataset = ds
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


def take_subset(dataset, fraction: Optional[float] = None, max_items: Optional[int] = None,
                seed: int = 42):
    """Deterministic random subset view (the reference trains on ⅓ / ¼ of all
    slices via ``torch.utils.data.Subset`` — `slice_cond_2d_ddpm/model.py:74-77`)."""

    n = len(dataset)
    k = n
    if fraction is not None:
        k = int(n * fraction)
    if max_items is not None:
        k = min(k, max_items)
    idx = np.random.default_rng(seed).permutation(n)[:k]
    return _IndexView(dataset, idx)


def split_dataset(dataset, val_fraction: float = 0.1, seed: int = 0):
    """Random train/val split of a map-style dataset
    (reference ``random_split`` with fixed generator, model.py:79-82)."""
    n = len(dataset)
    idx = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_fraction)
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    return _IndexView(dataset, train_idx), _IndexView(dataset, val_idx)
