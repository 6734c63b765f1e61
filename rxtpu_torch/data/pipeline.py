"""Host input pipeline (counterpart of ``Pipeline`` in
``rxtpu/data/pipeline.py``), over a raw ``PackStore``.

- train / val: G=3 views ``[img, neg, pos]``, each with its own random site;
  with ``two_site=True`` G=6 as in test mode. Train shuffles each epoch with
  ``default_rng((seed*1000003 + epoch) & 0x7FFFFFFF)`` and drops the last
  partial batch.
- test: G=6 views ``[img_s1, img_s2, neg_s1, neg_s2, pos_s1, pos_s2]``.

The negative control is the plate's B02 well; the positive control and the
sites are drawn from a per-sample generator keyed by ``(seed, 0x5EED, epoch,
stream position)``, as in rxtpu, so batches are bit-equal to rxtpu's and a
mid-epoch resume (``epoch(e, start_batch)``) replays the same stream.
Batches carry ``images`` uint8 [B, G, C, H, W], ``labels`` (sirna; -1 for
test rows), per-sample ``mean``/``std``, ``valid`` and ``id_codes``, padded
to ``batch_size`` (``valid`` = 0, ``id_codes`` = ""). A background thread
assembles batches ahead into a bounded queue; ``device_prefetch`` queues
the next batch's copy to the card from pinned host memory before the
current batch is handed out.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.records import MetadataIndex, WellRecord
from rxtpu_torch.data.stats import Stats, stats_table


def host_shard_bounds(global_batch: int, num_hosts: int, host_id: int) -> Tuple[int, int]:
    """[start, stop) rows of a global batch owned by ``host_id``."""
    if global_batch % num_hosts:
        raise ValueError(f"batch {global_batch} does not split over {num_hosts} hosts")
    per_host = global_batch // num_hosts
    return host_id * per_host, (host_id + 1) * per_host


class _NpRandom:
    """numpy Generator -> the ``randrange`` that ``control_views`` uses."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng

    def randrange(self, n: int) -> int:
        return int(self._rng.integers(0, n))


class Pipeline:
    """Batches of one split's samples in ``mode`` train, val or test."""

    def __init__(self, index: MetadataIndex, store: PackStore, stats: Stats,
                 batch_size: int, mode: str = "test", seed: int = 0,
                 shuffle: Optional[bool] = None, drop_last: Optional[bool] = None,
                 prefetch_depth: int = 2, two_site: bool = False):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, got {mode!r}")
        self.index = index
        self.store = store
        self.batch_size = batch_size
        self.mode = mode
        self.seed = seed
        self.shuffle = shuffle if shuffle is not None else mode == "train"
        self.drop_last = drop_last if drop_last is not None else mode == "train"
        self.prefetch_depth = prefetch_depth
        self.two_site = two_site
        self.G = 6 if (mode == "test" or two_site) else 3
        self.n_channels = store.n_channels
        exps = sorted(stats.keys())
        missing = {r.experiment for r in index.records} - set(exps)
        if missing:
            raise ValueError(f"stats artifact lacks experiments {sorted(missing)}")
        self._exp_index = {e: i for i, e in enumerate(exps)}
        self._mean_table, self._std_table = stats_table(stats, exps)

    def __len__(self) -> int:
        n = len(self.index)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _view_keys(self, r: WellRecord, rng: np.random.Generator):
        neg, pos = self.index.control_views(r.experiment, r.plate, _NpRandom(rng))
        if self.G == 3:
            # an independent random site per view
            return [(r, int(rng.integers(1, 3))), (neg, int(rng.integers(1, 3))),
                    (pos, int(rng.integers(1, 3)))]
        return [(r, 1), (r, 2), (neg, 1), (neg, 2), (pos, 1), (pos, 2)]

    def _sample_rng(self, epoch: int, stream_pos: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, 0x5EED, epoch, stream_pos)))

    def _make_batch(self, recs: List[WellRecord], epoch: int, row0: int
                    ) -> Dict[str, object]:
        g, c, s = self.G, self.n_channels, self.store.h
        lo, hi = host_shard_bounds(self.batch_size, 1, 0)
        bs = hi - lo
        n_real = len(recs)
        labels = np.zeros(bs, np.int32)
        exp_ids = np.zeros(bs, np.int32)
        valid = np.zeros(bs, np.float32)
        id_codes = [recs[i].id_code if i < n_real else "" for i in range(self.batch_size)]
        keys = []
        for k, i in enumerate(range(lo, hi)):
            r = recs[i] if i < n_real else recs[0]  # pad with sample 0, masked
            keys += self._view_keys(r, self._sample_rng(epoch, row0 + i))
            labels[k] = r.sirna
            exp_ids[k] = self._exp_index[r.experiment]
            valid[k] = 1.0 if i < n_real else 0.0
        images = self.store.get_decoded_batch(keys).reshape(bs, g, c, s, s)
        return {
            "images": images,
            "labels": labels,
            "mean": self._mean_table[exp_ids],
            "std": self._std_table[exp_ids],
            "valid": valid,
            "id_codes": id_codes,
        }

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.index)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng((self.seed * 1000003 + epoch) & 0x7FFFFFFF)
        return rng.permutation(n)

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Dict[str, object]]:
        """Yield the epoch's batches from ``start_batch`` on, assembled ahead
        by a thread. Skipped batches are not assembled; the rest draw what
        they would draw in a full epoch."""
        order = self._order(epoch)
        records = self.index.records
        bs = self.batch_size
        batches = [[records[j] for j in order[i * bs:(i + 1) * bs]] for i in range(len(self))]
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch_depth))
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # an abandoned consumer must not leave the producer blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bi in range(start_batch, len(batches)):
                    # row0 stays the absolute stream offset of the epoch
                    if stop.is_set() or not put_or_stop(
                            self._make_batch(batches[bi], epoch, bi * bs)):
                        return
                put_or_stop(None)
            except BaseException as e:  # surfaced to the consumer, re-raised there
                put_or_stop(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


def device_prefetch(host_iter: Iterator[Dict[str, object]], device: torch.device):
    """Yield batches as tensors on ``device``, one batch ahead of consumption.

    On a CUDA device the arrays go through pinned host memory and a
    ``non_blocking`` copy on the current stream, queued before batch k is
    yielded: the host does not wait for the transfer, but on the card batch
    k+1's copy runs ahead of batch k's work, not beside it. Non-array
    entries (``id_codes``) stay on the host.
    """
    cuda = torch.device(device).type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
            else:
                out[k] = v
        return out

    prev = None
    for batch in host_iter:
        cur = put(batch)
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev
