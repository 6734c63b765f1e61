"""Host input pipeline, test mode (counterpart of ``Pipeline`` in
``rxtpu/data/pipeline.py``).

Each test sample stacks both sites of the sample, its plate's B02 negative
control and one positive control: G=6 views in the order ``[img_s1, img_s2,
neg_s1, neg_s2, pos_s1, pos_s2]``. The positive control is drawn from a
per-sample generator keyed by ``(seed, 0x5EED, epoch, stream position)``, as
in rxtpu, so batches are bit-equal to rxtpu's. Batches are padded to
``batch_size`` (``valid`` = 0, ``id_codes`` = ""). A background thread
assembles batches ahead into a bounded queue; ``device_prefetch`` queues the
next batch's copy to the card from pinned host memory before the current
batch is handed out.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Tuple

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
    """Test-mode batches over a decoded store (a raw ``PackStore``)."""

    G = 6

    def __init__(self, index: MetadataIndex, store: PackStore, stats: Stats,
                 batch_size: int, seed: int = 0, prefetch_depth: int = 2):
        self.index = index
        self.store = store
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch_depth = prefetch_depth
        self.n_channels = store.n_channels
        exps = sorted(stats.keys())
        missing = {r.experiment for r in index.records} - set(exps)
        if missing:
            raise ValueError(f"stats artifact lacks experiments {sorted(missing)}")
        self._exp_index = {e: i for i, e in enumerate(exps)}
        self._mean_table, self._std_table = stats_table(stats, exps)

    def __len__(self) -> int:
        return (len(self.index) + self.batch_size - 1) // self.batch_size

    def _view_keys(self, r: WellRecord, rng: np.random.Generator):
        neg, pos = self.index.control_views(r.experiment, r.plate, _NpRandom(rng))
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
        exp_ids = np.zeros(bs, np.int32)
        valid = np.zeros(bs, np.float32)
        id_codes = [recs[i].id_code if i < n_real else "" for i in range(self.batch_size)]
        keys = []
        for k, i in enumerate(range(lo, hi)):
            r = recs[i] if i < n_real else recs[0]  # pad with sample 0, masked
            keys += self._view_keys(r, self._sample_rng(epoch, row0 + i))
            exp_ids[k] = self._exp_index[r.experiment]
            valid[k] = 1.0 if i < n_real else 0.0
        images = self.store.get_decoded_batch(keys).reshape(bs, g, c, s, s)
        return {
            "images": images,
            "mean": self._mean_table[exp_ids],
            "std": self._std_table[exp_ids],
            "valid": valid,
            "id_codes": id_codes,
        }

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, object]]:
        """Yield the batches in index order, assembled ahead by a thread."""
        records = self.index.records
        bs = self.batch_size
        batches = [records[i * bs:(i + 1) * bs] for i in range(len(self))]
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
                for bi, recs in enumerate(batches):
                    if stop.is_set() or not put_or_stop(
                            self._make_batch(recs, epoch, bi * bs)):
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
