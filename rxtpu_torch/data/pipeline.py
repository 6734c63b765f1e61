"""Host input pipeline (counterpart of ``ByteStore`` and ``Pipeline`` in
``rxtpu/data/pipeline.py``), over a pack or a JPEG or PNG tree.

Sources: a ``PackStore`` (decoded planes: a memcpy per view of a raw pack,
one inflate call of ``decoder_threads`` threads per batch of a compressed
one) or a ``ByteStore`` over
``{img_dir}/{split}/{experiment}/Plate{p}/{well}_s{site}_w{ch}.{ext}``
(``ext`` "jpeg" or "png"), either preloaded (every well's compressed bytes
cached in RAM, decoded per batch by ``decode_batch``) or streaming (paths
handed to ``decode_files``, which reads and decodes in the native pool),
both strict: a corrupt or missing file raises. Image batches decode for
``device``: numpy planes on the CPU; on the card a uint8 tensor there, from
nvJPEG for JPEGs and by one pinned copy of the host's planes for PNGs.

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
to ``batch_size`` (``valid`` = 0, ``id_codes`` = ""). With ``num_hosts`` >
1 (a data rank of ``rxtpu_torch.parallel``) every host builds the same
global epoch order and assembles only its rows ``host_shard_bounds(
batch_size, num_hosts, host_id)`` of each global batch of ``batch_size``:
the view draws stay keyed by the global row, so the hosts' slices
concatenate to the one-host batch bit for bit; ``id_codes`` are the host's
rows' (rxtpu's span the global batch: the port gathers predictions with
their ids, ``rxtpu_torch.infer.predict.predict_dataset``). A background thread
assembles batches ahead into a bounded queue; ``device_prefetch`` queues
the next batch's copy to the card from pinned host memory before the
current batch is handed out (``double_buffer``), and ``stack_window``
stacks a window of K batches into pinned memory for the scanned predict.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from rxtpu_torch.data.decode import decode_batch, decode_files
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.records import MetadataIndex, WellRecord, all_records, image_path
from rxtpu_torch.data.stats import Stats, stats_table
from rxtpu_torch.parallel.multihost import host_shard_bounds
from rxtpu_torch.utils import spans


class ByteStore:
    """A split's JPEG or PNG files: preloaded file bytes or paths to stream."""

    channels = (1, 2, 3, 4, 5, 6)

    def __init__(self, index: MetadataIndex, img_dir: str, ext: str = "jpeg",
                 preload: bool = True):
        self.index = index
        self.img_dir = img_dir
        self.ext = ext
        self._cache: Dict[Tuple[str, int, str, int], List[bytes]] = {}
        if preload:
            for r in all_records(index):
                for site in (1, 2):
                    self._cache[(r.experiment, r.plate, r.well, site)] = self._read(r, site)

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def preloaded(self) -> bool:
        return bool(self._cache)

    def paths(self, r: WellRecord, site: int) -> List[str]:
        return [image_path(self.img_dir, self.index.split, r.experiment, r.plate, r.well,
                           site, ch, self.ext) for ch in self.channels]

    def _read(self, r: WellRecord, site: int) -> List[bytes]:
        bufs = []
        for p in self.paths(r, site):
            with open(p, "rb") as f:
                bufs.append(f.read())
        return bufs

    def get(self, r: WellRecord, site: int) -> List[bytes]:
        cached = self._cache.get((r.experiment, r.plate, r.well, site))
        return self._read(r, site) if cached is None else cached


class _NpRandom:
    """numpy Generator -> the ``randrange`` that ``control_views`` uses."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng

    def randrange(self, n: int) -> int:
        return int(self._rng.integers(0, n))


class Pipeline:
    """Batches of one split's samples in ``mode`` train, val or test.

    With a ``ByteStore``, ``src_size`` is the planes' side (the pack knows its
    own), ``decoder_threads`` the decode or inflate pool's threads (0: every
    core) and ``device`` where images decode (``images`` is then a tensor
    there; a pack's batches stay numpy until ``device_prefetch``).
    ``batch_size`` is the global batch; ``num_hosts`` / ``host_id`` pick
    this host's rows of it.
    """

    def __init__(self, index: MetadataIndex, store: Union[PackStore, ByteStore],
                 stats: Stats, batch_size: int, mode: str = "test", seed: int = 0,
                 shuffle: Optional[bool] = None, drop_last: Optional[bool] = None,
                 prefetch_depth: int = 2, two_site: bool = False,
                 src_size: Optional[int] = None, decoder_threads: int = 0, device="cpu",
                 num_hosts: int = 1, host_id: int = 0):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, got {mode!r}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} is not in [0, {num_hosts})")
        self.rows = host_shard_bounds(batch_size, num_hosts, host_id)
        if isinstance(store, ByteStore) and src_size is None:
            raise ValueError("a ByteStore pipeline needs src_size")
        self.index = index
        self.store = store
        self.src_size = store.h if isinstance(store, PackStore) else src_size
        self.decoder_threads = decoder_threads
        self.device = torch.device(device)
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
        g, c, s = self.G, self.n_channels, self.src_size
        lo, hi = self.rows
        bs = hi - lo
        n_real = len(recs)
        labels = np.zeros(bs, np.int32)
        exp_ids = np.zeros(bs, np.int32)
        valid = np.zeros(bs, np.float32)
        id_codes = [recs[i].id_code if i < n_real else "" for i in range(lo, hi)]
        keys = []
        for k, i in enumerate(range(lo, hi)):
            r = recs[i] if i < n_real else recs[0]  # pad with sample 0, masked
            keys += self._view_keys(r, self._sample_rng(epoch, row0 + i))
            labels[k] = r.sirna
            exp_ids[k] = self._exp_index[r.experiment]
            valid[k] = 1.0 if i < n_real else 0.0
        if isinstance(self.store, PackStore):
            images = self.store.get_decoded_batch(keys, nthreads=self.decoder_threads)
        elif self.store.preloaded:
            bufs = [b for rec, site in keys for b in self.store.get(rec, site)]
            images = decode_batch(bufs, s, s, nthreads=self.decoder_threads, strict=True,
                                  device=self.device)
        else:
            paths = [p for rec, site in keys for p in self.store.paths(rec, site)]
            images = decode_files(paths, s, s, nthreads=self.decoder_threads, strict=True,
                                  device=self.device)
        images = images.reshape(bs, g, c, s, s)
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
                    if stop.is_set():
                        return
                    with spans.span("pipeline.assemble", batch=bi):
                        # row0 stays the absolute stream offset of the epoch
                        item = self._make_batch(batches[bi], epoch, bi * bs)
                    if spans.ON:
                        spans.count("pipeline.assembled_bytes", _array_bytes(item))
                    if not put_or_stop(item):
                        return
            except BaseException as e:  # surfaced to the consumer, re-raised there
                put_or_stop(e)

        t = threading.Thread(target=producer, name="pipeline-producer", daemon=True)
        t.start()
        try:
            for bi in range(start_batch, len(batches)):
                if spans.ON:
                    spans.count("pipeline.gets")
                    spans.count("pipeline.gets_empty", q.empty())
                with spans.span("pipeline.wait", batch=bi):
                    item = q.get()
                if isinstance(item, BaseException):
                    raise item
                spans.note_batch(bi)
                yield item
        finally:
            spans.note_batch(None)
            stop.set()
            t.join(timeout=10)


def double_buffer(host_iter: Iterator, put_fn: Callable[[Any], Any]) -> Iterator:
    """Yield ``put_fn(item)`` one item ahead of consumption
    (``rxtpu/data/pipeline.py:362``): item k+1 is put (stacked, pinned, its
    copy to the card queued) before item k is handed out. The one buffering
    policy of ``device_prefetch`` and the scanned predict's windows."""
    prev = None
    for item in host_iter:
        cur = put_fn(item)
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev


def device_prefetch(host_iter: Iterator[Dict[str, object]], device: torch.device):
    """Yield batches as tensors on ``device``, one batch ahead of consumption.

    Tensors (planes already decoded for the card) move only if they lie
    elsewhere. On a CUDA device the arrays go through pinned host memory and a
    ``non_blocking`` copy on the current stream, queued before batch k is
    yielded: the host does not wait for the transfer, but on the card batch
    k+1's copy runs ahead of batch k's work, not beside it. Non-array
    entries (``id_codes``) stay on the host.
    """
    cuda = torch.device(device).type == "cuda"

    def put(batch):
        out = {}
        with spans.span("prefetch.stage"):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    t = torch.from_numpy(v)
                    out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
                elif isinstance(v, torch.Tensor):
                    out[k] = v.to(device)
                else:
                    out[k] = v
        if spans.ON:
            spans.count("prefetch.staged_bytes", _array_bytes(batch, host_only=True))
        return out

    return double_buffer(host_iter, put)


def stack_window(batches: List[Dict[str, object]], device: torch.device,
                 window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The arrays of K batches stacked on a new leading axis on ``device``:
    numpy arrays into one pinned host buffer per key, then one
    ``non_blocking`` copy to the card (one plain tensor on the CPU); tensors
    already decoded onto the card stacked there. Non-array entries are
    left out. ``window`` (the window's index) is its ``prefetch.stage``
    span's ``batch``."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    with spans.span("prefetch.stage", batch=window):
        for k, v in batches[0].items():
            if isinstance(v, np.ndarray):
                buf = torch.empty((len(batches),) + v.shape, dtype=torch.from_numpy(v).dtype,
                                  pin_memory=cuda)
                for i, b in enumerate(batches):
                    buf[i].copy_(torch.from_numpy(b[k]))
                out[k] = buf.to(device, non_blocking=True) if cuda else buf
            elif isinstance(v, torch.Tensor):
                out[k] = torch.stack([b[k].to(device) for b in batches])
    if spans.ON:
        spans.count("prefetch.staged_bytes",
                    sum(_array_bytes(b, host_only=True) for b in batches))
    return out


def _array_bytes(batch: Dict[str, object], host_only: bool = False) -> int:
    """Bytes of a batch's arrays: numpy arrays, and tensors unless ``host_only``."""
    n = 0
    for v in batch.values():
        if isinstance(v, np.ndarray):
            n += v.nbytes
        elif isinstance(v, torch.Tensor) and not host_only:
            n += v.numel() * v.element_size()
    return n
