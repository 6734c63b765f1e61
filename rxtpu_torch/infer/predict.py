"""Test-time prediction (counterpart of ``_make_predict_body`` in
``rxtpu/train/step.py`` and of ``rxtpu/infer/tta.py``).

One predict step: raw uint8 batch -> K1 normalize (bf16 views, full size
unless ``crop_size``) -> the BN-folded ``TwoSitesNN`` in the compute dtype (a
model that does not fold, DenseNet or the ArcFace head, unfolded under
autocast: ``rxtpu_torch.infer.fold.unfolded_twin``) -> f32 softmax,
optionally averaged over dihedral TTA variants (probabilities or logits). With ``fused_stem=True`` the kernel K5 runs crop, normalize and
the whole stem on the raw batch and the twin goes on from the stem's maps
(no TTA: its transforms act on the views). ``predict_dataset`` drains a
test ``Pipeline`` and drops the padding rows by their empty ``id_codes``;
given a ``DummyClassifier`` (``--debug`` local mode) it feeds it the raw
views and takes the softmax of its logits, as rxtpu's ``model_fn`` path.
With a process ``group`` each rank predicts its rows (its ``Pipeline``
slice, with the whole head) and the probabilities and ids are gathered in
global row order to every rank, as rxtpu replicates its predictions.

The scanned predict (``rxtpu/infer/tta.py:72-203``): with a ``scan_step``
(``make_scanned_tta_predict_step``, or any ``WindowStep`` over a per-batch
step) or ``scan_window`` K > 1, ``predict_dataset`` drains the pipeline in
windows of K batches, one graph replay each on the card
(``rxtpu_torch.train.step.WindowStep``). The windows are stacked into
pinned memory one ahead (``double_buffer``); a short tail window is padded
by repeating its last batch, so the graph keeps one shape, and the pad
slices are dropped. Each window's probabilities are copied back
asynchronously, so the host stacks window k+2 while the card runs window
k; at most two windows are in flight. Only in one process and without a
``DummyClassifier``, as rxtpu's (``rxtpu/cli.py:488``); otherwise it
predicts per batch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rxtpu_torch.data.pipeline import Pipeline, device_prefetch, double_buffer, stack_window
from rxtpu_torch.infer.fold import fold
from rxtpu_torch.models.twosites import DummyClassifier, TwoSitesNN
from rxtpu_torch.parallel.multihost import all_gather_objects, all_gather_rows, comm_device
from rxtpu_torch.utils import spans

if TYPE_CHECKING:  # train.step imports infer.fold: no import cycle at run time
    from rxtpu_torch.train.step import WindowStep

View = Callable[[torch.Tensor], torch.Tensor]

# dihedral variants of NCHW views [B, G, C, H, W] (H = -2, W = -1)
_TTA_VARIANTS: Dict[str, View] = {
    "identity": lambda v: v,
    "hflip": lambda v: v.flip(-1),
    "vflip": lambda v: v.flip(-2),
    "rot180": lambda v: v.flip(-2, -1),
    "rot90": lambda v: v.transpose(-2, -1).flip(-2),
    "rot270": lambda v: v.transpose(-2, -1).flip(-1),
    "transpose": lambda v: v.transpose(-2, -1),
    "anti_transpose": lambda v: v.transpose(-2, -1).flip(-2, -1),
}

_TTA_NAMES = {
    "none": ["identity"],
    "flips": ["identity", "hflip", "vflip", "rot180"],
    "dihedral": ["identity", "hflip", "vflip", "rot180", "rot90", "rot270",
                 "transpose", "anti_transpose"],
}


def tta_transforms(tta: str) -> List[View]:
    if tta not in _TTA_NAMES:
        raise ValueError(f"unknown tta mode {tta!r}")
    return [_TTA_VARIANTS[n] for n in _TTA_NAMES[tta]]


class Predictor:
    """The predict step over a model's BN-folded twin, in ``dtype``.

    ``model`` is an unfolded ``TwoSitesNN`` with f32 parameters; the twin
    is folded in f32 and then cast to ``dtype`` (bf16 compute with f32
    parameters, as rxtpu), or for a model that does not fold, an f32 copy
    run under autocast in ``dtype``. ``fused_stem=True`` raises ``ValueError`` with
    TTA transforms (``rxtpu/train/step.py:302``) or a model that does not
    fold.
    """

    def __init__(self, model: TwoSitesNN, crop_size: Optional[int] = None,
                 tta: str = "none", average: str = "probs",
                 dtype: torch.dtype = torch.bfloat16, fused_stem: bool = False):
        if average not in ("probs", "logits"):
            raise ValueError(f"unknown tta average mode {average!r}")
        if fused_stem and tta != "none":
            raise ValueError("TTA transforms need materialized views; "
                             "fused_stem=True is incompatible")
        self.transforms = tta_transforms(tta)
        self.net, self.front = fold(model, crop_size, dtype, fused_stem)
        self.average = average

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{images uint8 [B,G,C,H,W], mean/std f32 [B,C]} -> f32 probs [B, classes]."""
        views = self.front(batch["images"], batch["mean"], batch["std"])
        return average_variants(self.net, views, self.transforms, self.average)


def average_variants(net: Callable, views: torch.Tensor, transforms: List[View],
                     average: str) -> torch.Tensor:
    """f32 probabilities of ``net`` over the TTA variants of ``views``:
    softmax outputs averaged (``probs``), or one softmax of the averaged
    logits (``logits``)."""
    acc = None
    for t in transforms:
        logits = net(t(views)).float()
        term = torch.softmax(logits, dim=-1) if average == "probs" else logits
        acc = term if acc is None else acc + term
    acc = acc / len(transforms)
    return acc if average == "probs" else torch.softmax(acc, dim=-1)


def make_scanned_tta_predict_step(model: TwoSitesNN, crop_size: Optional[int] = None,
                                  tta: str = "none", average: str = "probs", window: int = 2,
                                  dtype: torch.dtype = torch.bfloat16) -> WindowStep:
    """``Predictor`` over windows of ``window`` batches: [K, B, G, C, H, W] ->
    [K, B, classes], each slice the per-batch step's (``rxtpu/infer/tta.py:72``)."""
    from rxtpu_torch.train.step import make_scanned_predict_step

    return make_scanned_predict_step(Predictor(model, crop_size, tta, average, dtype),
                                     window)


def predict_dataset(step: Callable, pipe: Pipeline, device: torch.device, group=None,
                    scan_window: int = 1, scan_step: Optional[WindowStep] = None
                    ) -> Tuple[np.ndarray, List[str]]:
    """(probs [N, classes], id_codes [N]) for a test pipeline, padding removed.
    ``step`` maps a batch to probabilities, or is a ``DummyClassifier``.
    ``group``: the process group whose ranks hold ``pipe``'s slices, in
    rank order. ``scan_step`` (a ``WindowStep`` built once and shared by
    every experiment) or ``scan_window`` > 1 (a new one over ``step``)
    predicts in windows, in one process without a ``DummyClassifier``."""
    # the keep mask comes from id_codes, so `valid` never goes to the device
    host_batches = ({k: v for k, v in b.items() if k != "valid"} for b in pipe.epoch(0))
    if (scan_step is not None or scan_window > 1) and group is None \
            and not isinstance(step, DummyClassifier):
        if scan_step is None:
            from rxtpu_torch.train.step import make_scanned_predict_step

            scan_step = make_scanned_predict_step(step, scan_window)
        return _predict_windows(scan_step, host_batches, device)
    if isinstance(step, DummyClassifier):
        dummy = step

        def step(batch):
            return torch.softmax(dummy(batch["images"]), dim=-1)
    probs, ids = [], []
    for i, batch in enumerate(device_prefetch(host_batches, device)):
        ids.append(batch.pop("id_codes"))
        with spans.span("predict.step", batch=i):
            out = step(batch)
        with spans.span("predict.readback", batch=i):
            probs.append(out.cpu())  # a readback per batch bounds the work in flight
        del out  # the device output goes before the next step runs
    probs_t = torch.cat(probs)
    if group is not None:
        # [ranks * batches * rows] in rank order -> batch by batch, ranks within
        n_batches, rows = len(ids), len(ids[0])
        probs_t = all_gather_rows(probs_t.to(comm_device()), group).cpu()
        probs_t = probs_t.reshape((-1, n_batches, rows) + tuple(probs_t.shape[1:]))
        probs_t = probs_t.transpose(0, 1).reshape((-1,) + tuple(probs_t.shape[3:]))
        parts = all_gather_objects(ids, group)
        ids = [part[b] for b in range(n_batches) for part in parts]
    return _keep_real(probs_t, [i for batch_ids in ids for i in batch_ids])


def _keep_real(probs: torch.Tensor, ids: List[str]) -> Tuple[np.ndarray, List[str]]:
    """The rows whose id is not empty (padding rows have ``""``)."""
    keep = np.asarray([i != "" for i in ids])
    return probs.numpy()[keep], [i for i in ids if i != ""]


def _predict_windows(scan_step: WindowStep, host_batches, device: torch.device
                     ) -> Tuple[np.ndarray, List[str]]:
    """The windowed drain (``rxtpu/infer/tta.py:158``): windows of K batches,
    the tail padded by its last batch, each window's output copied to pinned
    host memory behind its replay; the host waits for window k-1's copy
    after queueing window k."""
    k = scan_step.window
    cuda = torch.device(device).type == "cuda"

    def windows():
        buf = []
        for b in host_batches:
            buf.append(b)
            if len(buf) == k:
                yield buf
                buf = []
        if buf:
            yield buf

    def put_window(item):
        w, bufs = item
        ids = [b.pop("id_codes") for b in bufs]
        n_real = len(bufs)
        return stack_window(bufs + [bufs[-1]] * (k - n_real), device, w), ids, n_real

    def retire(w, event):
        """Wait for window ``w``'s copy (None: its output is on the host)."""
        with spans.span("predict.readback", batch=w):
            if event is not None:
                event.synchronize()

    done: List[Tuple[torch.Tensor, List[List[str]], int]] = []
    pending = None  # the event behind the previous window's copy
    for w, (window, ids, n_real) in enumerate(double_buffer(enumerate(windows()), put_window)):
        with spans.span("predict.step", batch=w):
            out = scan_step(window)  # [K, B, classes], overwritten by the next replay
        event = None
        if cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)  # queued behind this replay, before the next
            event = torch.cuda.Event()
            event.record()
        else:
            host = out
        if w > 0:
            retire(w - 1, pending)  # window k-1 done: at most two in flight
        pending = event
        done.append((host, ids, n_real))
    if done:
        retire(len(done) - 1, pending)
    probs = torch.cat([host[i] for host, _, n_real in done for i in range(n_real)])
    return _keep_real(probs, [i for _, ids, _ in done for batch_ids in ids for i in batch_ids])
