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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rxtpu_torch.data.pipeline import Pipeline, device_prefetch
from rxtpu_torch.infer.fold import fold
from rxtpu_torch.models.twosites import DummyClassifier, TwoSitesNN

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


def predict_dataset(step: Callable, pipe: Pipeline, device: torch.device
                    ) -> Tuple[np.ndarray, List[str]]:
    """(probs [N, classes], id_codes [N]) for a test pipeline, padding removed.
    ``step`` maps a batch to probabilities, or is a ``DummyClassifier``."""
    if isinstance(step, DummyClassifier):
        dummy = step

        def step(batch):
            return torch.softmax(dummy(batch["images"]), dim=-1)
    # the keep mask comes from id_codes, so `valid` never goes to the device
    host_batches = ({k: v for k, v in b.items() if k != "valid"} for b in pipe.epoch(0))
    all_probs, all_ids = [], []
    for batch in device_prefetch(host_batches, device):
        id_codes = batch.pop("id_codes")
        probs = step(batch).cpu().numpy()
        keep = np.asarray([i != "" for i in id_codes])
        all_probs.append(probs[keep])
        all_ids.extend(i for i in id_codes if i != "")
    return np.concatenate(all_probs, axis=0), all_ids
