"""The comparisons that decide ``correct``, and their numbers.

Train (the first three steps of the window's own step and feed against
the float32 reference's): ``loss_gap``, the largest relative gap of a
step's loss; ``grad1_gap``, the worst leaf's gap between the norms of the
first gradient as the optimizer got it (the program's momentum buffers
after one step) measured against the reference's norm of that leaf or of
the median leaf, whichever is larger; ``update3_gap``, the same for the
parameters' change over the three steps; ``grad1_rel``, the median
leaf's relative L2 distance between the two first gradients, element by
element (the weight decay term, the same on both sides, taken out), which
sees rounding that leaves a leaf's norm as it was. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of all
three. ``logit1_rel``: over the rows of the first step, the mean of each
row's RMS gap between the program's logits (its own forward's, as the step
made them) and the reference's, both centred, over the RMS of the
reference's: the forward's rounding, before the backward amplifies it.

Predict (every answer of the window, and a sample drawn from the seed
against the float32 reference): ``id_gap``, answers whose well is not the
one due at their place, or missing; ``logit_rel``, over the sampled
answers the mean of each one's RMS gap between its log-probabilities and
the reference's, both centred (a logit error), over the RMS of the
reference's centred log-probabilities. ``psum_gap``, ``logprob_gap``,
``tv_*`` and ``logit_rms`` are printed beside them.

Each number is held to the limit of its name in the cell's limits file;
a number above its limit, or one that is not finite, is not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

LIVE_LEAF = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in leaves.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], live: List[str]):
    """Each live leaf's gap, largest first."""
    med = float(np.median([ref[n] for n in live]))
    return sorted(((abs(prog[n] - ref[n]) / max(ref[n], med), n) for n in live), reverse=True)


def _rel_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              decay: Dict[str, torch.Tensor], live: List[str]):
    """Each live leaf's ||prog - ref|| / ||ref - decay||, largest first."""
    out = []
    for n in live:
        r = ref[n].double()
        gap = float((prog[n].double() - r).norm())
        out.append((gap / max(float((r - decay[n].double()).norm()), 1e-30), n))
    return sorted(out, reverse=True)


def _logit_rel(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """Over every row of the given steps, the mean of the RMS gap between
    the program's and the reference's centred logits over the RMS of the
    reference's; not finite where the rows do not match."""
    if not ref or len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return math.inf
    p, r = torch.cat(prog).double(), torch.cat(ref).double()
    p, r = p - p.mean(1, keepdim=True), r - r.mean(1, keepdim=True)
    return float(((p - r).square().mean(1).sqrt() / r.square().mean(1).sqrt()).mean())


def train_numbers(prog: dict, ref: dict, decay: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``decay``: each leaf's weight decay term in the first gradient
    (decay rate times the initial weights)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = _norms(ref["g1"])
    med = float(np.median(list(g_ref.values())))
    live = [n for n in g_ref if g_ref[n] >= LIVE_LEAF * med]
    if set(prog["g1"]) != set(g_ref):
        raise ValueError("the program's leaves are not the reference's")
    grad = _leaf_gaps(_norms(prog["g1"]), g_ref, live)
    update = _leaf_gaps(_norms(prog["delta"]), _norms(ref["delta"]), live)
    rel = _rel_gaps(prog["g1"], ref["g1"], decay, live)
    return {"loss_gap": loss_gap, "grad1_gap": grad[0][0], "update3_gap": update[0][0],
            "grad1_rel": float(np.median([g for g, _ in rel])),
            "logit1_rel": _logit_rel(prog["logits1"], ref["logits1"]),
            "grad1_median": float(np.median([g for g, _ in grad])),
            "update3_median": float(np.median([g for g, _ in update])),
            "worst_leaves": {"grad1": grad[:3], "update3": update[:3], "grad1_rel": rel[:3],
                             "left_out": len(g_ref) - len(live)}}


def predict_numbers(passes: List[tuple], expected_ids: List[str], sample: List[tuple],
                    ref_logprobs: np.ndarray) -> Dict[str, float]:
    """``passes``: (probs [N, classes], ids) of each pass; ``sample``: (pass,
    row) pairs; ``ref_logprobs``: the reference's log-probabilities of the
    sampled rows, in the sample's order."""
    id_gap, psum_gap = 0, 0.0
    for probs, ids in passes:
        n = len(expected_ids)
        id_gap += abs(len(ids) - n) + sum(a != b for a, b in zip(ids, expected_ids))
        if len(probs):
            psum_gap = max(psum_gap, float(np.abs(probs.astype(np.float64).sum(1) - 1.0).max()))
    got = np.stack([passes[p][0][r] for p, r in sample]).astype(np.float64)
    ref = np.exp(ref_logprobs)
    tv = 0.5 * np.abs(got - ref).sum(1)
    ratio = np.log(np.maximum(got, 1e-30)) - ref_logprobs
    ratio -= ratio.mean(1, keepdims=True)
    spread = ref_logprobs - ref_logprobs.mean(1, keepdims=True)
    rms, ref_rms = np.sqrt((ratio ** 2).mean(1)), np.sqrt((spread ** 2).mean(1))
    return {"id_gap": float(id_gap), "psum_gap": psum_gap,
            "logprob_gap": float(np.abs(np.log(np.maximum(got, 1e-30)) - ref_logprobs).max()),
            "tv_max": float(tv.max()), "tv_mean": float(tv.mean()),
            "logit_rms": float(rms.mean()), "logit_rel": float((rms / ref_rms).mean())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {value, limit, ok}} for every number, in the limits' order."""
    out = {}
    for name, limit in limits.items():
        v = numbers[name]
        out[name] = {"value": v, "limit": limit, "ok": math.isfinite(v) and v <= limit}
    return out
