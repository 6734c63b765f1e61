"""Train and eval steps (counterpart of ``rxtpu/train/step.py``).

The train step: per-step generators seeded by ``(seed, step)`` (as rxtpu's
``fold_in(base_key, step)``, so a resumed run draws the same numbers), the
augmentation on the raw uint8 batch (K2-K4 for ``shear``), the forward in
the compute dtype under ``torch.autocast`` (with the labels, so the ArcFace
head's margin logits feed the loss and the accuracy, as in rxtpu), the f32
cross-entropy, the backward, the masked weight decay and the SGD update. The augmentation has
no gradient: it acts on the input before the model. Metrics: ``loss``,
``accuracy``, ``grad_norm``, ``grad_norm/{backbone,head}`` (of the raw
gradients) and the ``lr`` this step used, as 0-dim tensors on the device.

On a mesh (``rxtpu_torch.parallel``) the batch is the rank's slice of the
global batch: the augment and dropout draws are the global batch's, of
which the rank takes its rows; the gradients are averaged over the data
ranks right after the backward (before the norms, weight decay and
nesterov); the loss and accuracy are averaged over them; the norms count
each replicated tensor once and sum the tensor-parallel shards over the
model ranks. So world N computes world 1's step on the same global batch.

The eval step: K1 center crop + normalize (``eval_batch_normalize``, bf16
views), the BN-folded twin in the compute dtype (a model that does not fold
evaluates unfolded, on its running statistics), then exact sums
``loss_sum``, ``correct`` and ``count`` over the valid rows. With
``fused_stem=True`` the kernel K5 runs crop, normalize and the whole stem on
the raw batch, and the twin goes on from the stem's maps
(``rxtpu_torch.infer.fold.fold``).

The scanned steps (rxtpu's ``make_scanned_eval_step`` and
``make_scanned_predict_step``, ``rxtpu/train/step.py:257,348``): a window
of K batches stacked on a leading axis, one device dispatch for the K. On
the card ``WindowStep`` captures K calls of the per-batch step into one CUDA
graph and replays it once per window; on the CPU it makes the K calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rxtpu_torch.infer.fold import fold
from rxtpu_torch.ops import get_augment_fn, launch_counters
from rxtpu_torch.parallel.dp import allreduce_grads, tp_named_parameters
from rxtpu_torch.train.optim import head_only_mask, make_optimizer, masked_grads_with_wd

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the global
    step and what the step needs besides: the head mask in
    ``model.parameters()`` order, the weight decay and the lr schedule."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    head_mask: List[bool]
    weight_decay: float = 0.0
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr_schedule: Callable[[int], float],
               momentum: float = 0.9, nesterov: bool = True,
               weight_decay: float = 0.0) -> "TrainState":
        names = [n for n, _ in model.named_parameters()]
        return cls(model=model, optimizer=make_optimizer(model.parameters(), momentum, nesterov),
                   lr_schedule=lr_schedule, head_mask=head_only_mask(names),
                   weight_decay=weight_decay)


def step_seed(seed: int, step: int, stream: int) -> int:
    """A 64-bit seed for one (run seed, global step, stream) triple."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])


def step_generators(seed: int, step: int, device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(augmentation generator on the CPU, dropout generator on ``device``).
    The augmentation draws are tiny, so they come from the CPU and are the
    same whatever device the step runs on."""
    aug = torch.Generator().manual_seed(step_seed(seed, step, 0))
    drop = torch.Generator(device=device).manual_seed(step_seed(seed, step, 1))
    return aug, drop


def _norm(sq: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(sq).sum().sqrt()


def make_train_step(model: torch.nn.Module, crop_size: int, augment: str = "shear",
                    compute_dtype: torch.dtype = torch.bfloat16, mesh=None) -> Callable:
    """``step(state, batch, seed, backbone_trainable) -> metrics``; updates
    ``state`` in place. batch: images uint8 [B, G, C, H, W], labels int
    [B], mean/std f32 [B, C], all on one device (for ``augment="none"``,
    images are normalized NCHW views); on a ``mesh``, the rank's rows."""
    augment_fn = get_augment_fn(augment)
    autocast = compute_dtype != torch.float32
    tp_ids = {id(p) for _, p in tp_named_parameters(model, mesh)}

    def step_fn(state: TrainState, batch: Batch, seed: int,
                backbone_trainable: bool) -> Dict[str, torch.Tensor]:
        model = state.model
        images = batch["images"]
        device = images.device
        aug_gen, drop_gen = step_generators(seed, state.step, device)
        b = images.shape[0]
        rows = (0, b) if mesh is None else mesh.batch_rows(b)
        views = augment_fn(images, batch["mean"], batch["std"], aug_gen,
                           crop_size=crop_size, train=True, rows=rows)
        labels = batch["labels"].long()
        model.train()
        model.set_dropout_generator(drop_gen, rows)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            logits = model(views, labels=labels)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        model.set_dropout_generator(None)

        params = list(model.parameters())
        if mesh is not None:
            allreduce_grads(params, mesh.data_group)
        with torch.no_grad():
            sq = [n.square() for n in torch._foreach_norm([p.grad.float() for p in params])]
            tp = [i for i, p in enumerate(params) if id(p) in tp_ids]
            if tp:  # a shard's square sum -> the whole weight's
                whole = torch.stack([sq[i] for i in tp])
                torch.distributed.all_reduce(whole, group=mesh.model_group)
                for i, v in zip(tp, whole.unbind()):
                    sq[i] = v
            metrics = {
                "loss": loss.detach(),
                "accuracy": (logits.argmax(-1) == labels).float().mean(),
                "grad_norm": _norm(sq),
                "grad_norm/backbone": _norm([s for s, h in zip(sq, state.head_mask) if not h]),
                "grad_norm/head": _norm([s for s, h in zip(sq, state.head_mask) if h]),
            }
            if mesh is not None and mesh.data_size > 1:  # their mean over the data ranks
                both = torch.stack([metrics["loss"], metrics["accuracy"]])
                torch.distributed.all_reduce(both, group=mesh.data_group)
                metrics["loss"], metrics["accuracy"] = (both / mesh.data_size).unbind()
        masked_grads_with_wd(params, [backbone_trainable or h for h in state.head_mask],
                             state.weight_decay)
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        state.step += 1
        return metrics

    return step_fn


class EvalStep:
    """The eval step over the BN-folded (or unfolded) twin of ``model`` as it is now; build
    a new one after the weights change. ``fused_stem=True`` needs a foldable
    model (``ValueError`` otherwise)."""

    def __init__(self, model: torch.nn.Module, crop_size: int,
                 dtype: torch.dtype = torch.bfloat16, fused_stem: bool = False):
        self.net, self.front = fold(model, crop_size, dtype, fused_stem)

    @torch.inference_mode()
    def logits(self, batch: Batch) -> torch.Tensor:
        """f32 logits [B, classes] of a raw batch."""
        return self.net(self.front(batch["images"], batch["mean"], batch["std"])).float()

    @torch.inference_mode()
    def __call__(self, batch: Batch) -> Dict[str, torch.Tensor]:
        logits = self.logits(batch)
        labels = batch["labels"].long()
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        losses = F.cross_entropy(logits, labels, reduction="none")
        correct = (logits.argmax(-1) == labels).float()
        return {"loss_sum": (losses * valid).sum(), "correct": (correct * valid).sum(),
                "count": valid.sum()}


class WindowStep:
    """``step`` over a window of K batches, ``{key: [K, ...]}`` (``images``
    uint8 [K, B, G, C, H, W], ``mean``/``std`` f32 [K, B, C], and whatever
    else ``step`` reads), K = ``window``; ``reduce`` combines the K outputs.

    On CUDA the first call copies the window into static input buffers, runs
    it once eagerly on a side stream (a warm-up: the kernels' libraries
    load, K5's and K8's shared-memory limits are set and cuDNN settles its
    algorithms, none of it under capture), then captures the K calls over
    the static slices into one ``torch.cuda.CUDAGraph``. Every call, the
    first included, copies the window into the static inputs and replays the
    graph: one dispatch for K batches. It returns the static output, which
    the next call overwrites: read it (or queue a copy of it) before then.
    A failed capture or replay raises; nothing falls back to the per-batch
    loop. The kernel wrappers count host calls, so a replay would add
    nothing to their launch counts: the launches the capture recorded are
    added on each replay, and those of the warm-up and the capture itself
    are taken back out (set-up, not the path's work).

    On the CPU it makes the K per-batch calls (the plain version, with the
    same numbers)."""

    def __init__(self, step: Callable[[Batch], Any], window: int,
                 reduce: Callable[[List[Any]], Any]):
        if window < 1:
            raise ValueError(f"the window must hold at least one batch, got {window}")
        self.step, self.window, self.reduce = step, window, reduce
        self.graph = None
        self._static: Dict[str, torch.Tensor] = {}
        self._out = None
        self._per_replay: List[Tuple[Any, int]] = []

    def _run(self, batches: Batch):
        return self.reduce([self.step({k: v[i] for k, v in batches.items()})
                            for i in range(self.window)])

    def __call__(self, batches: Batch):
        k = batches["images"].shape[0]
        if k != self.window or any(v.shape[0] != k for v in batches.values()):
            raise ValueError(f"a window of {self.window} batches expected, got "
                             f"{ {key: tuple(v.shape) for key, v in batches.items()} }")
        device = batches["images"].device
        if device.type == "cpu":
            return self._run(batches)
        if device.type != "cuda":
            raise ValueError(f"WindowStep runs on cuda or cpu, got {device}")
        if self.graph is None:
            self._capture(batches)  # its static inputs hold this window
        else:
            self._load(batches)
        self.graph.replay()
        for counter, n in self._per_replay:
            counter.launches += n
        return self._out

    def _load(self, batches: Batch) -> None:
        if set(batches) != set(self._static):
            raise ValueError(f"the window holds {sorted(batches)}, the graph was captured "
                             f"on {sorted(self._static)}")
        for key, t in self._static.items():
            v = batches[key]
            if v.shape != t.shape or v.dtype != t.dtype or v.device != t.device:
                raise ValueError(f"{key}: {v.dtype} {tuple(v.shape)} on {v.device}; the graph "
                                 f"was captured on {t.dtype} {tuple(t.shape)} on {t.device}")
            t.copy_(v)

    def _capture(self, batches: Batch) -> None:
        device = batches["images"].device
        static = {key: v.clone(memory_format=torch.contiguous_format)
                  for key, v in batches.items()}
        counters = launch_counters()
        before = [c.launches for c in counters]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run(static)
        torch.cuda.current_stream(device).wait_stream(side)
        warm = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the pipeline's decode threads may call the CUDA
            # runtime while this thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._run(static)
        except Exception as e:
            raise RuntimeError(f"capturing {self.window} calls of the step into a CUDA graph "
                               f"failed: {e}") from e
        finally:
            captured = [c.launches - w for c, w in zip(counters, warm)]
            for c, b in zip(counters, before):
                c.launches = b
        self._per_replay = [(c, n) for c, n in zip(counters, captured) if n]
        self._static, self._out, self.graph = static, out, graph


def _stack(outs: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(outs)


def _sum_metrics(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {key: torch.stack([o[key] for o in outs]).sum(0) for key in outs[0]}


def make_scanned_predict_step(step: Callable[[Batch], torch.Tensor], window: int
                              ) -> WindowStep:
    """``step`` (a ``Predictor``, ``QuantPredictor`` or any batch ->
    probabilities [B, classes]) over a window: [K, B, classes], each slice
    the per-batch step's output on that batch (``rxtpu/train/step.py:348``)."""
    return WindowStep(step, window, _stack)


def make_scanned_eval_step(eval_step: Callable[[Batch], Dict[str, torch.Tensor]],
                           window: int) -> WindowStep:
    """``eval_step`` (an ``EvalStep``) over a window: ``loss_sum``,
    ``correct`` and ``count`` summed over the K batches in f32, as K calls
    summed (``rxtpu/train/step.py:257``)."""
    return WindowStep(eval_step, window, _sum_metrics)
