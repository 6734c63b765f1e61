"""The training loop (counterpart of ``rxtpu/train/loop.py``).

- validation before training (epoch 0, which seeds the best checkpoint)
  and after every epoch; the best checkpoint is saved on a strict
  improvement of val accuracy ("New best accuracy!");
- progressive unfreezing when pretrained ("head is unfrozen" at epoch 1,
  "Turn on all the layers" when the backbone joins);
- the loss of step i-1 is read back after step i is queued (lag one), so
  the host does not drain the card every step;
- a rolling full-state checkpoint ``models/last_{id}.ckpt`` every
  ``checkpoint_every_steps`` steps inside an epoch and after every epoch;
  ``resume`` continues from it, mid-epoch included, replaying the epoch's
  deterministic batch stream from ``batch_in_epoch``. An rxtpu pickle or
  orbax directory resumes too: its nesterov trace becomes the SGD momentum,
  and its best checkpoint stays as it is until a better one is written.
  With ``checkpoint_backend="orbax"`` both checkpoints are orbax directories
  holding rxtpu's payload (the momentum as optax's trace), at the same paths;
- early stopping on val accuracy with patience, where a tie is not an
  improvement;
- a per-epoch progress bar on stderr when it is a tty (``progress_bar``),
  with the lag-one loss as its postfix;
- before each epoch's validation, a ``perf`` line of ``StepTimer``'s
  ``step_time_s`` and ``input_stall_pct`` over the epoch's steps; while a
  span recorder is on (``rxtpu_torch.utils.spans``; the CLI's
  ``--profile``), a second ``perf`` line after the rolling checkpoint: the
  epoch's seconds in each span and its counter totals under the names of
  ``PERF_SECONDS`` and ``PERF_COUNTERS``.

On a mesh (``rxtpu_torch.parallel``; ``train_pipe`` and ``val_pipe`` the
rank's slices) every rank steps, validates its rows and sums
``correct·valid``, ``loss·valid`` and ``valid`` over the data ranks, so every
rank takes the same decisions. Rank 0 alone writes ``metrics.jsonl`` and
the checkpoints (the tensor-parallel shards gathered first, so the files
have a world-1 run's layout), and the ranks meet at a barrier after each
write, so that a resume finds the files. A resume loads the whole weights
on every rank, then cuts its shards.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Optional

import torch

from rxtpu_torch.config import Config
from rxtpu_torch.data.pipeline import Pipeline, device_prefetch
from rxtpu_torch.parallel.dp import (
    place_state, whole_model, whole_optimizer_state, whole_state_dict,
)
from rxtpu_torch.parallel.multihost import barrier
from rxtpu_torch.train.checkpoint import (
    BestCheckpointer, checkpoint_exists, load_train_state, save_checkpoint,
)
from rxtpu_torch.train.metrics import MetricLogger, StepTimer
from rxtpu_torch.train.optim import (
    backbone_trainable_at_epoch, sgd_state_from_trace, trace_from_sgd_state,
)
from rxtpu_torch.train.step import EvalStep, TrainState, make_train_step
from rxtpu_torch.utils import spans

# an epoch's ``perf`` keys: seconds in each span (validation's own feed is in
# the feed's spans too), and counter totals times their scale
PERF_SECONDS = {"pipeline.wait": "queue_wait_s", "prefetch.stage": "stage_s",
                "pipeline.assemble": "assemble_s", "train.readback": "readback_s",
                "train.validate": "validate_s", "train.checkpoint": "checkpoint_s"}
PERF_COUNTERS = {"prefetch.staged_bytes": ("staged_gib", 2.0 ** -30),
                 "pipeline.assembled_bytes": ("assembled_gib", 2.0 ** -30),
                 "pipeline.gets": ("gets", 1), "pipeline.gets_empty": ("gets_empty", 1)}


def perf_totals(rec: spans.Recorder, before: dict) -> Dict[str, float]:
    """The ``perf`` keys of what ``rec`` recorded since its snapshot ``before``."""
    d = rec.since(before)
    out = {key: d["seconds"].get(name, 0.0) for name, key in PERF_SECONDS.items()}
    out.update({key: d["counters"].get(name, 0) * scale
                for name, (key, scale) in PERF_COUNTERS.items()})
    return out


def last_checkpoint_path(cfg: Config) -> str:
    return os.path.join(cfg.train.checkpoint_dir, f"last_{cfg.experiment_id}.ckpt")


class _LineBar:
    """The bar without tqdm: one line on stderr, rewritten after ``\\r``."""

    def __init__(self, total: int, epoch: int):
        self.total, self.epoch, self.n, self.postfix, self._width = total, epoch, 0, "", 0

    def update(self, n: int = 1) -> None:
        self.n += n
        self._write(self._line())

    def set_postfix(self, refresh: bool = True, **kw) -> None:
        self.postfix = ", ".join(f"{k}={v}" for k, v in kw.items())
        if refresh:
            self._write(self._line())

    def _line(self) -> str:
        return f"epoch {self.epoch}: {self.n}/{self.total} {self.postfix}".rstrip()

    def _write(self, text: str) -> None:
        sys.stderr.write("\r" + text.ljust(self._width))
        sys.stderr.flush()
        self._width = max(self._width, len(text))

    def close(self) -> None:
        self._write("")  # blank the line, as tqdm's leave=False
        sys.stderr.write("\r")
        sys.stderr.flush()


def progress_bar(total: int, epoch: int):
    """The epoch's progress bar (``rxtpu/train/loop.py:46-56``, the
    reference's ignite ProgressBar): tqdm's, or ``_LineBar`` where tqdm is
    not installed; None when stderr is not a tty (logs stay clean)."""
    if not sys.stderr.isatty():
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return _LineBar(total, epoch)
    return tqdm(total=total, desc=f"epoch {epoch}", leave=False)


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_accuracy: float
    epochs_run: int
    history: list


class _NoLogger:
    """A rank other than 0 logs nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def evaluate(state: TrainState, pipe: Pipeline, device: torch.device, crop_size: int,
             dtype: torch.dtype, mesh=None) -> Dict[str, float]:
    """Exact loss / accuracy over a validation pipeline (on a mesh, over every
    data rank's slice; a tensor-parallel head evaluates whole)."""
    step = EvalStep(whole_model(state.model, mesh), crop_size, dtype)
    loss_sum, correct, count = 0.0, 0.0, 0.0
    batches = ({k: v for k, v in b.items() if k != "id_codes"} for b in pipe.epoch(0))
    for batch in device_prefetch(batches, device):
        m = step(batch)
        loss_sum += float(m["loss_sum"])
        correct += float(m["correct"])
        count += float(m["count"])
    if mesh is not None:
        sums = torch.tensor([loss_sum, correct, count], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(sums, group=mesh.data_group)
        loss_sum, correct, count = sums.tolist()
    count = max(count, 1.0)
    return {"loss": loss_sum / count, "accuracy": correct / count}


def run_training(cfg: Config, state: TrainState, train_pipe: Pipeline, val_pipe: Pipeline,
                 device: torch.device, seed: Optional[int] = None,
                 logger: Optional[MetricLogger] = None, print_fn: Callable = print,
                 resume: bool = False, mesh=None) -> TrainResult:
    """Run the epoch loop on ``device``; returns the final state and the best
    val accuracy. ``seed`` (default ``cfg.train.seed``) keys every step's
    draws. ``state`` holds whole weights; on a ``mesh`` they are cut to the
    rank's shards here, after a resume has loaded."""
    if cfg.train.early_stopping and cfg.train.patience < 1:
        raise ValueError("early stopping requires patience >= 1")
    seed = cfg.train.seed if seed is None else seed
    crop = cfg.data.crop_size
    dtype = getattr(torch, cfg.model.compute_dtype)
    train_step = make_train_step(state.model, crop, augment=cfg.train.augment_backend,
                                 compute_dtype=dtype, mesh=mesh)
    writer = mesh is None or mesh.rank == 0
    backend = cfg.train.checkpoint_backend
    ckpt = BestCheckpointer(cfg.checkpoint_path, write=writer, backend=backend)
    timer = StepTimer()
    history = []
    start_epoch, start_batch = 1, 0
    epochs_without_improvement = 0
    own_logger = logger is None
    if own_logger:
        logger = MetricLogger(cfg.train.board_dir, cfg.experiment_id) if writer else _NoLogger()

    last_path = last_checkpoint_path(cfg)
    names = [n for n, _ in state.model.named_parameters()]
    if resume and checkpoint_exists(last_path):
        saved = load_train_state(last_path)
        state.model.load_state_dict(saved["state_dict"])
        if "optimizer" in saved:
            state.optimizer.load_state_dict(saved["optimizer"])
        else:  # an rxtpu pickle or orbax directory: optax's trace is the momentum buffer
            state.optimizer.load_state_dict(
                sgd_state_from_trace(state.optimizer, names, saved["trace"]))
        state.step = int(saved["step"])
        ckpt.best = saved.get("best_metric")
        epochs_without_improvement = int(saved.get("epochs_without_improvement", 0))
        start_batch = int(saved.get("batch_in_epoch", 0))
        if start_batch > 0:
            start_epoch = int(saved["epoch"])
            print_fn(f"Resumed mid-epoch {start_epoch} at batch {start_batch} "
                     f"(step {state.step})")
        else:
            start_epoch = int(saved["epoch"]) + 1
            print_fn(f"Resumed from epoch {saved['epoch']} (step {state.step})")
    place_state(state, mesh)

    def payload(**meta) -> Dict:
        state_dict = whole_state_dict(state.model, mesh)
        opt = whole_optimizer_state(state.optimizer, state.model, mesh)
        if backend == "orbax":  # rxtpu's payload: the momentum as optax's trace
            return {"state_dict": state_dict, "step": state.step, **meta,
                    "momentum": trace_from_sgd_state(opt, names, state_dict)}
        return {"state_dict": state_dict, "optimizer": opt, "step": state.step, **meta}

    def save_last(**meta) -> None:
        with spans.span("train.checkpoint"):
            p = payload(**meta)
            if writer:
                save_checkpoint(last_path, backend=backend, **p)
            barrier()

    def validate(epoch: int) -> Dict[str, float]:
        with spans.span("train.validate"):
            val_m = evaluate(state, val_pipe, device, crop, dtype, mesh)
            improved = ckpt.update(val_m["accuracy"], payload())
            barrier()
        if improved:
            print_fn(f"New best accuracy! Accuracy: {val_m['accuracy']}\nModel saved!")
        print_fn(f"Validation Results - Epoch: {epoch} Average Loss: {val_m['loss']:.4f} "
                 f"| Accuracy: {val_m['accuracy']:.4f}")
        logger.log(state.step, val_m, prefix="validation")
        return {**val_m, "improved": improved}

    epochs_run = start_epoch - 1
    try:
        if start_epoch == 1 and start_batch == 0:
            validate(0)
        for epoch in range(start_epoch, cfg.train.nb_epochs + 1):
            if (cfg.train.early_stopping
                    and epochs_without_improvement >= cfg.train.patience):
                break  # a resumed run that had already stopped
            trainable = backbone_trainable_at_epoch(
                epoch, cfg.model.pretrained, cfg.train.freeze_head_only_epochs)
            if cfg.model.pretrained and epoch == 1:
                print_fn("head is unfrozen")
            if cfg.model.pretrained and epoch == cfg.train.freeze_head_only_epochs + 1:
                print_fn("Turn on all the layers")

            timer.reset()
            rec = spans.current()
            before = rec.snapshot() if rec is not None else None
            sb = start_batch if epoch == start_epoch else 0
            host = ({k: v for k, v in b.items() if k not in ("id_codes", "valid")}
                    for b in train_pipe.epoch(epoch, start_batch=sb))
            it = device_prefetch(host, device)
            pbar = progress_bar(len(train_pipe) - sb, epoch)
            batch_i = sb
            prev_m = None
            prev_loss = float("nan")
            while True:
                with timer.waiting(batch_i):
                    batch = next(it, None)
                if batch is None:
                    break
                with timer.stepping(batch_i):
                    m = train_step(state, batch, seed, trainable)
                    batch_i += 1
                    if prev_m is not None:  # lag-one readback: step i-1 is done
                        with spans.span("train.readback", batch=batch_i - 2):
                            prev_loss = float(prev_m["loss"])
                    prev_m = m
                if pbar is not None:
                    pbar.update(1)
                    pbar.set_postfix(loss=f"{prev_loss:.3f}", refresh=False)
                if state.step % cfg.train.log_every_steps == 0:
                    logger.log(state.step, {k: float(v) for k, v in m.items()},
                               prefix="training")
                every = cfg.train.checkpoint_every_steps
                if every and state.step % every == 0 and batch_i < len(train_pipe):
                    save_last(epoch=epoch, batch_in_epoch=batch_i, best_metric=ckpt.best,
                              epochs_without_improvement=epochs_without_improvement)
            if pbar is not None:
                pbar.close()
            logger.log(state.step, timer.summary(), prefix="perf")

            val_m = validate(epoch)
            history.append({"epoch": epoch, "loss": val_m["loss"],
                            "accuracy": val_m["accuracy"], **timer.summary()})
            epochs_run = epoch
            epochs_without_improvement = 0 if val_m["improved"] else epochs_without_improvement + 1
            save_last(epoch=epoch, best_metric=ckpt.best,
                      epochs_without_improvement=epochs_without_improvement)
            if rec is not None and rec is spans.current():
                logger.log(state.step, perf_totals(rec, before), prefix="perf")
            if cfg.train.early_stopping and epochs_without_improvement >= cfg.train.patience:
                print_fn(f"EarlyStopping: stop after {epoch} epochs")
                break
    finally:
        if own_logger:
            logger.close()
    return TrainResult(state=state, best_accuracy=float(ckpt.best or 0.0),
                       epochs_run=epochs_run, history=history)
