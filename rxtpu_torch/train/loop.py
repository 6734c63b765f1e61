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
  deterministic batch stream from ``batch_in_epoch``. An rxtpu pickle
  resumes too: its nesterov trace becomes the SGD momentum, and its best
  checkpoint stays as it is until a better one is written;
- early stopping on val accuracy with patience, where a tie is not an
  improvement.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import torch

from rxtpu_torch.config import Config
from rxtpu_torch.data.pipeline import Pipeline, device_prefetch
from rxtpu_torch.train.checkpoint import (
    BestCheckpointer, checkpoint_exists, load_train_state, save_checkpoint,
)
from rxtpu_torch.train.metrics import MetricLogger, StepTimer
from rxtpu_torch.train.optim import backbone_trainable_at_epoch, sgd_state_from_trace
from rxtpu_torch.train.step import EvalStep, TrainState, make_train_step


def last_checkpoint_path(cfg: Config) -> str:
    return os.path.join(cfg.train.checkpoint_dir, f"last_{cfg.experiment_id}.ckpt")


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_accuracy: float
    epochs_run: int
    history: list


def evaluate(state: TrainState, pipe: Pipeline, device: torch.device, crop_size: int,
             dtype: torch.dtype) -> Dict[str, float]:
    """Exact loss / accuracy over a validation pipeline."""
    step = EvalStep(state.model, crop_size, dtype)
    loss_sum, correct, count = 0.0, 0.0, 0.0
    batches = ({k: v for k, v in b.items() if k != "id_codes"} for b in pipe.epoch(0))
    for batch in device_prefetch(batches, device):
        m = step(batch)
        loss_sum += float(m["loss_sum"])
        correct += float(m["correct"])
        count += float(m["count"])
    count = max(count, 1.0)
    return {"loss": loss_sum / count, "accuracy": correct / count}


def run_training(cfg: Config, state: TrainState, train_pipe: Pipeline, val_pipe: Pipeline,
                 device: torch.device, seed: Optional[int] = None,
                 logger: Optional[MetricLogger] = None, print_fn: Callable = print,
                 resume: bool = False) -> TrainResult:
    """Run the epoch loop on ``device``; returns the final state and the best
    val accuracy. ``seed`` (default ``cfg.train.seed``) keys every step's
    draws."""
    if cfg.train.early_stopping and cfg.train.patience < 1:
        raise ValueError("early stopping requires patience >= 1")
    seed = cfg.train.seed if seed is None else seed
    crop = cfg.data.crop_size
    dtype = getattr(torch, cfg.model.compute_dtype)
    train_step = make_train_step(state.model, crop, augment=cfg.train.augment_backend,
                                 compute_dtype=dtype)
    ckpt = BestCheckpointer(cfg.checkpoint_path)
    timer = StepTimer()
    history = []
    start_epoch, start_batch = 1, 0
    epochs_without_improvement = 0
    own_logger = logger is None
    if own_logger:
        logger = MetricLogger(cfg.train.board_dir, cfg.experiment_id)

    last_path = last_checkpoint_path(cfg)
    if resume and checkpoint_exists(last_path):
        saved = load_train_state(last_path)
        state.model.load_state_dict(saved["state_dict"])
        if "optimizer" in saved:
            state.optimizer.load_state_dict(saved["optimizer"])
        else:  # an rxtpu pickle: optax's trace is the momentum buffer
            names = [n for n, _ in state.model.named_parameters()]
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

    def payload(**meta) -> Dict:
        return {"state_dict": state.model.state_dict(), "optimizer": state.optimizer,
                "step": state.step, **meta}

    def validate(epoch: int) -> Dict[str, float]:
        val_m = evaluate(state, val_pipe, device, crop, dtype)
        improved = ckpt.update(val_m["accuracy"], payload())
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
            sb = start_batch if epoch == start_epoch else 0
            host = ({k: v for k, v in b.items() if k not in ("id_codes", "valid")}
                    for b in train_pipe.epoch(epoch, start_batch=sb))
            it = device_prefetch(host, device)
            batch_i = sb
            prev_m = None
            while True:
                with timer.waiting():
                    batch = next(it, None)
                if batch is None:
                    break
                with timer.stepping():
                    m = train_step(state, batch, seed, trainable)
                    batch_i += 1
                    if prev_m is not None:
                        float(prev_m["loss"])  # lag-one readback: step i-1 is done
                    prev_m = m
                if state.step % cfg.train.log_every_steps == 0:
                    logger.log(state.step, {k: float(v) for k, v in m.items()},
                               prefix="training")
                every = cfg.train.checkpoint_every_steps
                if every and state.step % every == 0 and batch_i < len(train_pipe):
                    save_checkpoint(last_path, **payload(
                        epoch=epoch, batch_in_epoch=batch_i, best_metric=ckpt.best,
                        epochs_without_improvement=epochs_without_improvement))
            logger.log(state.step, timer.summary(), prefix="perf")

            val_m = validate(epoch)
            history.append({"epoch": epoch, "loss": val_m["loss"],
                            "accuracy": val_m["accuracy"], **timer.summary()})
            epochs_run = epoch
            epochs_without_improvement = 0 if val_m["improved"] else epochs_without_improvement + 1
            save_checkpoint(last_path, **payload(
                epoch=epoch, best_metric=ckpt.best,
                epochs_without_improvement=epochs_without_improvement))
            if cfg.train.early_stopping and epochs_without_improvement >= cfg.train.patience:
                print_fn(f"EarlyStopping: stop after {epoch} epochs")
                break
    finally:
        if own_logger:
            logger.close()
    return TrainResult(state=state, best_accuracy=float(ckpt.best or 0.0),
                       epochs_run=epochs_run, history=history)
