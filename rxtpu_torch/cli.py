"""CLI of the port: ``rxtpu/cli.py``'s train -> test pipeline on the card.

Takes the same argv as ``rxtpu/cli.py`` (plus ``--device``), so one command
line works for both:

1. config resolution with rxtpu's rules (``--debug`` caps the examples,
   pretraining is off without ``--pretrained-path``, the source size comes
   from the pack's JSON);
2. training, unless ``models/best_model_{experiment_id}.ckpt`` exists (or
   ``--resume`` finds ``models/last_{experiment_id}.ckpt``): the stratified
   or experiment-wise split, the train and val pipelines over
   ``{pack}/train.rxpack``, and the epoch loop with validation, best and
   rolling checkpoints (``rxtpu_torch.train.loop``);
3. the test phase on the best checkpoint (an rxtpu pickle or the port's own
   format): plate groups from ``train.csv``, predict each test experiment
   through ``{pack}/test.rxpack`` with the BN-folded model, mask by plate,
   assign one class per row and write ``submission_{id}.csv``.

Flags whose path is not ported yet exit with a message that names them.

    python -m rxtpu_torch.cli --pack DIR --experiment_id ID [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from rxtpu_torch.config import (
    Config, DataConfig, ModelConfig, TrainConfig, debug_overrides, global_batch_size,
)

REFERENCE_EXPERIMENT_TYPES = [3, 1, 0, 0, 0, 0, 2, 2, 3, 0, 0, 3, 1, 0, 0, 0, 2, 3]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rxtpu_torch CLI")
    p.add_argument("--debug", default=False, action="store_true")
    p.add_argument("--experiment_id")
    p.add_argument("--lr", type=float)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--stats", default=None, help="stats artifact (.json or .pickle)")
    p.add_argument("--image-ext", default="jpeg", choices=["jpeg", "png"])
    p.add_argument("--pack", default=None, help="rxpack directory (raw packs only)")
    p.add_argument("--backbone", default=None, help="resnet18|34|50|101|152")
    p.add_argument("--head", default="mlp", choices=["mlp", "arcface"])
    p.add_argument("--pretrained-path", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--val-fraction", type=float, default=None)
    p.add_argument("--early-stopping", action="store_true")
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--no-scheduler", action="store_true")
    p.add_argument("--split-by-experiment", action="store_true")
    p.add_argument("--batch-size", type=int, default=None, help="per-device batch size")
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--two-site-train", action="store_true")
    p.add_argument("--test-crop", type=int, default=None,
                   help="center-crop test images to N (default: full size)")
    p.add_argument("--tta", default="none", choices=["none", "flips", "dihedral"])
    p.add_argument("--tta-average", default="probs", choices=["probs", "logits"])
    p.add_argument("--predict-scan-window", type=int, default=1)
    p.add_argument("--quantize", default="none", choices=["none", "int8"])
    p.add_argument("--calib-batches", type=int, default=2)
    p.add_argument("--calibrate", action="store_true",
                   help="neg-control embedding calibration in the head")
    p.add_argument("--fuse-blocks", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--augment", default="shear", choices=["shear", "gather"])
    p.add_argument("--assign-method", default="greedy",
                   choices=["greedy", "greedy_jax", "hungarian", "argmax"])
    p.add_argument("--no-plate-leak", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--experiment-types", default=None,
                   help="comma list of plate-group types per test experiment")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--nb-classes", type=int, default=None)
    p.add_argument("--checkpoint-every-steps", type=int, default=None)
    p.add_argument("--checkpoint-backend", default="pickle", choices=["pickle", "orbax"])
    p.add_argument("--profile", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _not_ported(args) -> Optional[str]:
    """The first flag of argv whose path is not ported yet, if any."""
    if args.debug and torch.device(args.device).type == "cpu":
        return "--debug on the CPU (local mode, DummyClassifier)"
    if args.head != "mlp":
        return f"--head {args.head}"
    if args.backbone and not args.backbone.startswith("resnet"):
        return f"--backbone {args.backbone}"
    if args.quantize != "none":
        return f"--quantize {args.quantize}"
    if args.assign_method == "greedy_jax":
        return "--assign-method greedy_jax"
    if args.predict_scan_window > 1:
        return "--predict-scan-window > 1"
    if args.distributed or args.model_parallel != 1:
        return "--distributed / --model-parallel (multi-device)"
    if not args.pack:
        return "JPEG/PNG input without --pack (the native decoder)"
    if args.fuse_blocks == "on":
        return "--fuse-blocks on (the fused bottleneck kernels K6/K7)"
    if args.checkpoint_backend != "pickle":
        return f"--checkpoint-backend {args.checkpoint_backend}"
    if args.profile:
        return "--profile"
    return None


def resolve_config(args) -> Config:
    """rxtpu's config resolution (``rxtpu/cli.py:116-188``); ``--debug`` runs
    only on a card here, so it is never the local mode."""
    cfg = Config(
        data=DataConfig(path_data=args.data_dir, image_ext=args.image_ext),
        model=ModelConfig(head=args.head, pretrained_path=args.pretrained_path),
        train=TrainConfig(),
        experiment_id=args.experiment_id,
    )
    if args.debug:
        cfg = debug_overrides(cfg, local=False)
    if args.pretrained_path:
        cfg.model.pretrained = True
    if args.backbone:
        cfg.model.backbone = args.backbone
    if args.epochs is not None:
        cfg.train.nb_epochs = args.epochs
    if args.val_fraction is not None:
        cfg.train.val_fraction = args.val_fraction
    if args.early_stopping:
        cfg.train.early_stopping = True
    if args.patience is not None:
        if args.patience < 1 and args.early_stopping:
            # EarlyStopping rejects patience < 1 when it is constructed; a
            # stray --patience without --early-stopping is inert
            raise SystemExit("--patience must be >= 1 (ignite parity: "
                             "EarlyStopping rejects patience < 1)")
        cfg.train.patience = args.patience
    if args.no_scheduler:
        cfg.train.scheduler = False
    if args.split_by_experiment:
        cfg.train.train_split_by_experiment = True
    cfg.train.checkpoint_every_steps = args.checkpoint_every_steps
    if args.batch_size is not None:
        cfg.train.bs_per_device = args.batch_size
        cfg.train.nb_examples = cfg.train.bs_per_device if args.debug else None
    if args.crop_size is not None:
        cfg.data.crop_size = args.crop_size
    if args.lr is not None:
        cfg.train.lr = args.lr
    if args.nb_classes is not None:
        cfg.model.nb_classes = args.nb_classes
    cfg.model.control_calibration = args.calibrate
    if args.fuse_blocks != "auto":
        cfg.model.fuse_blocks = args.fuse_blocks == "on"
    cfg.train.augment_backend = args.augment
    if args.stats is not None:
        cfg.data.stats_path = args.stats
    else:
        for cand in ("stats_experiments.json", "stats_experiments.pickle"):
            if os.path.exists(cand):
                cfg.data.stats_path = cand
                break
    if cfg.model.pretrained and not cfg.model.pretrained_path:
        # with nothing to load, the freeze schedule would train the head on
        # frozen random features: train end to end instead
        print("no --pretrained-path given: training end-to-end from random "
              "init (pretrained freeze schedule disabled)", file=sys.stderr)
        cfg.model.pretrained = False
    return cfg


def probe_src_size(pack: str, split: str) -> int:
    """Source image side from the pack's JSON."""
    with open(os.path.join(pack, f"{split}.rxpack.json")) as f:
        return int(json.load(f)["h"])


def train_phase(cfg: Config, args, stats, device: torch.device, global_bs: int) -> None:
    """Split, pipelines, train state and the epoch loop (``rxtpu/cli.py:314-399``)."""
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import (
        load_metadata, read_metadata_csvs, split_by_experiment, stratified_split,
    )
    from rxtpu_torch.train.loop import run_training
    from rxtpu_torch.train.setup import build_model, create_train_state

    print("########## TRAINING ##########")
    rows, controls = read_metadata_csvs(cfg.data.path_metadata, "train")
    if cfg.train.train_split_by_experiment:
        train_rows, val_rows = split_by_experiment(rows, random_state=cfg.train.split_seed)
    else:
        print("Stratify train/val split by sirna...")
        train_rows, val_rows = stratified_split(rows, cfg.train.val_fraction,
                                                cfg.train.split_seed)
    if cfg.train.nb_examples is not None:
        # keep at least one full global batch so --debug still trains a step
        cap = max(cfg.train.nb_examples, global_bs)
        train_rows, val_rows = train_rows[:cap], val_rows[:cap]
    print(f"Size training dataset: {len(train_rows)}")
    print(f"Size validation dataset: {len(val_rows)}")

    idx_train = load_metadata(train_rows, controls, "train")
    idx_val = load_metadata(val_rows, controls, "train")
    cfg.data.src_size = probe_src_size(args.pack, "train")
    if cfg.data.crop_size > cfg.data.src_size:
        raise SystemExit(f"crop size {cfg.data.crop_size} exceeds source image size "
                         f"{cfg.data.src_size}; pass --crop-size <= {cfg.data.src_size}")
    store = PackStore(os.path.join(args.pack, "train.rxpack"))
    pipe_train = Pipeline(idx_train, store, stats, global_bs, "train", seed=cfg.train.seed,
                          prefetch_depth=cfg.data.prefetch_depth, two_site=args.two_site_train)
    pipe_val = Pipeline(idx_val, store, stats, global_bs, "val", seed=cfg.train.seed,
                        shuffle=False, drop_last=False, two_site=args.two_site_train)
    model = build_model(cfg)
    state, lr = create_train_state(cfg, model, max(1, len(pipe_train)), device)
    print(f"lr: {lr}")
    result = run_training(cfg, state, pipe_train, pipe_val, device, resume=args.resume)
    print(f"Best validation accuracy: {result.best_accuracy:.4f}")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    missing = _not_ported(args)
    if missing:
        raise SystemExit(f"{missing} is not ported to rxtpu_torch yet")

    from rxtpu_torch.config import resolve_device
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import build_plate_groups, load_metadata, read_csv, read_metadata_csvs
    from rxtpu_torch.data.stats import load_stats
    from rxtpu_torch.infer.plate_leak import constrained_predict, rescale
    from rxtpu_torch.infer.predict import Predictor, predict_dataset
    from rxtpu_torch.infer.submit import write_submission
    from rxtpu_torch.train.checkpoint import checkpoint_exists, is_port_format, load_checkpoint
    from rxtpu_torch.train.loop import last_checkpoint_path
    from rxtpu_torch.train.setup import build_model

    cfg = resolve_config(args)
    device = resolve_device(args.device)
    global_bs = global_batch_size(cfg, 1)
    print(f"Devices: 1 ({device.type}), global batch {global_bs}")

    if not os.path.exists(cfg.data.stats_path):
        raise SystemExit(
            f"stats artifact {cfg.data.stats_path} missing; computing it is not "
            "ported yet (write it with `python -m rxtpu.tools stats`)")
    stats = load_stats(cfg.data.stats_path)

    ckpt_path = cfg.checkpoint_path
    # phase-skip when a best checkpoint exists, unless --resume finds a
    # rolling one (resuming a finished run is a cheap no-op)
    last_path = last_checkpoint_path(cfg)
    resume_pending = args.resume and checkpoint_exists(last_path)
    if resume_pending and not is_port_format(last_path):
        raise SystemExit(f"--resume from an rxtpu pickle ({last_path}, optax "
                         "state) is not ported to rxtpu_torch yet")
    if not checkpoint_exists(ckpt_path) or resume_pending:
        train_phase(cfg, args, stats, device, global_bs)

    print("\n\n########## TEST ##########")
    test_rows, test_controls = read_metadata_csvs(cfg.data.path_metadata, "test")
    print(f"Size test dataset: {len(test_rows)}")

    model = build_model(cfg)
    model.load_state_dict(load_checkpoint(ckpt_path))
    model = model.to(device).eval()

    plate_groups = None
    if not args.no_plate_leak:
        try:
            plate_groups = build_plate_groups(
                read_csv(os.path.join(cfg.data.path_metadata, "train.csv")),
                nb_classes=cfg.model.nb_classes)
        except ValueError as e:
            print(f"plate-group construction failed ({e}); "
                  "falling back to unconstrained argmax")

    experiments = list(dict.fromkeys(r["experiment"] for r in test_rows))
    if args.experiment_types:
        experiment_types = [int(x) for x in args.experiment_types.split(",")]
    elif len(experiments) == len(REFERENCE_EXPERIMENT_TYPES):
        experiment_types = REFERENCE_EXPERIMENT_TYPES
    else:
        experiment_types = [0] * len(experiments)
        if plate_groups is not None:
            print(f"warning: {len(experiments)} test experiments do not match the "
                  "18 Kaggle experiments; assuming plate-group type 0 for all "
                  "(override with --experiment-types)")
    if len(experiment_types) != len(experiments):
        raise SystemExit(
            f"--experiment-types has {len(experiment_types)} entries but "
            f"the test metadata has {len(experiments)} experiments")

    idx_test_all = load_metadata(test_rows, test_controls, "test")
    store = PackStore(os.path.join(args.pack, "test.rxpack"))  # geometry from its JSON
    if args.test_crop is not None and not 0 < args.test_crop <= store.h:
        raise SystemExit(f"--test-crop {args.test_crop} must be in (0, {store.h}] "
                         "(test source image size)")
    step = Predictor(model, args.test_crop, args.tta, args.tta_average,
                     dtype=getattr(torch, cfg.model.compute_dtype))

    pred_by_id = {}
    for i, experiment in enumerate(experiments):
        pipe = Pipeline(idx_test_all.for_experiment(experiment), store, stats, global_bs)
        probs, ids = predict_dataset(step, pipe, device)
        exp_rows = [r for r in test_rows if r["experiment"] == experiment]
        if [r["id_code"] for r in exp_rows] != ids:
            raise RuntimeError(f"prediction rows of {experiment} do not follow test.csv")
        plates = np.asarray([r["plate"] for r in exp_rows])
        if plate_groups is not None:
            preds = constrained_predict(probs, plates, plate_groups, experiment_types[i],
                                        method=args.assign_method)
        else:
            preds = rescale(probs).argmax(axis=1).astype(np.float64)
        pred_by_id.update(zip(ids, preds))

    id_codes = [r["id_code"] for r in test_rows]
    path = write_submission(id_codes, np.asarray([pred_by_id[i] for i in id_codes]),
                            cfg.experiment_id, args.out_dir)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
