"""CLI of the port: the test phase of ``rxtpu/cli.py`` on the card.

Takes the same argv as ``rxtpu/cli.py`` (plus ``--device``), so one command
line works for both. It loads the best checkpoint
``models/best_model_{experiment_id}.ckpt`` (an rxtpu pickle or the port's
own format), builds the plate groups from ``train.csv``, predicts each test
experiment through the ``--pack`` store with the BN-folded model, masks by
plate, assigns one class per row and writes ``submission_{id}.csv``.

Training is not ported yet: without the checkpoint this exits and says so.
Train-only flags are parsed and have no effect (the phase-skip applies).
Flags whose path is not ported yet exit with a message that names them.

    python -m rxtpu_torch.cli --pack DIR --experiment_id ID [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from rxtpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig, global_batch_size

REFERENCE_EXPERIMENT_TYPES = [3, 1, 0, 0, 0, 0, 2, 2, 3, 0, 0, 3, 1, 0, 0, 0, 2, 3]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rxtpu_torch CLI (test phase)")
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
    return None


def resolve_config(args) -> Config:
    cfg = Config(
        data=DataConfig(path_data=args.data_dir, image_ext=args.image_ext),
        model=ModelConfig(head=args.head, pretrained_path=args.pretrained_path),
        train=TrainConfig(),
        experiment_id=args.experiment_id,
    )
    if args.backbone:
        cfg.model.backbone = args.backbone
    if args.batch_size is not None:
        cfg.train.bs_per_device = args.batch_size
    if args.nb_classes is not None:
        cfg.model.nb_classes = args.nb_classes
    cfg.model.control_calibration = args.calibrate
    if args.stats is not None:
        cfg.data.stats_path = args.stats
    else:
        for cand in ("stats_experiments.json", "stats_experiments.pickle"):
            if os.path.exists(cand):
                cfg.data.stats_path = cand
                break
    return cfg


def build_model(cfg: Config):
    from rxtpu_torch.models.twosites import TwoSitesNN

    return TwoSitesNN(
        backbone=cfg.model.backbone, nb_classes=cfg.model.nb_classes,
        size_features=cfg.model.size_features, dropout=cfg.model.dropout,
        head=cfg.model.head, control_calibration=cfg.model.control_calibration,
    )


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
    from rxtpu_torch.train.checkpoint import load_checkpoint

    cfg = resolve_config(args)
    device = resolve_device(args.device)
    global_bs = global_batch_size(cfg, 1)
    print(f"Devices: 1 ({device.type}), global batch {global_bs}")

    ckpt_path = cfg.checkpoint_path
    last_path = os.path.join(cfg.train.checkpoint_dir, f"last_{cfg.experiment_id}.ckpt")
    if not os.path.exists(ckpt_path) or (args.resume and os.path.exists(last_path)):
        raise SystemExit(
            f"training is not ported to rxtpu_torch yet: the test phase needs the "
            f"best checkpoint {ckpt_path} (train it with rxtpu)"
            + (" and runs without --resume" if os.path.exists(ckpt_path) else ""))
    if not os.path.exists(cfg.data.stats_path):
        raise SystemExit(
            f"stats artifact {cfg.data.stats_path} missing; computing it is not "
            "ported yet (write it with `python -m rxtpu.tools stats`)")
    stats = load_stats(cfg.data.stats_path)

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
