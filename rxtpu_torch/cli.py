"""CLI of the port: ``rxtpu/cli.py``'s train -> test pipeline on the card.

Takes the same argv as ``rxtpu/cli.py`` (plus ``--device``), so one command
line works for both:

1. config resolution with rxtpu's rules (``--debug`` caps the examples,
   pretraining is off without ``--pretrained-path``; the source size comes
   from the pack's JSON, or from the header of the first record's image).
   ``--debug`` with ``--device cpu`` is rxtpu's local mode (``--debug`` on a
   CPU backend): resnet18 and crop 48 unless given, 5 epochs of batch 2, an
   unstratified split, no decoder threads, plate groups from
   ``{data}/full_metadata/train.csv`` when it exists, and a test phase on
   ``DummyClassifier``'s random logits;
2. the stats artifact: loaded, or computed from the image tree when it is
   missing (``rxtpu_torch.tools.run_stats``, written where rxtpu writes it);
3. training, unless ``models/best_model_{experiment_id}.ckpt`` exists (or
   ``--resume`` finds ``models/last_{experiment_id}.ckpt``): the stratified
   or experiment-wise split, the train and val pipelines over
   ``{pack}/train.rxpack`` (raw, or zlib/zstd with or without the row
   filter, inflated by 4 host threads) or, without ``--pack``, the image
   tree under ``--data-dir`` (``--image-ext jpeg`` or ``png``; bytes
   preloaded, decoded per batch by 4 threads: JPEGs on the run's device,
   PNGs on the host), and the epoch loop with validation, best and rolling
   checkpoints (``rxtpu_torch.train.loop``; ``--resume`` continues from the
   port's rolling checkpoint or from rxtpu's pickle or orbax directory,
   optax state included), under a ``torch.profiler`` trace into
   ``board/{id}/profile`` with ``--profile`` (``spans.jsonl`` of the port's
   host spans beside it, each epoch's span seconds in ``metrics.jsonl``);
4. the test phase on the best checkpoint (an rxtpu pickle or orbax
   directory, or the port's own format): plate groups from ``train.csv``,
   predict each test experiment through ``{pack}/test.rxpack`` or its own
   image store with the BN-folded model (DenseNet-121 and the ArcFace head
   unfolded, on their running statistics), or, with ``--quantize int8``,
   the W8A8 int8 model (ResNet or DenseNet-121 with the MLP head),
   calibrated once on the first experiment's opening ``--calib-batches``
   batches; mask by plate, assign one class per row (``--assign-method greedy_jax`` on the run's device)
   and write ``submission_{id}.csv``. ``--predict-scan-window K`` > 1 (one
   process, not local mode) predicts windows of K batches, one CUDA graph
   replay per window, with one step built once (for int8 after the
   calibration) and shared by every experiment (``rxtpu/cli.py:488-570``);
   with ``--profile``, under a trace into ``board/{id}/profile/predict``
   with its ``spans.jsonl`` (each batch's or window's ``predict.step`` and
   ``predict.readback`` beside the feed's spans).

Multi-GPU (rxtpu's ``--distributed`` and ``--model-parallel M``): one
process per GPU, launched by ``torchrun --nproc-per-node N -m
rxtpu_torch.cli --distributed [--model-parallel M] ...`` or given the
cluster by ``--coordinator-address host:port --num-processes N
--process-id i``. The process group forms first (NCCL on the card, gloo with
``--device cpu``), on ``--distributed`` or whenever torchrun's
``WORLD_SIZE`` is above 1; each rank runs on ``cuda:LOCAL_RANK``. Then
rxtpu's pod steps: rank 0's experiment id to every rank, the stats pass on
rank 0 while the others wait for it, the same checkpoint view on every rank. The global
batch is ``--batch-size`` x world and the lr 0.0005 x the global batch;
each data rank decodes its rows of every batch (``world / M`` data ranks of
``global / (world / M)`` rows), BN syncs over the data ranks and, with M >
1, the head's kernels split over M model ranks
(``rxtpu_torch.parallel``). Rank 0 writes the metrics and checkpoints
(whole weights). The test phase splits its rows over every rank, each with
the whole head (K1, or K8 under ``--quantize int8``, on every rank), gathers
the probabilities in row order, calibrates int8 on every rank's slices
(max-reduced), and rank 0 writes the submission. ``--profile`` writes one
trace and one spans file per rank, named by rank.

``--checkpoint-backend orbax`` writes the best and rolling checkpoints as
orbax directories at the same paths (rxtpu's payload, orbax's plain zarr v2
layout, no orbax needed), and ``--resume`` and the test phase read rxtpu's
orbax directories, OCDBT or plain (``rxtpu_torch.train.checkpoint``).

    python -m rxtpu_torch.cli [--data-dir data] [--pack DIR] --experiment_id ID [--device cuda]
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
DECODER_THREADS = 4  # decode and inflate threads per device, as rxtpu (4 * local devices)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rxtpu_torch CLI")
    p.add_argument("--debug", default=False, action="store_true")
    p.add_argument("--experiment_id")
    p.add_argument("--lr", type=float)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--stats", default=None, help="stats artifact (.json or .pickle)")
    p.add_argument("--image-ext", default="jpeg", choices=["jpeg", "png"])
    p.add_argument("--pack", default=None,
                   help="rxpack directory (raw or compressed); without it, the image tree")
    p.add_argument("--backbone", default=None, help="resnet18|34|50|101|152|densenet121")
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
    p.add_argument("--predict-scan-window", type=int, default=1,
                   help="K > 1: predict windows of K test batches, one CUDA graph replay "
                        "per window (one process, not --debug local; the same numbers)")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8: W8A8 int8 inference (resnet backbones and densenet121, "
                        "mlp head)")
    p.add_argument("--calib-batches", type=int, default=2,
                   help="test batches of the first experiment that calibrate --quantize int8")
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
    p.add_argument("--profile", action="store_true",
                   help="trace training with torch.profiler into board/{experiment_id}/profile "
                        "and the test phase into board/{experiment_id}/profile/predict, each "
                        "with spans.jsonl beside it (the port's host spans: pipeline.assemble, "
                        "pipeline.wait, prefetch.stage, train.input, train.step, "
                        "train.readback, train.validate, train.checkpoint; predict.step, "
                        "predict.readback), and each epoch's span seconds and counters "
                        "(perf/queue_wait_s, perf/stage_s, perf/assemble_s, perf/readback_s, "
                        "perf/staged_gib, perf/checkpoint_s, ...) on a perf line of "
                        "metrics.jsonl after its rolling checkpoint")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def resolve_config(args) -> Config:
    """rxtpu's config resolution (``rxtpu/cli.py:116-188``); rxtpu's local
    mode, ``--debug`` on a CPU backend, is ``--debug`` with ``--device cpu``."""
    cfg = Config(
        data=DataConfig(path_data=args.data_dir, image_ext=args.image_ext),
        model=ModelConfig(head=args.head, pretrained_path=args.pretrained_path),
        train=TrainConfig(),
        experiment_id=args.experiment_id,
    )
    local = args.debug and torch.device(args.device).type == "cpu"
    if args.debug:
        cfg = debug_overrides(cfg, local)
    if args.pretrained_path:
        cfg.model.pretrained = True
    if args.backbone:
        cfg.model.backbone = args.backbone
    elif local and not args.pretrained_path:
        cfg.model.backbone = "resnet18"
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
    cfg.train.checkpoint_backend = args.checkpoint_backend
    cfg.train.checkpoint_every_steps = args.checkpoint_every_steps
    if args.batch_size is not None:
        cfg.train.bs_per_device = args.batch_size
        cfg.train.nb_examples = cfg.train.bs_per_device if args.debug else None
    if args.crop_size is not None:
        cfg.data.crop_size = args.crop_size
    elif local:
        cfg.data.crop_size = 48
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


def probe_src_size(cfg: Config, index, pack: Optional[str], device: torch.device) -> int:
    """Source image side: from the pack's JSON, else from the header of the
    first record's channel-1 site-1 image (JPEG or PNG)."""
    if pack:
        with open(os.path.join(pack, f"{index.split}.rxpack.json")) as f:
            return int(json.load(f)["h"])
    from rxtpu_torch.data.decode import image_size
    from rxtpu_torch.data.records import image_path

    r = index.records[0]
    return image_size(image_path(cfg.data.path_data, index.split, r.experiment, r.plate,
                                 r.well, 1, 1, cfg.data.image_ext), device)[0]


def load_or_compute_stats(cfg: Config, device: torch.device):
    """The stats artifact; when it is missing, computed from the image tree
    (``--image-ext``) into ``--stats`` (a ``.json`` path) or
    ``stats_experiments.json``. In a process group rank 0 decides whether it
    is missing and computes it alone; the others wait for it (as long as the
    pass takes, up to ``RANK0_WAIT_S``), then read the file (N ranks would
    repeat the pass and race to write one file)."""
    from rxtpu_torch.data.stats import load_stats
    from rxtpu_torch.parallel.multihost import broadcast_one_to_all, is_distributed, run_on_rank0

    missing = not os.path.exists(cfg.data.stats_path)
    rank = torch.distributed.get_rank() if is_distributed() else 0
    if is_distributed():
        missing = broadcast_one_to_all(bytes([missing])) == b"\x01"
    if not missing:
        return load_stats(cfg.data.stats_path)
    from rxtpu_torch.tools import run_stats

    out = cfg.data.stats_path if cfg.data.stats_path.endswith(".json") \
        else "stats_experiments.json"

    def compute():
        print(f"stats artifact {cfg.data.stats_path} missing; computing...")
        return run_stats(cfg.data.path_data, out, ext=cfg.data.image_ext, device=device)

    stats = run_on_rank0(compute)
    return stats if rank == 0 else load_stats(out)


def _store(cfg: Config, index, pack: Optional[str]):
    """The split's ``PackStore`` with ``--pack``, else its image ``ByteStore``."""
    if pack:
        from rxtpu_torch.data.pack import PackStore

        return PackStore(os.path.join(pack, f"{index.split}.rxpack"))
    from rxtpu_torch.data.pipeline import ByteStore

    return ByteStore(index, cfg.data.path_data, cfg.data.image_ext,
                     preload=cfg.data.cache_bytes_in_ram)


def decoder_threads(cfg: Config) -> int:
    """Decode and inflate threads: none in local mode (``rxtpu/cli.py:294``)."""
    return 0 if cfg.local else DECODER_THREADS


def train_phase(cfg: Config, args, stats, device: torch.device, global_bs: int,
                mesh=None) -> None:
    """Split, pipelines, train state and the epoch loop (``rxtpu/cli.py:314-399``),
    under a profiler trace with ``--profile``; on a ``mesh``, the data rank's
    slices, BN synced and the head split as the mesh says."""
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import (
        load_metadata, read_metadata_csvs, split_by_experiment, stratified_split,
    )
    from rxtpu_torch.train.loop import run_training
    from rxtpu_torch.train.setup import build_model, create_train_state
    from rxtpu_torch.utils.profiling import trace

    print("########## TRAINING ##########")
    rows, controls = read_metadata_csvs(cfg.data.path_metadata, "train")
    if cfg.train.train_split_by_experiment:
        train_rows, val_rows = split_by_experiment(rows, random_state=cfg.train.split_seed)
    elif cfg.local:
        train_rows, val_rows = stratified_split(rows, cfg.train.val_fraction,
                                                cfg.train.split_seed, stratify_by_sirna=False)
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
    cfg.data.src_size = probe_src_size(cfg, idx_train, args.pack, device)
    if cfg.data.crop_size > cfg.data.src_size:
        raise SystemExit(f"crop size {cfg.data.crop_size} exceeds source image size "
                         f"{cfg.data.src_size}; pass --crop-size <= {cfg.data.src_size}")
    store = _store(cfg, idx_train, args.pack)
    store_val = store if args.pack else _store(cfg, idx_val, None)
    source = dict(src_size=cfg.data.src_size, decoder_threads=decoder_threads(cfg),
                  device=device)
    if mesh is not None:
        source.update(num_hosts=mesh.data_size, host_id=mesh.data_rank)
    pipe_train = Pipeline(idx_train, store, stats, global_bs, "train", seed=cfg.train.seed,
                          prefetch_depth=cfg.data.prefetch_depth, two_site=args.two_site_train,
                          **source)
    pipe_val = Pipeline(idx_val, store_val, stats, global_bs, "val", seed=cfg.train.seed,
                        shuffle=False, drop_last=False, two_site=args.two_site_train, **source)
    model = build_model(cfg, mesh)
    state, lr = create_train_state(cfg, model, max(1, len(pipe_train)), device,
                                   n_devices=1 if mesh is None else mesh.world)
    print(f"lr: {lr}")
    with trace(os.path.join(cfg.train.board_dir, cfg.experiment_id, "profile"),
               enabled=args.profile,
               worker_name=None if mesh is None or mesh.world == 1 else f"rank{mesh.rank}"):
        result = run_training(cfg, state, pipe_train, pipe_val, device, resume=args.resume,
                              mesh=mesh)
    print(f"Best validation accuracy: {result.best_accuracy:.4f}")


def quantized_step(model, pipe, args, dtype: torch.dtype, device: torch.device, group=None):
    """The int8 predict step (``rxtpu/cli.py:517-532``): one calibration over
    the opening ``--calib-batches`` batches of ``pipe`` (the first
    experiment's; with a process ``group``, every rank's slices of them,
    max-reduced), one fold and quantize, reused for every experiment; the
    TTA transforms of ``--tta`` (``none`` is ``[identity]``, so K1 writes
    bf16 views and the stem conv quantizes them, as in rxtpu's CLI)."""
    import itertools

    from rxtpu_torch.data.pipeline import device_prefetch
    from rxtpu_torch.infer.predict import tta_transforms
    from rxtpu_torch.infer.quant import QuantPredictor, calibrate, prepare_quantized

    host = ({k: b[k] for k in ("images", "mean", "std")}
            for b in itertools.islice(pipe.epoch(0), args.calib_batches))
    qstats = calibrate(model, device_prefetch(host, device), args.test_crop, dtype, group)
    return QuantPredictor(prepare_quantized(model, qstats, dtype), args.test_crop,
                          tta_transforms(args.tta), args.tta_average)


def start_ranks(args):
    """The process group and this rank's mesh, or None for one process
    (``rxtpu/cli.py:242-253``): formed on ``--distributed`` or when torchrun
    says the world is larger than 1. ``--model-parallel`` above 1 needs a
    world it divides."""
    from rxtpu_torch.parallel import initialize_distributed, is_distributed, make_mesh

    if args.distributed or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed(args.coordinator_address, args.num_processes,
                               args.process_id, device=args.device)
    if not is_distributed():
        if args.model_parallel != 1:
            raise SystemExit(f"--model-parallel {args.model_parallel} does not divide one "
                             "process: launch one process per GPU (torchrun, or "
                             "--distributed with the cluster flags)")
        return None
    try:
        mesh = make_mesh(args.model_parallel)
    except ValueError as e:
        raise SystemExit(f"--model-parallel: {e}")
    print(f"process group: {torch.distributed.get_backend()}, world {mesh.world}, rank "
          f"{mesh.rank}, data {mesh.data_size} x model {mesh.model_parallel}")
    return mesh


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    mesh = start_ranks(args)
    try:
        return run(args, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def run(args, mesh) -> int:
    """The train and test phases of one rank (``mesh`` None: one process)."""
    from rxtpu_torch.config import resolve_device
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import build_plate_groups, load_metadata, read_csv, read_metadata_csvs
    from rxtpu_torch.infer.plate_leak import constrained_predict, rescale
    from rxtpu_torch.infer.predict import Predictor, predict_dataset
    from rxtpu_torch.infer.submit import write_submission
    from rxtpu_torch.models.twosites import DummyClassifier
    from rxtpu_torch.parallel.multihost import barrier, broadcast_one_to_all
    from rxtpu_torch.train.checkpoint import (
        assert_consistent_checkpoint_view, checkpoint_exists, load_checkpoint,
    )
    from rxtpu_torch.train.loop import last_checkpoint_path
    from rxtpu_torch.train.setup import build_model
    from rxtpu_torch.train.step import make_scanned_predict_step
    from rxtpu_torch.utils.profiling import trace

    cfg = resolve_config(args)
    device = resolve_device(args.device)
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    if device.type == "cuda" and mesh is not None:
        device = torch.device("cuda", torch.cuda.current_device())  # the rank's card
    if world > 1 and args.experiment_id is None:
        # the timestamp default can differ across processes: agree on rank 0's
        cfg.experiment_id = broadcast_one_to_all(cfg.experiment_id.encode()).decode()
    global_bs = global_batch_size(cfg, world)
    print(f"Devices: {world} ({device.type}), global batch {global_bs}"
          + (f", rank {rank}/{world}, model parallel {mesh.model_parallel}" if world > 1 else ""))

    stats = load_or_compute_stats(cfg, device)

    ckpt_path = cfg.checkpoint_path
    # phase-skip when a best checkpoint exists, unless --resume finds a
    # rolling one (resuming a finished run is a cheap no-op)
    last_path = last_checkpoint_path(cfg)
    if world > 1:  # the gates below branch on file existence: ranks must agree
        assert_consistent_checkpoint_view(ckpt_path, last_path)
    resume_pending = args.resume and checkpoint_exists(last_path)
    if not checkpoint_exists(ckpt_path) or resume_pending:
        train_phase(cfg, args, stats, device, global_bs, mesh)

    print("\n\n########## TEST ##########")
    test_rows, test_controls = read_metadata_csvs(cfg.data.path_metadata, "test")
    print(f"Size test dataset: {len(test_rows)}")

    model = build_model(cfg)
    use_int8 = args.quantize == "int8"
    if use_int8:  # before the checkpoint loads: the model's arch decides
        from rxtpu_torch.infer.quant import quantizable

        if cfg.local:
            raise SystemExit("--quantize int8 needs a trained model (unavailable with "
                             "--debug local's DummyClassifier)")
        if not quantizable(model):
            raise SystemExit("--quantize int8 supports resnet backbones with the mlp head "
                             f"and densenet121, got {cfg.model.backbone}/{cfg.model.head}")
        if args.calib_batches < 1:
            raise SystemExit("--calib-batches must be >= 1")
    if not cfg.local:  # local mode predicts with DummyClassifier, no checkpoint
        model.load_state_dict(load_checkpoint(ckpt_path))
        model = model.to(device).eval()

    plate_groups = None
    if not args.no_plate_leak:
        full_meta = os.path.join(cfg.data.path_data, "full_metadata", "train.csv")
        src = full_meta if cfg.local and os.path.exists(full_meta) \
            else os.path.join(cfg.data.path_metadata, "train.csv")
        try:
            plate_groups = build_plate_groups(read_csv(src), nb_classes=cfg.model.nb_classes)
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
    src_size = probe_src_size(cfg, idx_test_all, args.pack, device)
    if args.test_crop is not None and not 0 < args.test_crop <= src_size:
        raise SystemExit(f"--test-crop {args.test_crop} must be in (0, {src_size}] "
                         "(test source image size)")
    # one lazy mmap of the test pack for every experiment; without a pack,
    # one byte store per experiment, so the test bytes held stay one
    # experiment wide
    pack_store = _store(cfg, idx_test_all, args.pack) if args.pack else None
    dtype = getattr(torch, cfg.model.compute_dtype)
    # the test rows split over every rank, each with the whole (folded) head
    group = torch.distributed.group.WORLD if world > 1 else None
    if cfg.local:  # fed the raw views (rxtpu/cli.py:564-566)
        step = DummyClassifier(nb_classes=cfg.model.nb_classes)
    elif use_int8:
        step = None  # built on the first experiment's calibration batches
    else:
        step = Predictor(model, args.test_crop, args.tta, args.tta_average, dtype=dtype)

    # one windowed step for every experiment: one graph capture per run
    scan_window = max(1, args.predict_scan_window)
    use_scan = scan_window > 1 and not cfg.local and world == 1
    scan_step = None

    pred_by_id = {}
    with trace(os.path.join(cfg.train.board_dir, cfg.experiment_id, "profile", "predict"),
               enabled=args.profile, worker_name=None if world == 1 else f"rank{rank}"):
        for i, experiment in enumerate(experiments):
            idx_exp = idx_test_all.for_experiment(experiment)
            pipe = Pipeline(idx_exp, pack_store or _store(cfg, idx_exp, None), stats, global_bs,
                            src_size=src_size, decoder_threads=decoder_threads(cfg),
                            device=device, num_hosts=world, host_id=rank)
            if step is None:
                step = quantized_step(model, pipe, args, dtype, device, group)
            if use_scan and scan_step is None:
                scan_step = make_scanned_predict_step(step, scan_window)
            probs, ids = predict_dataset(step, pipe, device, group, scan_step=scan_step)
            exp_rows = [r for r in test_rows if r["experiment"] == experiment]
            if [r["id_code"] for r in exp_rows] != ids:
                raise RuntimeError(f"prediction rows of {experiment} do not follow test.csv")
            plates = np.asarray([r["plate"] for r in exp_rows])
            if plate_groups is not None:
                preds = constrained_predict(probs, plates, plate_groups, experiment_types[i],
                                            method=args.assign_method, device=device)
            else:
                preds = rescale(probs).argmax(axis=1).astype(np.float64)
            pred_by_id.update(zip(ids, preds))

    id_codes = [r["id_code"] for r in test_rows]
    if rank == 0:  # the predictions are on every rank; one writes the file
        path = write_submission(id_codes, np.asarray([pred_by_id[i] for i in id_codes]),
                                cfg.experiment_id, args.out_dir)
        print(f"wrote {path}")
    barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
