"""Configuration layer (counterpart of ``rxtpu/config.py``).

The same dataclasses and derived rules as rxtpu: batch size scales with the
device count, lr = 0.0005 x global batch unless given, ``--debug`` caps the
examples to one batch, checkpoints live at
``models/best_model_{experiment_id}.ckpt``.
The port adds ``resolve_device``: entry points run on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch

NB_CLASSES = 1108
NB_CHANNELS = 6
SRC_SIZE = 512
CROP_SIZE = 364


@dataclasses.dataclass
class DataConfig:
    path_data: str = "data"
    path_metadata: Optional[str] = None      # defaults to {path_data}/metadata
    stats_path: str = "stats_experiments.json"
    channels: Sequence[int] = (1, 2, 3, 4, 5, 6)
    src_size: int = SRC_SIZE
    crop_size: int = CROP_SIZE
    image_ext: str = "jpeg"
    cache_bytes_in_ram: bool = True
    decoder_threads: int = 0
    prefetch_depth: int = 2
    use_native_decoder: bool = True

    def __post_init__(self):
        if self.path_metadata is None:
            self.path_metadata = os.path.join(self.path_data, "metadata")


@dataclasses.dataclass
class ModelConfig:
    backbone: str = "resnet50"
    nb_classes: int = NB_CLASSES
    size_features: int = 1024
    dropout: float = 0.3
    pretrained: bool = True
    pretrained_path: Optional[str] = None
    head: str = "mlp"
    arcface_margin: float = 0.3
    arcface_scale: float = 30.0
    control_calibration: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    fuse_blocks: Optional[bool] = None


@dataclasses.dataclass
class TrainConfig:
    nb_epochs: int = 100
    bs_per_device: int = 16
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 3e-5
    lr: Optional[float] = None
    scheduler: bool = True
    early_stopping: bool = False
    patience: int = 10
    train_split_by_experiment: bool = False
    val_fraction: float = 0.1
    split_seed: int = 42
    seed: int = 0
    nb_examples: Optional[int] = None
    freeze_head_only_epochs: int = 2
    augment_backend: str = "shear"
    log_every_steps: int = 50
    checkpoint_backend: str = "pickle"
    checkpoint_every_steps: Optional[int] = None
    checkpoint_dir: str = "models"
    board_dir: str = "board"


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    experiment_id: Optional[str] = None
    debug: bool = False
    local: bool = False

    def __post_init__(self):
        if self.experiment_id is None:
            eid = str(datetime.datetime.now().time())
            self.experiment_id = eid.replace(":", "-").split(".")[0]

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(
            self.train.checkpoint_dir, f"best_model_{self.experiment_id}.ckpt"
        )


def debug_overrides(cfg: Config, local: bool) -> Config:
    """``--debug``: cap the examples to one batch; local (``--debug`` with
    ``--device cpu``) also turns pretraining off and runs 5 epochs of
    batch 2 (``rxtpu/config.py:118-127``)."""
    cfg.local = local
    cfg.debug = True
    if local:
        cfg.model.pretrained = False
        cfg.train.nb_epochs = 5
        cfg.train.bs_per_device = 2
    cfg.train.nb_examples = cfg.train.bs_per_device
    return cfg


def global_batch_size(cfg: Config, n_devices: int) -> int:
    return cfg.train.bs_per_device * n_devices


def resolve_lr(cfg: Config, n_devices: int) -> float:
    """lr = 0.0005 x global batch unless given."""
    if cfg.train.lr is not None:
        return cfg.train.lr
    return 0.0005 * global_batch_size(cfg, n_devices)


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the CPU is asked for.

    Raises when a CUDA device is asked for and none is present: the port
    never drops to the CPU on its own.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device
