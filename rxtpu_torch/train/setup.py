"""Model and train-state construction (counterpart of ``rxtpu/train/setup.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rxtpu_torch.config import Config, resolve_lr
from rxtpu_torch.models.resnet import init_weights
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train.optim import make_schedule
from rxtpu_torch.train.step import TrainState


def build_model(cfg: Config) -> TwoSitesNN:
    if cfg.model.fuse_blocks:
        raise NotImplementedError("--fuse-blocks on (the fused bottleneck, K6/K7) "
                                  "is not ported yet")
    return TwoSitesNN(
        backbone=cfg.model.backbone, nb_classes=cfg.model.nb_classes,
        size_features=cfg.model.size_features, dropout=cfg.model.dropout,
        head=cfg.model.head, control_calibration=cfg.model.control_calibration,
    )


def create_train_state(cfg: Config, model: TwoSitesNN, steps_per_epoch: int,
                       device: torch.device, n_devices: int = 1,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[TrainState, float]:
    """Initialize the weights (from ``cfg.train.seed`` unless a generator is
    given), port the pretrained backbone when ``cfg.model.pretrained_path``
    is set, move the model to ``device`` and build the optimizer. Returns
    (state, lr) with lr = 0.0005 x global batch unless given."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    init_weights(model, generator)
    if cfg.model.pretrained_path:
        from rxtpu_torch.models.pretrained import (
            _RESNET_ARCH, load_torch_state_dict, port_torch_resnet,
        )

        if cfg.model.backbone not in _RESNET_ARCH:
            raise ValueError(f"pretrained porting supports {sorted(_RESNET_ARCH)}, "
                             f"not {cfg.model.backbone!r}")
        sd = load_torch_state_dict(cfg.model.pretrained_path)
        model.load_state_dict(port_torch_resnet(sd, model.state_dict(),
                                                arch=cfg.model.backbone))
    model.to(device)
    lr = resolve_lr(cfg, n_devices)
    schedule = make_schedule(lr, cfg.train.nb_epochs, steps_per_epoch, cfg.train.scheduler)
    state = TrainState.create(model, schedule, momentum=cfg.train.momentum,
                              nesterov=cfg.train.nesterov,
                              weight_decay=cfg.train.weight_decay)
    return state, lr
