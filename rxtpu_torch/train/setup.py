"""Model and train-state construction (counterpart of ``rxtpu/train/setup.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rxtpu_torch.config import Config, resolve_lr
from rxtpu_torch.models.resnet import init_weights
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train.optim import make_schedule
from rxtpu_torch.train.step import TrainState


def build_model(cfg: Config, mesh=None) -> TwoSitesNN:
    """The configured ``TwoSitesNN``; with ``mesh`` (``rxtpu_torch.parallel``)
    its BNs sync over the data ranks and its head splits over the model ranks."""
    return TwoSitesNN(
        backbone=cfg.model.backbone, nb_classes=cfg.model.nb_classes,
        size_features=cfg.model.size_features, dropout=cfg.model.dropout,
        head=cfg.model.head, control_calibration=cfg.model.control_calibration,
        arcface_margin=cfg.model.arcface_margin, arcface_scale=cfg.model.arcface_scale,
        fuse_blocks=bool(cfg.model.fuse_blocks),  # None (auto) is off, as in rxtpu
        mesh=mesh,
    )


def create_train_state(cfg: Config, model: TwoSitesNN, steps_per_epoch: int,
                       device: torch.device, n_devices: int = 1,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[TrainState, float]:
    """Initialize the weights (from ``cfg.train.seed`` unless a generator is
    given), port the pretrained backbone when ``cfg.model.pretrained_path``
    is set, move the model to ``device`` and build the optimizer. Returns
    (state, lr) with lr = 0.0005 x global batch unless given; the global
    batch is ``bs_per_device`` x ``n_devices`` (the world size on a mesh,
    rxtpu's device count). Every rank builds the whole model: a mesh's
    tensor-parallel shards are cut later (``rxtpu_torch.parallel.place_state``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    init_weights(model, generator)
    if cfg.model.pretrained_path:
        from rxtpu_torch.models.pretrained import (
            _RESNET_ARCH, load_torch_state_dict, port_torch_densenet121, port_torch_resnet,
        )

        sd = load_torch_state_dict(cfg.model.pretrained_path)
        if cfg.model.backbone in _RESNET_ARCH:
            ported = port_torch_resnet(sd, model.state_dict(), arch=cfg.model.backbone)
        elif cfg.model.backbone == "densenet121":
            ported = port_torch_densenet121(sd, model.state_dict())
        else:
            raise ValueError(f"pretrained porting supports "
                             f"{sorted(_RESNET_ARCH) + ['densenet121']}, "
                             f"not {cfg.model.backbone!r}")
        model.load_state_dict(ported)
    model.to(device)
    lr = resolve_lr(cfg, n_devices)
    schedule = make_schedule(lr, cfg.train.nb_epochs, steps_per_epoch, cfg.train.scheduler)
    state = TrainState.create(model, schedule, momentum=cfg.train.momentum,
                              nesterov=cfg.train.nesterov,
                              weight_decay=cfg.train.weight_decay)
    return state, lr
