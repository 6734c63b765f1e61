"""Pretrained weights: the 6-channel stem rule and a torchvision ResNet
``state_dict`` ported onto the port's names (counterpart of
``rxtpu/models/pretrained.py``).

The stem takes the mean over RGB of conv1's kernel, tiled across the 6
input channels (the reference's ``models.py:24-26``). Torchvision names map
as ``conv1 -> backbone.conv_init``, ``bn1 -> backbone.bn_init``,
``layer{L}.{B}.conv{N}/bn{N} -> backbone.stage{L}_block{B+1}.Conv_{N-1}/
BatchNorm_{N-1}`` and ``downsample.0/1 -> conv_proj/norm_proj``; ``fc`` is
dropped. Kernels stay OIHW (rxtpu's are HWIO).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RESNET_ARCH = {
    "resnet18": ([2, 2, 2, 2], 2),
    "resnet34": ([3, 4, 6, 3], 2),
    "resnet50": ([3, 4, 6, 3], 3),
    "resnet101": ([3, 4, 23, 3], 3),
    "resnet152": ([3, 8, 36, 3], 3),
}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def stem_kernel_from_rgb(kernel_rgb_oihw: np.ndarray, nb_channels: int = 6) -> np.ndarray:
    """[64, 3, 7, 7] conv1 kernel -> [64, nb_channels, 7, 7], each input
    channel the mean over RGB."""
    mean = np.asarray(kernel_rgb_oihw).mean(axis=1, keepdims=True)
    return np.broadcast_to(mean, (mean.shape[0], nb_channels) + mean.shape[2:]).copy()


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` file (tensors only, loaded without code)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def port_torch_resnet(sd: Mapping, model_sd: Mapping[str, torch.Tensor],
                      arch: str = "resnet50", backbone_scope: str = "backbone",
                      nb_channels: int = 6) -> Dict[str, torch.Tensor]:
    """``model_sd`` (the port's ``TwoSitesNN`` state_dict) with its backbone
    replaced by the torchvision ResNet ``sd`` (tensors or numpy arrays).
    The head keeps ``model_sd``'s values."""
    stages, convs_per_block = _RESNET_ARCH[arch]
    out = dict(model_sd)

    def put(name: str, value) -> None:
        key = f"{backbone_scope}.{name}"
        dst = out[key]
        value = torch.as_tensor(np.asarray(value)).to(dst.dtype)
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: torch weight {tuple(value.shape)} vs {tuple(dst.shape)}")
        out[key] = value.clone()

    def put_bn(name: str, torch_prefix: str) -> None:
        for leaf in _BN_LEAVES:
            put(f"{name}.{leaf}", sd[f"{torch_prefix}.{leaf}"])

    put("conv_init.weight", stem_kernel_from_rgb(np.asarray(sd["conv1.weight"]), nb_channels))
    put_bn("bn_init", "bn1")
    for li, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            scope = f"stage{li + 1}_block{bi + 1}"
            tp = f"layer{li + 1}.{bi}"
            for ci in range(convs_per_block):
                put(f"{scope}.Conv_{ci}.weight", sd[f"{tp}.conv{ci + 1}.weight"])
                put_bn(f"{scope}.BatchNorm_{ci}", f"{tp}.bn{ci + 1}")
            if f"{tp}.downsample.0.weight" in sd:
                put(f"{scope}.conv_proj.weight", sd[f"{tp}.downsample.0.weight"])
                put_bn(f"{scope}.norm_proj", f"{tp}.downsample.1")
    return out
