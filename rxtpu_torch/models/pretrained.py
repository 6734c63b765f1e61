"""Pretrained weights: the 6-channel stem rule and a torchvision ResNet or
DenseNet-121 ``state_dict`` ported onto the port's names (counterpart of
``rxtpu/models/pretrained.py``).

The stem takes the mean over RGB of conv1's kernel, tiled across the 6
input channels (the reference's ``models.py:24-26``). Torchvision names map
as ``conv1 -> backbone.conv_init``, ``bn1 -> backbone.bn_init``,
``layer{L}.{B}.conv{N}/bn{N} -> backbone.stage{L}_block{B+1}.Conv_{N-1}/
BatchNorm_{N-1}`` and ``downsample.0/1 -> conv_proj/norm_proj``; ``fc`` is
dropped. DenseNet-121's map as ``features.conv0/norm0 -> conv_init/bn_init``,
``features.denseblock{B}.denselayer{L}.norm1/conv1/norm2/conv2 ->
block{B}_layer{L}.BatchNorm_0/Conv_0/BatchNorm_1/Conv_1``,
``features.transition{T}.norm/conv -> transition{T}.BatchNorm_0/Conv_0`` and
``features.norm5 -> bn_final``; its ``classifier`` is dropped. Kernels stay
OIHW (rxtpu's are HWIO). ``synthetic_densenet121_state_dict`` draws rxtpu's
random torchvision-format weights for tests and fixtures.
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
_DENSENET121_BLOCKS = [6, 12, 24, 16]


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


def _setters(sd: Mapping, out: Dict[str, torch.Tensor], backbone_scope: str):
    """(put(name, value), put_bn(name, torch_prefix)) writing into ``out``."""

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

    return put, put_bn


def port_torch_resnet(sd: Mapping, model_sd: Mapping[str, torch.Tensor],
                      arch: str = "resnet50", backbone_scope: str = "backbone",
                      nb_channels: int = 6) -> Dict[str, torch.Tensor]:
    """``model_sd`` (the port's ``TwoSitesNN`` state_dict) with its backbone
    replaced by the torchvision ResNet ``sd`` (tensors or numpy arrays).
    The head keeps ``model_sd``'s values."""
    stages, convs_per_block = _RESNET_ARCH[arch]
    out = dict(model_sd)
    put, put_bn = _setters(sd, out, backbone_scope)

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


def port_torch_densenet121(sd: Mapping, model_sd: Mapping[str, torch.Tensor],
                           backbone_scope: str = "backbone", nb_channels: int = 6
                           ) -> Dict[str, torch.Tensor]:
    """``model_sd`` with its backbone replaced by the torchvision DenseNet-121
    ``sd`` (``rxtpu/models/pretrained.py:156-208``); the head keeps its values."""
    out = dict(model_sd)
    put, put_bn = _setters(sd, out, backbone_scope)
    put("conv_init.weight",
        stem_kernel_from_rgb(np.asarray(sd["features.conv0.weight"]), nb_channels))
    put_bn("bn_init", "features.norm0")
    for b, n_layers in enumerate(_DENSENET121_BLOCKS, start=1):
        for layer in range(1, n_layers + 1):
            scope, tp = f"block{b}_layer{layer}", f"features.denseblock{b}.denselayer{layer}"
            put_bn(f"{scope}.BatchNorm_0", f"{tp}.norm1")
            put(f"{scope}.Conv_0.weight", sd[f"{tp}.conv1.weight"])
            put_bn(f"{scope}.BatchNorm_1", f"{tp}.norm2")
            put(f"{scope}.Conv_1.weight", sd[f"{tp}.conv2.weight"])
        if b < len(_DENSENET121_BLOCKS):
            put_bn(f"transition{b}.BatchNorm_0", f"features.transition{b}.norm")
            put(f"transition{b}.Conv_0.weight", sd[f"features.transition{b}.conv.weight"])
    put_bn("bn_final", "features.norm5")
    return out


def synthetic_densenet121_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A random torchvision-format DenseNet-121 ``state_dict``, rxtpu's draws
    from the same seed (``rxtpu/models/pretrained.py:210``)."""
    growth, feats = 32, 64
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, o, i, k):
        sd[key] = rng.normal(0, 0.05, size=(o, i, k, k)).astype(np.float32)

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.normal(1, 0.02, size=(c,)).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.02, size=(c,)).astype(np.float32)
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.02, size=(c,)).astype(np.float32)
        sd[f"{prefix}.running_var"] = np.abs(rng.normal(1, 0.02, size=(c,))).astype(np.float32)

    conv("features.conv0.weight", feats, 3, 7)
    bn("features.norm0", feats)
    for b, n_layers in enumerate(_DENSENET121_BLOCKS, start=1):
        for layer in range(1, n_layers + 1):
            tp = f"features.denseblock{b}.denselayer{layer}"
            bn(f"{tp}.norm1", feats)
            conv(f"{tp}.conv1.weight", 4 * growth, feats, 1)
            bn(f"{tp}.norm2", 4 * growth)
            conv(f"{tp}.conv2.weight", growth, 4 * growth, 3)
            feats += growth
        if b < len(_DENSENET121_BLOCKS):
            bn(f"features.transition{b}.norm", feats)
            conv(f"features.transition{b}.conv.weight", feats // 2, feats, 1)
            feats //= 2
    bn("features.norm5", feats)
    sd["classifier.weight"] = rng.normal(0, 0.02, size=(1000, feats)).astype(np.float32)
    sd["classifier.bias"] = np.zeros(1000, dtype=np.float32)
    return sd
