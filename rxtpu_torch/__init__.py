"""rxtpu_torch: the PyTorch/CUDA port of rxtpu for NVIDIA Hopper (H100).

The package mirrors ``rxtpu``'s module layout so each module's counterpart
is easy to find. It imports ``torch`` and never JAX, flax, optax, pandas or
``rxtpu`` itself: what it needs from those is copied here. Its entry points
run on ``cuda`` unless the caller asks for the CPU (``device="cpu"`` /
``--device cpu``); without a card and without that request they raise.

Ported so far: the CLI's train -> test pipeline. Training covers the
train/val splits and pipelines, the shear augmentation, train-mode BN and
dropout, the masked nesterov SGD step with the per-epoch cosine LR,
validation, best and rolling checkpoints with resume; the test phase covers
the BN-folded ResNet ``TwoSitesNN`` predict, plate-leak assignment and the
submission. The Pallas kernels of that path are hand-written CUDA kernels:
the eval normalize (``rxtpu_torch/csrc/crop_norm.cu``) and the three shear
passes of the augmentation (``rxtpu_torch/csrc/shear.cu``).
"""
