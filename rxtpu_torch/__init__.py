"""rxtpu_torch: the PyTorch/CUDA port of rxtpu for NVIDIA Hopper (H100).

The package mirrors ``rxtpu``'s module layout so each module's counterpart
is easy to find. It imports ``torch`` and never JAX, flax, optax, pandas or
``rxtpu`` itself: what it needs from those is copied here. Its entry points
run on ``cuda`` unless the caller asks for the CPU (``device="cpu"`` /
``--device cpu``); without a card and without that request they raise.

Ported so far: the test phase of the CLI (ResNet ``TwoSitesNN`` predict with
BN folding, plate-leak assignment, submission), with the eval normalize
(``rxtpu.ops.pallas_norm``) as a hand-written CUDA kernel
(``rxtpu_torch/csrc/crop_norm.cu``).
"""
