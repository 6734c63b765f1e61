from rxtpu_torch.ops import fused_block as _fused_block
from rxtpu_torch.ops import int8_conv as _int8_conv
from rxtpu_torch.ops.batchnorm import FusedBatchNorm, batch_stats_one_pass, bn_train_apply
from rxtpu_torch.ops.crop_norm import (
    crop_normalize, crop_normalize_reference, eval_batch_normalize,
)
from rxtpu_torch.ops.fused_block import (
    BottleneckFused, bottleneck_fused, conv1x1_to_mat, conv3x3_to_taps, mat_to_conv1x1,
    taps_to_conv3x3,
)
from rxtpu_torch.ops.fused_stem import (
    eval_batch_stem, fused_stem, fused_stem_reference, stem_out_size,
)
from rxtpu_torch.ops.maxpool import max_pool_3x3s2
from rxtpu_torch.ops.shear import (
    apply_affine_shear, augment_batch_shear, decompose_angle, dihedral, dihedral_bits,
    rotate_crop_normalize, rotate_crop_normalize_fused, shear_pass, shear_pass_finish,
    shear_pass_rows,
)
from rxtpu_torch.ops.warp import (
    apply_affine_warp, augment_batch, center_crop_normalize_reference, reflect101,
    sample_affine_params, sample_view_params,
)


def augment_passthrough(images, mean, std, generator=None, crop_size=364, train=True,
                        **_kw):
    """'none' backend: ``images`` already hold normalized NCHW views (the
    lockstep parity runs feed the same views to rxtpu and the port)."""
    return images


def launch_counters():
    """Every kernel wrapper's launch counter (an object whose ``launches`` the
    wrapper raises by one per launch): K1, K2-K4, K5, K6/K7's bodies and K8."""
    return [crop_normalize, shear_pass, shear_pass_rows, shear_pass_finish, fused_stem,
            *_fused_block.BODIES, _int8_conv._counter]


def get_augment_fn(backend: str = "shear"):
    """Train-time augmentation backend (``rxtpu/ops/__init__.py:28``).

    'shear'  — the three-pass shear on kernels K2-K4 (the default);
    'gather' — the exact one-pass bilinear warp, plain torch;
    'none'   — passthrough of views that are already augmented.
    Each takes ``(images, mean, std, generator, crop_size=, train=,
    out_dtype=, rows=)`` and returns NCHW views ``[B, G, C, crop, crop]``;
    ``rows = (first, total)`` draws a data rank's rows of the global batch's
    parameters (``sample_view_params``).
    """
    if backend == "shear":
        return augment_batch_shear
    if backend == "gather":
        return augment_batch
    if backend == "none":
        return augment_passthrough
    raise ValueError(f"unknown augment backend {backend!r}")


__all__ = [
    "apply_affine_shear", "apply_affine_warp", "augment_batch", "augment_batch_shear",
    "augment_passthrough", "batch_stats_one_pass", "bn_train_apply", "bottleneck_fused",
    "BottleneckFused", "center_crop_normalize_reference", "conv1x1_to_mat", "conv3x3_to_taps",
    "crop_normalize", "crop_normalize_reference", "decompose_angle", "dihedral",
    "dihedral_bits", "eval_batch_normalize", "eval_batch_stem", "fused_stem",
    "fused_stem_reference", "FusedBatchNorm", "get_augment_fn", "launch_counters",
    "mat_to_conv1x1", "max_pool_3x3s2", "reflect101", "rotate_crop_normalize",
    "rotate_crop_normalize_fused", "sample_affine_params", "sample_view_params", "shear_pass",
    "shear_pass_finish", "shear_pass_rows", "stem_out_size", "taps_to_conv3x3",
]
