from rxtpu_torch.ops.crop_norm import (
    crop_normalize, crop_normalize_reference, eval_batch_normalize,
)
from rxtpu_torch.ops.shear import (
    apply_affine_shear, augment_batch_shear, decompose_angle, dihedral, dihedral_bits,
    rotate_crop_normalize, rotate_crop_normalize_fused, shear_pass, shear_pass_finish,
    shear_pass_rows,
)
from rxtpu_torch.ops.warp import (
    apply_affine_warp, augment_batch, center_crop_normalize_reference, reflect101,
    sample_affine_params,
)


def augment_passthrough(images, mean, std, generator=None, crop_size=364, train=True,
                        **_kw):
    """'none' backend: ``images`` already hold normalized NCHW views (the
    lockstep parity runs feed the same views to rxtpu and the port)."""
    return images


def get_augment_fn(backend: str = "shear"):
    """Train-time augmentation backend (``rxtpu/ops/__init__.py:28``).

    'shear'  — the three-pass shear on kernels K2-K4 (the default);
    'gather' — the exact one-pass bilinear warp, plain torch;
    'none'   — passthrough of views that are already augmented.
    Each takes ``(images, mean, std, generator, crop_size=, train=,
    out_dtype=)`` and returns NCHW views ``[B, G, C, crop, crop]``.
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
    "augment_passthrough", "center_crop_normalize_reference", "crop_normalize",
    "crop_normalize_reference", "decompose_angle", "dihedral", "dihedral_bits",
    "eval_batch_normalize", "get_augment_fn", "reflect101", "rotate_crop_normalize",
    "rotate_crop_normalize_fused", "sample_affine_params", "shear_pass",
    "shear_pass_finish", "shear_pass_rows",
]
