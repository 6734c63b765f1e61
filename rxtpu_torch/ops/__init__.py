from rxtpu_torch.ops.crop_norm import (
    crop_normalize, crop_normalize_reference, eval_batch_normalize,
)

__all__ = ["crop_normalize", "crop_normalize_reference", "eval_batch_normalize"]
