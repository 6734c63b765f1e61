from rxtpu_torch.infer.fold import fold_for_inference, fold_state_dict
from rxtpu_torch.infer.plate_leak import constrained_predict, rescale
from rxtpu_torch.infer.predict import Predictor, predict_dataset, tta_transforms
from rxtpu_torch.infer.quant import (
    QuantPredictor, calibrate, prepare_quantized, quantizable, quantize_variables,
)
from rxtpu_torch.infer.submit import write_submission

__all__ = [
    "Predictor", "QuantPredictor", "calibrate", "constrained_predict", "fold_for_inference",
    "fold_state_dict", "predict_dataset", "prepare_quantized", "quantizable",
    "quantize_variables", "rescale", "tta_transforms", "write_submission",
]
