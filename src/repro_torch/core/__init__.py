"""repro_torch.core - the paper's contribution, probabilistic dynamic
quantization, on tensors (port of ``repro/core``).

Public surface:
    affine      - uniform affine quantization (Eqs. 1-4)
    surrogate   - pre-activation moment surrogates (Eqs. 8-12)
    interval    - I(alpha, beta) + coverage calibration (Eq. 13)
    policy      - per-layer quantization policies / specs
    qlinear     - quantized dense/conv execution (static | dynamic | pdq)
    calibrate   - shared calibration loop
"""
from . import affine, calibrate, interval, policy, qlinear, surrogate
from .affine import QParams, dequantize, dynamic_qparams, fake_quant, qparams_from_range, quantize
from .calibrate import calibrate as run_calibration
from .interval import IntervalParams, calibrate_alpha_beta, coverage, qparams_from_interval
from .policy import FP32, QuantPolicy, QuantSpec, spec_for_mode
from .surrogate import Moments, WeightStats, conv_moments, empirical_moments, linear_moments, weight_stats

__all__ = [
    "affine", "calibrate", "interval", "policy", "qlinear", "surrogate",
    "QParams", "quantize", "dequantize", "fake_quant", "qparams_from_range", "dynamic_qparams",
    "IntervalParams", "coverage", "calibrate_alpha_beta", "qparams_from_interval",
    "QuantPolicy", "QuantSpec", "FP32", "spec_for_mode",
    "Moments", "WeightStats", "weight_stats", "linear_moments", "conv_moments",
    "empirical_moments", "run_calibration",
]
