"""Per-layer quantization policy resolution: a copy of the reference's
``repro/core/policy.py`` (pure Python)."""
from __future__ import annotations

import dataclasses
import re
from typing import Literal

Mode = Literal["none", "static", "dynamic", "pdq", "observe"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """How a layer's output (pre-activation) is quantized.

    mode:          'static' | 'dynamic' | 'pdq' | 'none' (fp passthrough)
    bits:          quantization bit-width (paper uses 8 throughout)
    per_channel:   per-channel vs per-tensor output/weight quantization
    gamma:         sampling stride for the PDQ moment estimate (Sec. 4.2)
    coverage:      target coverage for I(alpha, beta) calibration (Eq. 13)
    integer_path:  route through int8 kernels (serving) vs fake-quant emulation;
                   declared and read nowhere, as in the reference: ``qlinear``
                   has only the emulation
    """

    mode: Mode = "pdq"
    bits: int = 8
    per_channel: bool = True
    gamma: int = 1
    coverage: float = 0.9995
    integer_path: bool = False


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Model-level quantization spec: a default policy + per-layer overrides.

    ``overrides`` maps regex patterns on layer names to policies; first match
    wins.  Layers matching ``skip`` regexes stay in full precision (the usual
    practice for e.g. routers / first & last layers).
    """

    default: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)
    overrides: tuple[tuple[str, QuantPolicy], ...] = ()
    skip: tuple[str, ...] = ()

    def resolve(self, layer_name: str) -> QuantPolicy:
        for pat in self.skip:
            if re.search(pat, layer_name):
                return dataclasses.replace(self.default, mode="none")
        for pat, pol in self.overrides:
            if re.search(pat, layer_name):
                return pol
        return self.default


FP32 = QuantSpec(default=QuantPolicy(mode="none"))


def as_observe(spec: QuantSpec) -> QuantSpec:
    """Calibration variant of a spec: same layers, but capture instead of quantize."""
    def obs(p: QuantPolicy) -> QuantPolicy:
        return p if p.mode == "none" else dataclasses.replace(p, mode="observe")

    return QuantSpec(
        default=obs(spec.default),
        overrides=tuple((pat, obs(p)) for pat, p in spec.overrides),
        skip=spec.skip,
    )


def spec_for_mode(mode: Mode, per_channel: bool = True, gamma: int = 1,
                  bits: int = 8, integer_path: bool = False,
                  skip: tuple[str, ...] = ()) -> QuantSpec:
    return QuantSpec(
        default=QuantPolicy(mode=mode, per_channel=per_channel, gamma=gamma,
                            bits=bits, integer_path=integer_path),
        skip=skip,
    )
