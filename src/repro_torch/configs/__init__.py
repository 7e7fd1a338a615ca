"""Architecture registry: ``get_config('<arch-id>')``.

Every reference config is registered: the GQA decoders with or without
local (sliding-window) layers, the MoE decoders (deepseek-v2 with MLA,
arctic with a dense residual), the attention-free Mamba2 SSD decoder
(mamba2), the hybrid of SSD layers and one shared attention block (zamba2),
the vision decoder whose stub patches are prepended to the text
(phi-3-vision) and the encoder-decoder with cross-attention over stub
speech frames (seamless).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "arctic-480b": "arctic_480b",
    "gemma3-12b": "gemma3_12b",
    "stablelm-1.6b": "stablelm_1p6b",
    "yi-6b": "yi_6b",
    "gemma2-2b": "gemma2_2b",
    "mamba2-2.7b": "mamba2_2p7b",
    "zamba2-7b": "zamba2_7b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG.validate()


def reduced_config(name: str, **overrides):
    from repro_torch.models.config import reduced
    return reduced(get_config(name), **overrides)
