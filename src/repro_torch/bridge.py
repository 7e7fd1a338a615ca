"""Weights from the JAX reference into the port.

``params_from_numpy`` takes a reference param tree whose leaves the caller
has already turned into numpy arrays (``jax.tree.map(np.asarray, params)``
- the port never imports JAX) and returns the port's params: the stacked
``blocks`` leaves are split into one dict per layer.  Quantized records are
not carried across: the port builds its own from the same fp weights with
``models.linops.quantize_param_tree``, and the tests compare the two.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """Reference params (numpy leaves) -> the port's params on ``device``:
    the card unless the caller asks for the CPU, and an error where CUDA is
    absent (``models.api.resolve_device``)."""
    device = resolve_device(device)
    if tree.get("head") or tree.get("tail") or len(tree["blocks"]) != 1:
        raise NotImplementedError(
            "the port runs the single-kind ('global',) pattern without "
            "head/tail layers")
    stacked = tree["blocks"][0]
    n = len(stacked["attn_norm"])
    return {
        "embed": _map(lambda a: _tensor(a, device), tree["embed"]),
        "final_norm": _tensor(tree["final_norm"], device),
        "blocks": [_map(lambda a, i=i: _tensor(a[i], device), stacked)
                   for i in range(n)],
    }
