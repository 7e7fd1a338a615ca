"""Weights from the JAX reference into the port.

``params_from_numpy`` takes a reference param tree whose leaves the caller
has already turned into numpy arrays (``jax.tree.map(np.asarray, params)``
- the port never imports JAX) and returns the port's params: the head and
tail layers as lists, and the stacked ``blocks`` leaves - one stacked dict
per pattern kind - split into one dict per layer, in layer order (block
i's kind j is layer i * P + j).  Quantized records are
not carried across: the port builds its own from the same fp weights with
``models.linops.quantize_param_tree``, and the tests compare the two.
``cnn_params_from_numpy`` does the same for the CNN track's params.
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
    absent (``models.api.resolve_device``).  Head and tail layers (a tuple
    of layer dicts each) and zamba2's ``shared_block`` map one to one;
    every leaf of a stacked block, the MoE layers' (E, ...) expert stacks
    and router and a mamba layer's nested ``ssm`` dict included, is split
    per block (a ``shared`` kind's stacked ``{}`` gives an empty dict a
    block).  An encoder-decoder's stacked ``enc_blocks`` are split per
    encoder layer the same way, ``enc_norm`` maps one to one, and each
    decoder layer's ``cross`` / ``cross_norm`` ride in its block dict."""
    device = resolve_device(device)

    def t(a):
        return _tensor(a, device)

    kinds = tuple(tree["blocks"])
    # the block count: any leaf's leading extent, of the first kind that
    # has leaves (a ``shared`` kind's stacked params are an empty dict)
    n = len(_first_leaf(next(k for k in kinds if k)))
    out = {
        "embed": _map(t, tree["embed"]),
        "final_norm": t(tree["final_norm"]),
        "head": [_map(t, layer) for layer in tree.get("head", ())],
        "tail": [_map(t, layer) for layer in tree.get("tail", ())],
        "blocks": [_map(lambda a, i=i: _tensor(a[i], device), stacked)
                   for i in range(n) for stacked in kinds],
    }
    if tree.get("shared_block"):
        out["shared_block"] = _map(t, tree["shared_block"])
    if "enc_blocks" in tree:
        enc = tree["enc_blocks"]
        out["enc_blocks"] = [_map(lambda a, i=i: _tensor(a[i], device), enc)
                             for i in range(len(_first_leaf(enc)))]
        out["enc_norm"] = t(tree["enc_norm"])
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def cnn_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's CNN params (``repro/models/cnn.py:82-124``
    ``cnn_init``: a dict, nested one level for the MobileNet's blocks, of
    HWIO conv kernels, the (d, h) ``fc`` and its ``fc_b``), with numpy
    leaves, -> the port's tensors in the same layout on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return _map(lambda a: _tensor(a, device), tree)
