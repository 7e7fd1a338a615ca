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

``opt_state_from_numpy`` carries a reference AdamW state across (its m and
v, f32 or int8 codes with their scales, have the params' tree, so the
stacked block leaves split per layer in the same way), and
``params_to_numpy`` / ``opt_state_to_numpy`` go back: the port's tensors as
numpy in the reference's stacked layout (bfloat16 as float32), for
comparing the two after an update.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import resolve_device
from repro_torch.optim.adamw import OptState


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


def opt_state_from_numpy(opt, device="cuda") -> OptState:
    """A reference ``OptState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> the port's on ``device``: the step a 0-dim int32 tensor,
    m / v (and the int8 states' scales) through ``params_from_numpy``."""
    device = resolve_device(device)

    def side(t):
        return None if t is None else params_from_numpy(t, device)
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=device)
    return OptState(step, side(opt.m), side(opt.v), side(opt.m_scale), side(opt.v_scale))


def _np(t) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_to_numpy(params: dict, cfg) -> dict:
    """The port's params (or any tree of their structure: an AdamW moment
    or scale tree) -> numpy in the reference's layout: head and tail layers
    as tuples, each pattern kind's layers stacked along a leading block
    axis (a ``shared`` kind's ``{}``), ``enc_blocks`` stacked the same way;
    bfloat16 leaves as float32."""
    P = len(cfg.pattern)

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([d[k] for d in layers]) for k in layers[0]}
        return np.stack([_np(t) for t in layers])

    out = {
        "embed": _map(_np, params["embed"]),
        "final_norm": _np(params["final_norm"]),
        "head": tuple(_map(_np, d) for d in params["head"]),
        "tail": tuple(_map(_np, d) for d in params["tail"]),
        "blocks": tuple(stack(params["blocks"][j::P]) for j in range(P)),
    }
    if "shared_block" in params:
        out["shared_block"] = _map(_np, params["shared_block"])
    if "enc_blocks" in params:
        out["enc_blocks"] = stack(params["enc_blocks"])
        out["enc_norm"] = _np(params["enc_norm"])
    return out


def opt_state_to_numpy(opt: OptState, cfg) -> OptState:
    """The port's ``OptState`` with numpy leaves in the reference's layout
    (``params_to_numpy`` for each side tree)."""
    def side(t):
        return None if t is None else params_to_numpy(t, cfg)
    return OptState(np.asarray(int(opt.step), np.int32), side(opt.m), side(opt.v),
                    side(opt.m_scale), side(opt.v_scale))
