"""Checkpoint IO: a tree of tensors <-> .npz with an atomic rename and an
integrity digest (port of ``repro/checkpoint/io.py``, the same format on
disk).

Layout per checkpoint directory:
    step_<N>/
      meta.json            - leaf names, digest and the caller's metadata
      shard_0.npz          - one array per leaf, under its name

A leaf's name is its tree path joined with ``/`` (``repro_torch.tree``:
the reference's naming, so a tree of dicts and lists that the reference
saved loads here under the same names); bfloat16 leaves are stored as
float32 (npz cannot hold bf16) and cast back on load.  The digest is the
sha256 over each leaf's name and the first 4096 bytes of its stored array,
in flatten order.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import tree as tr

_PREFIX = 4096
_SHARD = "shard_0.npz"   # one host: the reference's host 0


def flatten_with_names(tree) -> list[tuple[str, object]]:
    return [(tr.path_str(p), leaf) for p, leaf in tr.leaves_with_path(tree)]


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the checkpoint stores: bf16 as f32, tensors
    fetched to the host."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _prefix(arr: np.ndarray) -> bytes:
    """``arr.tobytes()[:4096]`` without copying the whole array."""
    flat = np.require(arr, requirements="C").reshape(-1)
    n = min(flat.size, -(-_PREFIX // max(flat.itemsize, 1)))
    return flat[:n].tobytes()[:_PREFIX]


def save_pytree(tree, directory: str, *, extra_meta: dict | None = None):
    """Atomic save: write into a temporary directory beside ``directory``,
    fsync the metadata, rename into place (a previous ``directory`` goes to
    ``.old`` and is removed after)."""
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp_ckpt_")
    arrays, digest = {}, hashlib.sha256()
    for name, leaf in flatten_with_names(tree):
        arr = to_numpy(leaf)
        arrays[name] = arr
        digest.update(name.encode())
        digest.update(_prefix(arr))
    np.savez(os.path.join(tmp, _SHARD), **arrays)
    meta = {"names": list(arrays), "digest": digest.hexdigest(), **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(directory):
        os.rename(directory, directory + ".old")
    os.rename(tmp, directory)
    if os.path.exists(directory + ".old"):
        shutil.rmtree(directory + ".old", ignore_errors=True)


def load_pytree(template, directory: str, *, device=None):
    """Restore into the structure of ``template`` (a tree of tensors, meta
    tensors included, or of arrays), verifying the digest.  Each leaf comes
    back as a tensor of the template leaf's dtype on ``device`` - by
    default the template leaf's own device, the CPU for a meta leaf.
    Returns (tree, meta)."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    digest, out = hashlib.sha256(), []
    with np.load(os.path.join(directory, _SHARD)) as data:
        for name, leaf in flatten_with_names(template):
            arr = data[name]
            digest.update(name.encode())
            digest.update(_prefix(arr))
            t = torch.from_numpy(np.require(arr, requirements="C"))
            if torch.is_tensor(leaf):
                dev = device or (leaf.device if leaf.device.type != "meta" else "cpu")
                t = t.to(device=dev, dtype=leaf.dtype)
            elif device is not None:
                t = t.to(device)
            out.append(t)
    if digest.hexdigest() != meta["digest"]:
        raise IOError(f"checkpoint digest mismatch in {directory}")
    return tr.unflatten_like(template, out), meta
