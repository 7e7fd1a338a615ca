"""Paper-faithful CNN track: Mini-ResNet / Mini-MobileNetV2 / Mini-Seg (port
of ``repro/models/cnn.py``).

These models exercise the full quantization machinery (core/qlinear) exactly
as the paper does: every conv/dense pre-activation is quantized per the
active QuantSpec (static | dynamic | pdq x per-tensor | per-channel), the
calibration tape records observations, and the same three-way comparison is
run in-domain and under the corruption suite (paper Tables 1-2).

A procedural "gratings" dataset stands in for ImageNet/COCO: class k is a
fixed random oriented color grating; a seg variant labels each pixel by
quadrant-dependent class.  The data functions are numpy copies of the
reference's (bit-equal); params are nested dicts of tensors in the
reference's layout (HWIO conv kernels, (d, h) dense weights), so
``bridge.cnn_params_from_numpy`` carries the reference's weights across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import qlinear
from repro_torch.core.policy import FP32, QuantSpec

from .api import resolve_device

# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------


def make_gratings(key: int, n: int, *, res: int = 24, n_classes: int = 10,
                  noise: float = 0.15):
    """Returns images (n, res, res, 3) in [0,1] and labels (n,)."""
    rng = np.random.default_rng(12345)          # class definitions are fixed
    freqs = rng.uniform(0.4, 1.6, (n_classes, 2))
    phases = rng.uniform(0, 2 * np.pi, (n_classes, 3))
    colors = rng.uniform(0.3, 1.0, (n_classes, 3))

    srng = np.random.default_rng(key)
    labels = srng.integers(0, n_classes, n)
    yy, xx = np.mgrid[0:res, 0:res] / res * 2 * np.pi
    imgs = np.empty((n, res, res, 3), np.float32)
    for i, c in enumerate(labels):
        base = np.sin(freqs[c, 0] * xx * 3 + freqs[c, 1] * yy * 3
                      + phases[c][:, None, None]).transpose(1, 2, 0)
        img = 0.5 + 0.5 * base * colors[c]
        img += srng.normal(0, noise, img.shape)
        imgs[i] = np.clip(img, 0, 1)
    return imgs, labels.astype(np.int64)


def seg_labels(labels: np.ndarray, res: int, n_classes: int) -> np.ndarray:
    """Per-pixel labels: class in one quadrant, background elsewhere."""
    n = labels.shape[0]
    out = np.zeros((n, res, res), np.int64)
    h = res // 2
    for i, c in enumerate(labels):
        q = c % 4
        r0, c0 = (0 if q < 2 else h), (0 if q % 2 == 0 else h)
        out[i, r0:r0 + h, c0:c0 + h] = 1 + (c % (n_classes - 1))
    return out


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch: str = "mini_resnet"        # 'mini_resnet' | 'mini_mobilenet' | 'mini_seg'
    width: int = 32
    n_classes: int = 10
    res: int = 24


def cnn_init(seed: int, cfg: CNNConfig, device="cuda") -> dict:
    """The reference's shapes and scales (He-normal convs, 0.05-normal fc,
    zero fc bias), drawn from a CPU ``torch.Generator`` seeded with ``seed``
    (so the CPU and the card get the same weights); the values are not the
    reference's, whose weights the tests carry across instead."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    def conv(kh, kw, cin, cout):
        return (2.0 / (kh * kw * cin)) ** 0.5 * normal(kh, kw, cin, cout)

    w = cfg.width
    if cfg.arch == "mini_resnet":
        p = {
            "stem": conv(3, 3, 3, w),
            "b1a": conv(3, 3, w, w),
            "b1b": conv(3, 3, w, w),
            "down1": conv(3, 3, w, 2 * w),
            "b2a": conv(3, 3, 2 * w, 2 * w),
            "b2b": conv(3, 3, 2 * w, 2 * w),
            "down2": conv(3, 3, 2 * w, 4 * w),
            "b3a": conv(3, 3, 4 * w, 4 * w),
            "b3b": conv(3, 3, 4 * w, 4 * w),
            "fc": 0.05 * normal(4 * w, cfg.n_classes),
            "fc_b": torch.zeros(cfg.n_classes),
        }
    elif cfg.arch == "mini_mobilenet":
        def block(cin, cout):
            return {
                "expand": conv(1, 1, cin, 4 * cin),
                "dw": conv(3, 3, 1, 4 * cin),
                "project": conv(1, 1, 4 * cin, cout),
            }
        p = {
            "stem": conv(3, 3, 3, w),
            "ir1": block(w, w),
            "ir2": block(w, 2 * w),
            "ir3": block(2 * w, 2 * w),
            "ir4": block(2 * w, 4 * w),
            "fc": 0.05 * normal(4 * w, cfg.n_classes),
            "fc_b": torch.zeros(cfg.n_classes),
        }
    elif cfg.arch == "mini_seg":
        p = {
            "stem": conv(3, 3, 3, w),
            "e1": conv(3, 3, w, 2 * w),
            "e2": conv(3, 3, 2 * w, 2 * w),
            "mid": conv(3, 3, 2 * w, 2 * w),
            "d1": conv(3, 3, 2 * w, w),
            "head": conv(1, 1, w, cfg.n_classes),
        }
    else:
        raise ValueError(cfg.arch)
    return _tree_map(lambda a: a.to(device), p)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [tree]


def _c(x, k, *, name, spec, qstate, tape, stride=(1, 1), groups=1):
    return qlinear.conv2d(x, k, None, stride=stride, padding="SAME",
                          feature_group_count=groups, name=name,
                          policy=spec.resolve(name), state=qstate, tape=tape)


def cnn_apply(params, x, *, cfg: CNNConfig, spec: QuantSpec = FP32,
              qstate: dict | None = None, tape: dict | None = None):
    """x: (N, res, res, 3) in [0,1] -> logits (N, n_classes) or seg map
    (N, res, res, n_classes), on the params' device."""
    relu = torch.relu
    x = qlinear.quantize_input(x, policy=spec.resolve("input"), state=qstate,
                               tape=tape)
    kw = dict(spec=spec, qstate=qstate, tape=tape)
    p = params

    if cfg.arch == "mini_resnet":
        h = relu(_c(x, p["stem"], name="stem", **kw))
        r = h
        h = relu(_c(h, p["b1a"], name="b1a", **kw))
        h = relu(_c(h, p["b1b"], name="b1b", **kw) + r)
        h = relu(_c(h, p["down1"], name="down1", stride=(2, 2), **kw))
        r = h
        h = relu(_c(h, p["b2a"], name="b2a", **kw))
        h = relu(_c(h, p["b2b"], name="b2b", **kw) + r)
        h = relu(_c(h, p["down2"], name="down2", stride=(2, 2), **kw))
        r = h
        h = relu(_c(h, p["b3a"], name="b3a", **kw))
        h = relu(_c(h, p["b3b"], name="b3b", **kw) + r)
        h = h.mean(dim=(1, 2))
        return qlinear.dense(h, p["fc"], p["fc_b"], name="fc",
                             policy=spec.resolve("fc"), state=qstate, tape=tape)

    if cfg.arch == "mini_mobilenet":
        h = relu(_c(x, p["stem"], name="stem", **kw))
        for bname, stride in (("ir1", 1), ("ir2", 2), ("ir3", 1), ("ir4", 2)):
            b = p[bname]
            inp = h
            e = relu(_c(h, b["expand"], name=f"{bname}/expand", **kw))
            e = relu(_c(e, b["dw"], name=f"{bname}/dw", stride=(stride, stride),
                        groups=e.shape[-1], **kw))
            h = _c(e, b["project"], name=f"{bname}/project", **kw)
            if h.shape == inp.shape:
                h = h + inp
        h = h.mean(dim=(1, 2))
        return qlinear.dense(h, p["fc"], p["fc_b"], name="fc",
                             policy=spec.resolve("fc"), state=qstate, tape=tape)

    if cfg.arch == "mini_seg":
        h = relu(_c(x, p["stem"], name="stem", **kw))
        h = relu(_c(h, p["e1"], name="e1", stride=(2, 2), **kw))
        h = relu(_c(h, p["e2"], name="e2", **kw))
        h = relu(_c(h, p["mid"], name="mid", **kw))
        # jax.image.resize's "nearest" samples at pixel centres: nearest-exact
        h = F.interpolate(h.permute(0, 3, 1, 2), size=(cfg.res, cfg.res),
                          mode="nearest-exact").permute(0, 2, 3, 1)
        h = relu(_c(h, p["d1"], name="d1", **kw))
        return _c(h, p["head"], name="head", **kw)   # (N, res, res, classes)

    raise ValueError(cfg.arch)


# ---------------------------------------------------------------------------
# Training (fp32) - small Adam loop so quantization is evaluated on a
# *trained* network, as in the paper.
# ---------------------------------------------------------------------------


def _loss(p, xb, yb, cfg: CNNConfig):
    ls = torch.log_softmax(cnn_apply(p, xb, cfg=cfg), -1)
    return -torch.gather(ls, -1, yb[..., None]).mean()


def train_cnn(cfg: CNNConfig, *, steps: int = 300, batch: int = 64,
              lr: float = 2e-3, seed: int = 0, segmentation: bool = False,
              device="cuda", params: dict | None = None) -> dict:
    """The reference's training loop: ``steps`` steps of its hand-written
    Adam (not ``torch.optim.Adam``, whose update is the same algebra in
    another float order) on fresh gratings batches (seed 1000 + t, noise
    0.45), from ``params`` (default ``cnn_init(seed, cfg, device)``).
    Forward and backward convolutions run in IEEE f32 on cuDNN's
    deterministic algorithms (``fp32_convs``): two runs give the same
    weights."""
    device = resolve_device(device)
    if params is None:
        params = cnn_init(seed, cfg, device)
    p = [a.detach().to(device, copy=True) for a in _leaves(params)]
    m = [torch.zeros_like(a) for a in p]
    v = [torch.zeros_like(a) for a in p]

    def unflatten(flat):
        it = iter(flat)
        return _tree_map(lambda _: next(it), params)

    for t in range(1, steps + 1):
        xb, yb = make_gratings(1000 + t, batch, res=cfg.res,
                               n_classes=cfg.n_classes, noise=0.45)
        if segmentation:
            yb = seg_labels(yb, cfg.res, cfg.n_classes)
        xb = torch.from_numpy(xb).to(device)
        yb = torch.from_numpy(yb).to(device)
        for a in p:
            a.requires_grad_(True)
        with qlinear.fp32_convs():
            g = torch.autograd.grad(_loss(unflatten(p), xb, yb, cfg), p)
        # the bias corrections in f32, as the reference's traced 0.9 ** t
        bc1 = 1 - torch.tensor(0.9, device=device) ** t
        bc2 = 1 - torch.tensor(0.999, device=device) ** t
        with torch.no_grad():
            m = [0.9 * a + 0.1 * b for a, b in zip(m, g)]
            v = [0.999 * a + 0.001 * b * b for a, b in zip(v, g)]
            p = [a - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + 1e-8)
                 for a, mm, vv in zip(p, m, v)]
    return unflatten(p)


def evaluate(params, cfg: CNNConfig, images, labels, *, spec=FP32,
             qstate=None, segmentation: bool = False, batch: int = 128):
    """Top-1 accuracy (or mean pixel accuracy for segmentation)."""
    device = _leaves(params)[0].device
    correct = total = 0
    with torch.no_grad():
        for i in range(0, len(images), batch):
            xb = torch.as_tensor(images[i: i + batch]).to(device)
            yb = labels[i: i + batch]
            logits = cnn_apply(params, xb, cfg=cfg, spec=spec, qstate=qstate)
            pred = logits.argmax(-1).cpu().numpy()
            correct += (pred == yb).sum()
            total += yb.size
    return correct / total
