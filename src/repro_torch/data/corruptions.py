"""The paper's domain-shift corruption suite (Sec. 5.2), severity 1..5.

Operates on NHWC float images in [0, 1].  'combination' applies several
corruptions in one pass, as in the paper.  A numpy copy of the reference's
``repro/data/corruptions.py``: the same ``np.random.Generator`` gives the
same arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

SEVERITY = {1: 0.2, 2: 0.4, 3: 0.6, 4: 0.8, 5: 1.0}


def white_noise(x, s, rng):
    return np.clip(x + rng.normal(0, 0.08 * SEVERITY[s], x.shape), 0, 1)


def blur(x, s, rng):
    k = 1 + 2 * s  # box blur size
    pad = k // 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="edge")
    out = np.zeros_like(x)
    for i in range(k):
        for j in range(k):
            out += xp[:, i: i + x.shape[1], j: j + x.shape[2]]
    return out / (k * k)


def pixelate(x, s, rng):
    f = 1 + s
    h, w = x.shape[1], x.shape[2]
    small = x[:, ::f, ::f]
    return np.repeat(np.repeat(small, f, axis=1), f, axis=2)[:, :h, :w]


def quantize_img(x, s, rng):
    levels = max(2, 32 >> s)
    return np.round(x * (levels - 1)) / (levels - 1)


def color_shift(x, s, rng):
    shift = rng.uniform(-0.25, 0.25, size=(1, 1, 1, x.shape[-1])) * SEVERITY[s]
    return np.clip(x + shift, 0, 1)


def brightness(x, s, rng):
    return np.clip(x + 0.3 * SEVERITY[s] * rng.choice([-1.0, 1.0]), 0, 1)


def contrast(x, s, rng):
    c = 1.0 - 0.7 * SEVERITY[s]
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    return np.clip((x - mean) * c + mean, 0, 1)


CORRUPTIONS = {
    "white_noise": white_noise,
    "blur": blur,
    "pixelate": pixelate,
    "quantize": quantize_img,
    "color_shift": color_shift,
    "brightness": brightness,
    "contrast": contrast,
}


def combination(x, s, rng):
    names = rng.choice(list(CORRUPTIONS), size=2, replace=False)
    for n in names:
        x = CORRUPTIONS[n](x, s, rng)
    return x


def corrupt_batch(x: np.ndarray, rng: np.random.Generator,
                  max_severity: int = 5) -> np.ndarray:
    """Paper protocol: uniformly sample an augmentation + severity PER IMAGE."""
    names = list(CORRUPTIONS) + ["combination"]
    out = np.empty_like(x, dtype=np.float32)
    for i in range(x.shape[0]):
        name = names[rng.integers(len(names))]
        s = int(rng.integers(1, max_severity + 1))
        fn = combination if name == "combination" else CORRUPTIONS[name]
        out[i] = fn(x[i: i + 1].astype(np.float64), s, rng)[0]
    return out
