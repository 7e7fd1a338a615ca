"""Calibration loop (paper Sec. 4.1 / 5.2): port of
``repro/core/calibrate.py``.

Runs the model in *observe* mode over a small calibration set (the paper uses
16 images), capturing every quantized layer's pre-activations and PDQ moment
predictions, then fits:

* the static output ranges  (static-quantization baseline), and
* the PDQ interval parameters (alpha, beta) via coverage quantiles (Eq. 13).

Both baselines and our method deliberately share the same calibration data,
exactly as in the paper.  The tape's tensors come to the host once a batch;
the fitting is the reference's numpy, and the returned state's tensors lie
on the device the model ran on.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

from . import interval as interval_mod
from .policy import QuantSpec, as_observe

# Cap on pooled deviation samples per layer (memory bound, deterministic).
_MAX_DEV_SAMPLES = 1 << 16

ApplyFn = Callable[..., Any]  # apply(params, batch, *, spec, qstate, tape) -> out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _subsample(a: np.ndarray, limit: int) -> np.ndarray:
    if a.shape[0] <= limit:
        return a
    stride = int(np.ceil(a.shape[0] / limit))
    return a[::stride]


def calibrate(
    apply_fn: ApplyFn,
    params: Any,
    batches: Iterable[Any],
    spec: QuantSpec,
) -> dict[str, dict[str, torch.Tensor]]:
    """Returns the per-layer quantization state used at inference."""
    obs_spec = as_observe(spec)
    ranges: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}
    devs: dict[str, list[np.ndarray]] = {}
    device = None

    for batch in batches:
        tape: dict[str, Any] = {}
        with torch.no_grad():
            apply_fn(params, batch, spec=obs_spec, qstate={}, tape=tape)
        for name, rec in tape.items():
            device = rec["y"].device
            y = _host(rec["y"])
            pol = spec.resolve(name)
            # --- static range (min/max over everything but channels) ---
            if pol.per_channel and rec["kind"] != "input":
                axes = tuple(range(y.ndim - 1))
                lo, hi = y.min(axis=axes), y.max(axis=axes)
            else:
                lo, hi = np.float32(y.min()), np.float32(y.max())
            ranges.setdefault(name, []).append((lo, hi))
            # --- PDQ deviations ---
            m = rec.get("moments")
            if m is not None:
                mean = _host(m.mean)
                sigma = np.sqrt(np.maximum(_host(m.var), 0.0)) + 1e-8
                if pol.per_channel:
                    # mean/sigma: (B, C); y: (B, pos..., C)
                    bshape = (y.shape[0],) + (1,) * (y.ndim - 2) + (y.shape[-1],)
                    u = (y - mean.reshape(bshape)) / sigma.reshape(bshape)
                    u = u.reshape(-1, y.shape[-1])
                else:
                    bshape = (y.shape[0],) + (1,) * (y.ndim - 1)
                    u = (y - mean.reshape(bshape)) / sigma.reshape(bshape)
                    u = u.reshape(-1, 1)
                devs.setdefault(name, []).append(_subsample(u, _MAX_DEV_SAMPLES))

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device)

    qstate: dict[str, dict[str, torch.Tensor]] = {}
    for name, rr in ranges.items():
        los = np.stack([r[0] for r in rr])
        his = np.stack([r[1] for r in rr])
        entry: dict[str, torch.Tensor] = {
            "static_lo": dev(los.min(axis=0)),
            "static_hi": dev(his.max(axis=0)),
        }
        if name in devs:
            pol = spec.resolve(name)
            u = np.concatenate(devs[name], axis=0)
            u = _subsample(u, 4 * _MAX_DEV_SAMPLES)
            ip = interval_mod.calibrate_alpha_beta(
                u, target_coverage=pol.coverage,
                channel_axis=1 if pol.per_channel else None,
            )
            if not pol.per_channel:
                ip = interval_mod.IntervalParams(ip.alpha.reshape(()), ip.beta.reshape(()))
            else:
                # small-sample guard: a channel's quantile from few pooled
                # positions (e.g. dense layers: 1/row/image) undershoots the
                # range and clips; floor each channel at the per-tensor fit.
                ip_t = interval_mod.calibrate_alpha_beta(
                    u, target_coverage=pol.coverage, channel_axis=None)
                ip = interval_mod.IntervalParams(
                    alpha=torch.maximum(ip.alpha, ip_t.alpha),
                    beta=torch.maximum(ip.beta, ip_t.beta))
            entry["alpha"] = ip.alpha.to(device)
            entry["beta"] = ip.beta.to(device)
        qstate[name] = entry
    return qstate
