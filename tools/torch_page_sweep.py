#!/usr/bin/env python3
"""What a decode step's paged-pool movements cost at the paged serving
path's full width: stablelm-1.6b (24 layers, int8 KV cache), 8 slots,
max_len 512, page 64, a pool of 65 pages, every slot at position 300 (5 of
its 8 pages valid), as ``chip_smoke.py`` profiles path D1.  One step's
movements are ``paged_cache(...).gather`` (the pool's pages into a fresh
logical tree) and ``.writeback`` (each slot's frontier page back).

Device time of one step's gather + write-back, in µs, from torch.profiler
(every device row: kernels, fills and the maps' host-to-device copies),
three ways: "flush", each step after a 64 MB L2 flush (a ``bitwise_not_``
whose rows are left out); "warm", steps back to back under the profiler;
"b2b", CUDA events around 20 steps back to back, their mean (this one
includes any time the device waits for the host).  Then the rows of one
step, and the host's time of a step: ``gather`` and ``writeback`` each
timed alone from an idle device, median of 30 calls, and their sum.
Needs an NVIDIA GPU; from the repository root:

    python3 tools/torch_page_sweep.py [--src DIR]

``--src`` times the package of another checkout's package root (default
this one's ``src/``), so that two versions compare in one call.  Prints
one line per measure and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLOTS, MAX_LEN, PAGE, POS = 8, 512, 64, 300


def device_rows(prof, per, skip=()):
    """{kernel: (µs, launches)} per ``per`` steps of every device row."""
    from torch.autograd import DeviceType
    rows = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or any(k in ev.key for k in skip):
            continue
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        rows[ev.key] = (us / per, ev.count / per)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the package root whose paged pool to time")
    ap.add_argument("--steps", type=int, default=10, help="profiled steps")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_page_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import api
    print(f"paged pool of {api.__file__}", flush=True)
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), quant_kv="dynamic")
    po = build_model(cfg, "cuda").paged_cache(SLOTS, MAX_LEN, PAGE)
    n_pp = MAX_LEN // PAGE
    pool = po.init(SLOTS * n_pp + 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for d in pool["blocks"]:
        for leaf in d.values():
            b = leaf.view(torch.uint8)
            b.copy_(torch.randint(0, 256, b.shape, generator=gen, device="cuda",
                                  dtype=torch.uint8))
    pt = (1 + np.arange(SLOTS * n_pp, dtype=np.int32)).reshape(SLOTS, n_pp)
    lengths = np.full((SLOTS,), POS, np.int32)
    positions = lengths[:, None]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    state = {}

    def gather():
        state["logical"] = po.gather(pool, pt, lengths)

    def writeback():
        po.writeback(pool, state["logical"], pt, positions)

    def step():
        gather()
        writeback()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            flush.bitwise_not_()
            step()
        torch.cuda.synchronize()
    cold = device_rows(prof, args.steps, skip=("bitwise_not",))
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    warm = device_rows(prof, args.steps)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(20):
        step()
    b.record()
    b.synchronize()
    b2b = a.elapsed_time(b) * 1e3 / 20
    print(f"device us a step (gather + write-back): flush "
          f"{sum(v[0] for v in cold.values()):.1f} warm "
          f"{sum(v[0] for v in warm.values()):.1f} b2b {b2b:.1f}; device rows a step "
          f"{sum(v[1] for v in warm.values()):.0f}", flush=True)
    for k, (us, n) in sorted(warm.items(), key=lambda kv: -kv[1][0]):
        print(f"  warm row: {us:9.1f} us {n:5.1f} x {k[:100]}", flush=True)

    def host_us(fn, n=30):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        return sorted(times)[n // 2]

    g, w = host_us(gather), host_us(writeback)
    print(f"host us a step: gather {g:.1f} write-back {w:.1f} sum {g + w:.1f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
