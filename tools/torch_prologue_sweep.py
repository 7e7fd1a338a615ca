#!/usr/bin/env python3
"""How K1 (the PDQ prologue, csrc/pdq_prologue.cu) spends its time at
stablelm-1.6b's width (K = 2048 bf16): the plain mode and the main path's
norm + prologue + interval mode (QKV's 3 segments, 48 blocks), at decode
(8 rows), a prefill round (2048 rows) and a streaming size (16384 rows,
96 MB, past the 50 MB L2).  Beside them, two PyTorch kernels that move bytes and do nothing else: ``x.to(int8)``
(the plain mode's bytes: 2 read, 1 written an element) and ``y.copy_(x)``
(4 an element).

Three times each, in µs: "flush", the CUDA-event median of 30 launches,
each after a 64 MB L2 flush and a ~1 ms device spin (as chip_smoke.py's
``median_ms``); "warm", the same without the flush; "b2b", 20 launches back
to back between two events, their mean.  Last, the host's time per call
at 8 rows (the wrapper and its launches: 100 calls to warm up, then the
mean of 100 enqueued behind a device spin, few enough that the fused
mode's four launches a call stay inside CUDA's queue of pending launches,
which would otherwise hold the host until the spin ends), each mode on a
QKV-like record.
Needs an NVIDIA GPU; from the repository root:

    python3 tools/torch_prologue_sweep.py [--src DIR]

``--src`` times the K1 of another checkout's package root (default this
one's ``src/``); a version without the fused modes times its plain mode,
so that two versions compare in one call.  Prints one line per case and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = (8, 2048, 16384)


def median_us(fn, flush, reps=30):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    times.sort()
    return times[len(times) // 2]


def b2b_us(fn, n=20):
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def host_us(fn, warm=100, n=100):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the package root whose K1 to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_prologue_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import pdq_prologue as pro
    fused = "norm" in inspect.signature(pro.pdq_prologue_cuda).parameters
    print(f"K1 of {pro.__file__}" + ("" if fused else ": plain mode only"), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    K = 2048
    w = (0.2 * torch.randn((K,), generator=gen, device=dev)).to(torch.bfloat16)
    rec = {"mu_w": torch.full((3,), 1e-4, device=dev),
           "var_w": torch.full((3,), 1.0 / K, device=dev),
           "alpha": torch.full((3,), 6.0, device=dev),
           "beta": torch.full((3,), 6.0, device=dev)}
    modes = {"prologue": (None, None), "norm+interval": ((w, 1e-5), (rec, (16, 16, 16)))}
    if not fused:
        del modes["norm+interval"]

    def line(label, fn, bytes_moved):
        t = (median_us(fn, flush), median_us(fn, None), b2b_us(fn))
        print(f"M {M} {label}: flush {t[0]:.2f} warm {t[1]:.2f} b2b {t[2]:.2f} us "
              f"(bytes bound {bytes_moved / 3.35e12 * 1e6:.2f} us)", flush=True)

    for M in ROWS:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty_like(x)
        line("x.to(int8)", lambda: x.to(torch.int8), 3 * M * K)
        line("y.copy_(x)", lambda: y.copy_(x), 4 * M * K)
        for mode, (norm, iv) in modes.items():
            extra = 0 if iv is None else 2 * K + 8 * M * 48
            call = (lambda: pro.pdq_prologue_cuda(x, norm, iv)) if fused else (
                lambda: pro.pdq_prologue_cuda(x))
            line(f"K1 {mode}", call, 3 * M * K + 12 * M + extra)
    x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
    hosts = {"x.to(int8)": lambda: x.to(torch.int8), "K1 prologue": lambda: pro.pdq_prologue_cuda(x)}
    if fused:
        hosts.update({
            "K1 interval": lambda: pro.pdq_prologue_cuda(x, None, (rec, None)),
            "K1 norm+interval": lambda: pro.pdq_prologue_cuda(x, *modes["norm+interval"])})
    print("host us per call at 8 rows: "
          + ", ".join(f"{k} {host_us(f):.1f}" for k, f in hosts.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
