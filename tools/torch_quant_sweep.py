#!/usr/bin/env python3
"""How K8 (act_stats, csrc/act_stats.cu), K9 (quantize) and K10
(dequantize, both csrc/quantize.cu) spend their time at stablelm-1.6b's
width, at path E's rows (8 and 2048; K8 also at w_down's 5632 columns)
and at a streaming size (16384 rows: 128 MiB of f32, past the 50 MB L2);
K10 at 2048 and 16384 rows, per row and per channel, to f32 and bf16.
Beside each, a PyTorch kernel that moves the same bytes and does next to
nothing else: ``x.sum(-1)`` for K8 (the same reads), ``x.to(int8)`` for
K9 (the same reads and writes), ``q.to(dtype)`` for K10.

Four times each, in µs:
  flush        the CUDA-event median of 30 launches, each after a 64 MB
               buffer is written (zeroed) to evict the L2 and a ~1 ms
               device spin: chip_smoke.py's ``median_ms`` exactly;
  flush_clean  the same with the 64 MB buffer read (summed) instead, so
               that the L2 holds clean lines when the kernel starts;
  warm         the same without any flush;
  b2b          20 launches back to back between two events, their mean
               (a ~6 ms spin first); the median of 5 such runs.

Needs an NVIDIA GPU; from the repository root:

    python3 tools/torch_quant_sweep.py [--src DIR]

``--src`` times the kernels of another checkout's package root (default
this one's ``src/``) through the same wrappers, so that two versions
compare in one call: run parent, change, change, parent.  Prints one line
per case and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BPS = 3.35e12          # H100 SXM, NVIDIA data sheet
K = 2048                   # stablelm-1.6b's d_model
K_DOWN = 5632              # its d_ff: w_down's input width
ROWS = (8, 2048, 16384)
GAMMA = 4                  # path E's sampling stride on (8, 256, K) rows


def timed_us(fn, flush, reps=30):
    """Median µs of one call of ``fn``; ``flush`` runs before each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
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


def b2b_us(fn, n=20, runs=5):
    """Mean µs of n launches back to back, the median of ``runs`` runs; a
    ~6 ms device spin first, so that the host has queued all n before the
    device reaches them."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / n)
    times.sort()
    return times[len(times) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the package root whose K8-K10 to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_quant_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import act_stats as st
    from repro_torch.kernels import quantize as qz
    print(f"K8-K10 of {Path(st.__file__).parents[2]}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    clean = buf.view(torch.float32)
    flushes = {"flush": buf.zero_, "flush_clean": lambda: clean.sum(),
               "warm": lambda: None}

    def line(label, fn, bytes_moved):
        t = {k: timed_us(fn, f) for k, f in flushes.items()}
        t["b2b"] = b2b_us(fn)
        print(f"{label}: " + " ".join(f"{k} {v:.2f}" for k, v in t.items())
              + f" us (bytes bound {bytes_moved / HBM_BPS * 1e6:.2f} us)", flush=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # K8: (label, x)
    stats = [(f"({M}, {K}) {str(dt)[6:]}", randn(M, K).to(dt))
             for dt in (torch.float32, torch.bfloat16) for M in ROWS]
    stats += [(f"({M}, {K_DOWN}) float32", randn(M, K_DOWN)) for M in (8, 2048)]
    stats.append((f"(8, 256, {K}) bfloat16[:, ::{GAMMA}]",
                  randn(8, 256, K).to(torch.bfloat16)[:, ::GAMMA]))
    for label, x in stats:
        rows = x[..., 0].numel()
        nbytes = rows * x.shape[-1] * x.element_size()
        line(f"K8 act_stats {label}", lambda: st.act_stats_cuda(x), nbytes + 8 * rows)
        line(f"   x.sum(-1) {label}", lambda: x.sum(-1), nbytes + 4 * rows)
        del x
    del stats

    # K9 per row and per channel, f32 and bf16; K10 of K9's codes back to x's type
    for M in ROWS:
        for dt in (torch.float32, torch.bfloat16):
            for pc in (False, True):
                n = K if pc else M
                shape = (1, K) if pc else (M, 1)
                s = (0.001 + 0.299 * torch.rand((n,), generator=gen, device=dev)).reshape(shape)
                z = torch.randint(-40, 40, shape, generator=gen, device=dev,
                                  dtype=torch.int32)
                x = (60 * randn(M, K) * s).to(dt)
                label = f"({M}, {K}) {str(dt)[6:]} per {'channel' if pc else 'row'}"
                nbytes = M * K * (x.element_size() + 1)
                line(f"K9 quantize {label}", lambda: qz.quantize_cuda(x, s, z), nbytes + 8 * n)
                line(f"   x.to(int8) {label}", lambda: x.to(torch.int8), nbytes)
                if M > 8:
                    # K10 back to the type K9 was given, on the route its plan takes
                    q = qz.quantize_cuda(x, s, z)
                    plan = getattr(qz, "dequantize_plan", None)   # None: a checkout before it
                    route = "one route" if plan is None else plan(
                        M, K, x.element_size(), True).route
                    line(f"K10 dequantize {label} ({route})",
                         lambda: qz.dequantize_cuda(q, s, z, dt), nbytes + 8 * n)
                    line(f"   q.to({str(dt)[6:]}) {label}", lambda: q.to(dt), nbytes)
                    del q
                del x
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
