#!/usr/bin/env python3
"""How the guard's fp-dequant fallback (csrc/fp_dequant.cu) spends its
time at stablelm-1.6b's guarded projections: QKV (2048 -> 6144), wo (2048
-> 2048), gate/up (2048 -> 11264) and w_down (5632 -> 2048) at 8 decode
rows, QKV at 64 rows and at 2048 prefill rows, bf16 x and y as path F runs
them, and QKV with f32 x (the CUDA-core route).

Per case, in µs: ``taken`` (the flag set by a one-element fill inside the
timed call, as ``chip_smoke.py`` times it) and ``not_taken``, each the
CUDA-event median of 30 calls after a 64 MB L2 flush
(``chip_smoke.median_ms``), and ``b2b``, the mean of 20 taken calls back
to back (the median of 5 runs).  For the decode rows the tree's own
kernel is also timed at other split counts than its plan's (the launch
made through the library with the plan changed, each checked against the
f32 product), which is what the plan's cost model is fitted to.

Needs an NVIDIA GPU; from the repository root:

    python3 tools/torch_fallback_sweep.py [--src DIR]

``--src`` times another checkout's package root (default this one's
``src/``) through its own wrapper, so that two versions compare in one
call: run parent, change, change, parent.  Prints one line per case and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, M, K, N, x dtype name)
CASES = [("qkv", 8, 2048, 6144, "bfloat16"), ("wo", 8, 2048, 2048, "bfloat16"),
         ("gate/up", 8, 2048, 11264, "bfloat16"), ("w_down", 8, 5632, 2048, "bfloat16"),
         ("qkv 64 rows", 64, 2048, 6144, "bfloat16"),
         ("qkv prefill", 2048, 2048, 6144, "bfloat16"), ("qkv f32 x", 8, 2048, 6144, "float32")]
OTHER_KC = (32, 16, 11, 8, 6, 4)      # split sizes tried beside the plan's at decode rows


def b2b_us(fn, n=20, runs=5):
    """Mean µs of n calls back to back, the median of ``runs`` runs."""
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
                    help="the package root whose fallback to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_fallback_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import median_ms
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import fp_dequant as fd
    from repro_torch.kernels import w8a8_matmul as mm
    print(f"fallback of {Path(fd.__file__).parents[2]}", flush=True)
    own = hasattr(fd, "plan")            # this tree's kernel: its plan can be varied
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flag = fd.flag_buffer(dev)
    for label, M, K, N, dt in CASES:
        dtype = getattr(torch, dt)
        x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        q = mm.k_major(torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                                     generator=gen))
        sc = 0.001 + 0.01 * torch.rand((N,), generator=gen, device=dev)
        y = torch.empty((M, N), dtype=dtype, device=dev)
        want = ref.fp_dequant_matmul(x, q, sc, torch.float32)
        tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5

        def taken(launch):
            def fn():
                flag[:1].fill_(1)
                launch()
            return fn

        def check():
            return bool(((y.float() - want).abs() <= tol * want.abs()
                         + 1e-5 * float(want.abs().max())).all())

        wrapper = taken(lambda: fd.fp_dequant_fallback_cuda(y, x, q, sc, flag))
        t = median_ms(wrapper, flush=flush) * 1e3
        nt = median_ms(lambda: fd.fp_dequant_fallback_cuda(y, x, q, sc, flag),
                       flush=flush) * 1e3
        ok = check()
        plan = fd.plan(fd.route_for(x, q), M, K, N, fd._sms(dev)) if own else None
        print(f"{label} x ({M}, {K}) {dt} @ ({K}, {N}): taken {t:.2f} b2b "
              f"{b2b_us(wrapper):.2f} not_taken {nt:.2f} us, within tolerance {ok}"
              + (f"; {plan}" if plan else ""), flush=True)
        if not own or plan.route != "wgmma" or M > fd.DECODE_ROWS:
            continue
        lib = _build.library("fp_dequant", fd._SIG)
        for kc in OTHER_KC:
            splits = -(-plan.nks // kc)
            if kc >= plan.nks or kc == plan.kc or (splits - 1) * kc >= plan.nks:
                continue
            tiles = plan.row_tiles * plan.col_tiles
            p = dataclasses.replace(plan, kc=kc, splits=splits, items=tiles * splits,
                                    grid=min(tiles * splits, fd._sms(dev)),
                                    ws=splits * tiles * fd.THREADS * plan.acc)

            def launch(p=p):
                code = lib.fp_dequant_fallback(
                    x.data_ptr(), fd._KINDS[x.dtype], q.data_ptr(), sc.data_ptr(),
                    y.data_ptr(), fd._KINDS[y.dtype], fd._ROUTE_CODE[p.route], M, K, N,
                    p.rows, p.row_tiles, p.col_tiles, p.nks, p.kc, p.splits, p.items,
                    p.grid, fd._workspace(dev, p.ws).data_ptr(),
                    fd._tickets(dev).data_ptr(), flag.data_ptr(), None,
                    _build.stream_ptr(dev))
                _build.check(code, "fp_dequant_fallback")

            fn = taken(launch)
            t = median_ms(fn, flush=flush) * 1e3
            print(f"   split kc {kc}: {splits} splits, {p.grid} blocks: taken {t:.2f} b2b "
                  f"{b2b_us(fn):.2f} us, within tolerance {check()}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
