#!/usr/bin/env python3
"""Where the int8-KV attend kernels' time goes: K4 and K5 on both routes
(split, single) at stablelm-1.6b's decode shape (B 8, Hkv 32, G 1, Dh 64)
across length patterns that isolate one cost each:

  lengths 1 everywhere    the fixed cost: launch, length and q loads, the
                          idle blocks past each row, one position a block;
  128 everywhere          one full chunk a row, written directly (no merge);
  129 everywhere          a second, one-position split: adds the merge
                          (record, ticket, reading the records back);
  256, 512                more chunks a row;
  Sp 128, lengths 128     the 128 case without idle blocks;
  Sp 4096                 chip_smoke.py's long cache and a full one.

Each time is the CUDA-event median of 50 launches, each after a 64 MB L2
flush and a ~1 ms device spin (as chip_smoke.py's ``median_ms``); "K4
split warm" skips the flush.  Needs an NVIDIA GPU; from the repository root:

    python3 tools/torch_attend_sweep.py

Prints one line per case and the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [(512, [1, 57, 128, 129, 250, 300, 511, 512]), (512, [1] * 8), (512, [128] * 8),
         (512, [129] * 8), (512, [256] * 8), (512, [512] * 8), (128, [128] * 8),
         (4096, [4096, 3500, 2048, 1500, 1024, 700, 129, 1]), (4096, [4096] * 8)]


def median_us(fn, flush, reps=50):
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_attend_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import kv_cache as kv
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    B, Hkv, G, Dh = 8, 32, 1, 64
    pro = torch.bfloat16
    for Sp, lens in CASES:
        i8 = dict(dtype=torch.int8, device=dev, generator=gen)
        args = (torch.randn((B, Hkv * G, Dh), generator=gen, device=dev),
                torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
                torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
                torch.rand((B, Hkv, Sp), generator=gen, device=dev),
                torch.rand((B, Hkv, Sp), generator=gen, device=dev),
                torch.tensor(lens, dtype=torch.int32, device=dev))
        t = {
            "K4 split": median_us(lambda: kv.decode_attend_i8kv_cuda(*args), flush),
            "K4 split warm": median_us(lambda: kv.decode_attend_i8kv_cuda(*args), None),
            "K4 single": median_us(lambda: kv.decode_attend_i8kv_cuda(*args, route="single"),
                                   flush),
            "K5 split": median_us(lambda: kv.decode_attend_i8kv_fused_cuda(*args, pro), flush),
            "K5 single": median_us(lambda: kv.decode_attend_i8kv_fused_cuda(
                *args, pro, route="single"), flush)}
        print(f"Sp {Sp} lengths {lens}: "
              + ", ".join(f"{k} {v:.2f}" for k, v in t.items()) + " us", flush=True)
    x = torch.zeros(8, device=dev)
    small = median_us(lambda: x.add_(1), flush)
    print(f"one small torch kernel (x.add_(1) on 8 floats): {small:.2f} us")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
