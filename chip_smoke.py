#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Serving paths of full-width stablelm-1.6b (24 layers, bf16, random weights
from a seeded generator), each built with build_engine(ServeConfig(...,
device="cuda")), and one path of ops-level calls on its weights (E):

  A  int8_kv=True, quantize_weights=True   the main path: PDQ-int8 weights
     in every layer and the int8 KV cache (kernels K1 pdq_prologue, K2
     w8a8_matmul, K3 w8a8_swiglu_matmul, K5 decode_attend_i8kv_fused,
     K6 cache_scatter; 7 launches per layer and decode step);
  B  int8_kv=True, fp weights              K4 decode_attend_i8kv and K6;
  C  int8_kv=False, quantize_weights=True  the fp KV cache: K1, K2, K3, K6;
  D  A with the pool paged: paged=True, spill=True, page_size=64, which adds
     K7 cache_scatter_pages (every pool movement: prefill landing, decode
     gather and write-back, COW copy, spill restore); D1 with the default
     pool (every slot can hold max_len), D2 with a pool small enough that
     decode growth preempts requests and spills them to host memory;
  E  the ops-level quantization entry points on path A's own PDQ records
     (layer 0's Q segment of the grouped QKV, wo and w_down) at 8 and 2048
     rows: ops.pdq_dense_unfused, the pre-fusion projection (K8 act_stats +
     K2's requant epilogue), ops.act_stats (also with the sampling stride
     gamma), ops.quantize (K9) and ops.dequantize (K10) of its output on its
     own grid, and the fused ops.pdq_dense (K1 + K2) beside it.

Phases, each of which must pass (any failure exits non-zero):

  1. build    - compile every kernel from src/repro_torch/csrc/ with nvcc
                for sm_90a, one process per source, in parallel;
  2. kernels  - call each kernel's wrapper on card tensors at the shapes
                the full-width paths give it, hold the result against its
                plain PyTorch version on the same inputs, and time both
                (CUDA events, median, L2 flushed before every launch); K2
                and K3 on both routes (wgmma, the main path's, and generic,
                which must give the same bits), beside torch._int_mm on
                the K-major weights and on a row-major copy, with the host
                time per call of each route and K3's quantize tail;
  3. serve    - each path serves 8 requests (prompts of 20-250 tokens, the
                first two behind one 128-token system prompt, 32 new tokens
                each, 8 slots, max_len 512); the kernels' counts are zeroed
                just before and read just after each run, every kernel of
                the path must have launched as often as its op was entered,
                the census must hold exactly, every K2/K3 launch must have
                taken the wgmma route, and the other paths' kernels must
                not have run; the runs go in turns A B C C A D1 D2, so
                that A's and C's times compare within one call; D1's and
                D2's greedy streams must equal A's first run's, D1 must
                share the system prompt's pages, D2 must preempt, spill and
                restore;
  4. profile  - torch.profiler over three decode steps of the full pool of
                A, C and D1: device time per step, the device's idle share
                of the serve phase's median step, the top kernels;
  5. parity   - on each path, one request's first 8 greedy tokens through
                the kernels and through the plain versions on the card
                (teacher-forced on the kernel path's tokens): logits within
                the path's LOGIT_TOL, and each step's argmax agrees or the
                plain path's top-2 margin is below it;
  6. unfused  - path E, after the serving runs: counts zeroed before and read
                after, an exact census (each unfused call one K8 and one K2,
                no K1; every K2 on the wgmma route), the re-quantized output
                equal to the projection's own codes and dequantized back bit
                for bit, the same calls on CPU copies of the inputs (the
                plain versions) within one int8 step, fused against unfused
                within one step per row (the
                reference's contract), both timed end to end, and three
                unfused calls profiled.

It prints the card's name and power limit, one JSON line with every
kernel's launches (on its path), error and times, and as its last line
{"ok": true, "device": {...}}.  Without CUDA, or without the repository
around it, it fails before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and int8 / f32 ops/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_OPS = 67e12

# |kernel - plain| logits bound in the parity phase.  With the fp KV cache
# (C) every kernel on the path equals its plain version bit for bit.  With
# the int8 KV cache (A, B) the attend kernels sum in another order than the
# plain einsum (o within ATTEND_TOL); that moves bf16 roundings and int8
# codes at ties downstream, over 24 layers, and the logits are bf16 (one
# ulp is 0.03125 at |logit| in [4, 8)): their bound is 8 such ulps.
LOGIT_TOL = {"A": 0.25, "B": 0.25, "C": 0.05}
SUM_RTOL = 1e-5           # s1/s2: another summation order than the plain one
ATTEND_TOL = 2e-4         # attend o, rtol = atol (tests/test_kernels.py:177)
ATTEND_LENS = (1, 57, 128, 129, 250, 300, 511, 512)   # ragged across the tile

E_ROWS = (8, 2048)        # path E: decode rows (the slots), prefill (8 x 256)
E_GAMMA = 4               # act_stats' sampling stride on E's (8, 256, K) input
E_SPIN = 20_000_000       # E's device spin before each timed call, cycles (~10 ms)
E_PROFILED = 3            # unfused calls in E's profile of each case
PAGE = 64                 # path D's page size
D2_POOL_PAGES = 17        # D2's physical pages: 16 usable, 2 slots' worth

# path: (int8_kv, quantize_weights, the kernels it must launch, paging)
_A_KERNELS = ("pdq_prologue", "w8a8_matmul", "w8a8_swiglu_matmul",
              "decode_attend_i8kv_fused", "cache_scatter")
_PAGED = dict(paged=True, spill=True, page_size=PAGE)
PATHS = {
    "A": (True, True, _A_KERNELS, {}),
    "B": (True, False, ("decode_attend_i8kv", "cache_scatter"), {}),
    "C": (False, True, ("pdq_prologue", "w8a8_matmul", "w8a8_swiglu_matmul",
                        "cache_scatter"), {}),
    "D1": (True, True, _A_KERNELS + ("cache_scatter_pages",), _PAGED),
    "D2": (True, True, _A_KERNELS + ("cache_scatter_pages",),
           dict(_PAGED, pool_pages=D2_POOL_PAGES)),
}


# K2/K3 rows also carry the generic route's time, torch._int_mm on the
# row-major copy, the host time per call of each route and K3's tail
EXTRA_KEYS = ("generic_ms", "library_rowmajor_ms", "host_us", "generic_host_us",
              "tail_ms")


class SmokeError(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
def median_ms(fn, reps=30, flush=None, spin=2_000_000):
    """Median time of one call of ``fn`` on the card: CUDA events around
    each call, a 64 MB write before each to evict the 50 MB L2 (the main
    path reads each layer's weights once per step), then a device spin of
    ``spin`` cycles (~1 ms by default) so that the host has enqueued the
    call before the device reaches it: the events time the device's work,
    not the host's launch cost.  A call of many small launches needs a
    longer spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(bytes_moved, ops, ops_rate):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    d = (a.double() - b.double()).abs()
    return float(d.max()) if d.numel() else 0.0


# ------------------------------------------------------------------ phases
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    dt = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    for name in _build.SOURCES:
        need(_build.library_path(name).exists(), f"{name}.cu did not build")
    log(f"build: {len(reports)} sources compiled in {dt:.1f} s "
        f"(ptxas report in chiprun_out/ptxas.txt)")


def kernel_inputs(eng, gen):
    """Main-path operands at full width, from layer 0's weight records and
    random activations: decode M = slots rows."""
    import torch
    dev = eng.device
    M = eng.slots
    p0 = eng.params["blocks"][0]
    qkv = p0["attn"]["wq"]["group"]
    gu = p0["ffn"]["w_gate"]["group"]
    wo, down = p0["attn"]["wo"], p0["ffn"]["w_down"]
    d = eng.cfg.d_model
    x = torch.randn((M, d), generator=gen, device=dev).to(torch.bfloat16)
    return dict(M=M, d=d, x=x, qkv=qkv, gu=gu, wo=wo, down=down)


def epi_operands(rec, x, per_block):
    """The operands the op layer gives K2/K3 for ``rec`` on the main path:
    (x_q, w_q, s_x, z_x = None, s_w, colsum = None) and the clamp (lo, hi)."""
    from repro_torch.kernels import ops
    x_q, s_x, s1, s2 = ops.pdq_prologue(x)
    _, _, s_out, z_out = ops.pdq_interval(rec, s1, s2)
    lo, hi = ops._grid_extent(s_out, z_out)
    if per_block:
        lo, hi = ops._blockwise(lo, rec["segs"]), ops._blockwise(hi, rec["segs"])
    N = rec["q"].shape[1]
    return (x_q, rec["q"], s_x, None, rec["scale"].reshape(1, N), None), (lo, hi)


def phase_kernels(eng):
    """Each kernel against its plain version at the shapes of path A's
    engine ``eng``; returns {kernel: row} for the JSON line plus per-shape
    detail rows."""
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import pdq_prologue as pro
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(1234)
    t = kernel_inputs(eng, gen)
    d, x = t["d"], t["x"]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=eng.device)
    rows, detail = {}, []

    def record(name, shape, err, k_ms, p_ms, b_ms, b_by, lib_ms, primary, **extra):
        row = dict(name=name, shape=shape, max_abs_err=err, ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   **extra)
        detail.append(row)
        log(f"kernel {name} {shape}: err {err:.3g} kernel {k_ms:.4f} ms "
            f"plain {p_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            + "".join(f" {k} {v}" for k, v in extra.items()))
        if primary:
            rows[name] = row

    # prefill-shaped rows: 8 slots x the 256-token bucket
    x_pre = torch.randn((2048, d), generator=gen, device=eng.device).to(torch.bfloat16)

    # ---- K1 pdq_prologue: decode (M, 2048) and prefill (2048, 2048) rows
    for xm, primary in ((x, True), (x_pre, False)):
        k_out = pro.pdq_prologue_cuda(xm)
        p_out = pro.pdq_prologue_plain(xm)
        need(torch.equal(k_out[0], p_out[0]), "K1 x_q differs from plain")
        need(torch.equal(k_out[1], p_out[1]), "K1 s_x differs from plain")
        absx = xm.float().abs().sum(-1, keepdim=True)
        need(bool(((k_out[2] - p_out[2]).abs() <= SUM_RTOL * absx).all()),
             "K1 s1 outside tolerance")
        need(bool(((k_out[3] - p_out[3]).abs() <= SUM_RTOL * p_out[3]).all()),
             "K1 s2 outside tolerance")
        err = max(max_abs(a, b) for a, b in zip(k_out, p_out))
        Mx, K = xm.shape
        b_ms, b_by = bound_ms(Mx * K * 3 + Mx * 12, 6 * Mx * K, F32_OPS)
        record("pdq_prologue", f"x ({Mx}, {K}) bf16", err,
               median_ms(lambda: pro.pdq_prologue_cuda(xm), flush=flush),
               median_ms(lambda: pro.pdq_prologue_plain(xm), flush=flush),
               b_ms, b_by, None, primary)

    # ---- K2 w8a8_matmul and K3 w8a8_swiglu_matmul, both routes
    matmul_kernels(eng, t, gen, flush, record, x_pre)

    # ---- K4 decode_attend_i8kv and K5 its fused form: one decode step's
    # attention over path A's int8 cache, lengths ragged across the tile
    attend_kernels(eng, gen, flush, record)

    # ---- K7 cache_scatter_pages: path D's pool movements at full width
    page_kernels(eng, gen, flush, record)

    # ---- K8 act_stats, K9 quantize, K10 dequantize: path E's shapes
    quant_kernels(eng, gen, flush, record)

    # ---- K6 cache_scatter: one admission round's leaves, stacked rows
    pool = eng.bundle.init_caches(eng.slots, eng.max_len)["blocks"][0]
    sub = eng.bundle.init_caches(eng.slots, eng.max_len)["blocks"][0]
    for leaf in sub.values():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=eng.device))
        else:
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen,
                                     device=eng.device, dtype=leaf.dtype))
    n, B = pool["k"].shape[:2]
    smap = torch.tensor([2, -1, 0, 1, -1, 3, -1, -1], dtype=torch.int32,
                        device=eng.device)[:B]
    stack = torch.arange(n, device=eng.device, dtype=torch.int32)[:, None]
    fmap = torch.where(smap[None] >= 0, smap[None] + B * stack, -1).reshape(-1)
    fmap = fmap.to(torch.int32)
    landed = int((fmap >= 0).sum())
    for name in pool:
        dst = pool[name].reshape((n * B,) + pool[name].shape[2:])
        src = sub[name].reshape((n * B,) + sub[name].shape[2:])
        want = kv.cache_scatter_plain(dst.clone(), src, fmap)
        got = kv.cache_scatter_cuda(dst.clone(), src, fmap)
        need(torch.equal(got, want), f"K6 {name} leaf differs from plain")
        err = max_abs(got, want)
        del got, want
        row_bytes = dst[0].numel() * dst.element_size()
        b_ms, b_by = bound_ms(2 * landed * row_bytes + 4 * n * B, 0, INT8_OPS)
        dk, dp = dst.clone(), dst.clone()
        src_rows = fmap[fmap >= 0].long()
        dst_rows = torch.nonzero(fmap >= 0).flatten()
        record("cache_scatter", f"{name}: ({n * B}, {row_bytes} B) rows, "
               f"{landed} landed", err,
               median_ms(lambda: kv.cache_scatter_cuda(dk, src, fmap), flush=flush),
               median_ms(lambda: kv.cache_scatter_plain(dp, src, fmap), flush=flush),
               b_ms, b_by,
               median_ms(lambda: dk.index_copy_(0, dst_rows,
                                                src.index_select(0, src_rows)),
                         flush=flush),
               name == "k")
    return rows, detail


def int_mm_rows(x_q):
    """x_q as ``torch._int_mm`` takes it: more than 16 rows, so decode rows
    pad to 32."""
    import torch
    if x_q.shape[0] > 16:
        return x_q
    xl = torch.zeros((32, x_q.shape[1]), dtype=torch.int8, device=x_q.device)
    xl[:x_q.shape[0]] = x_q
    return xl


def library_int_mm(x_q, w_q, flush):
    """``torch._int_mm`` (the int32 product alone) on the weight record as
    the port stores it (K-major) and on a row-major (K, N) copy, the
    records' earlier layout: (K-major ms or None, row-major ms, note)."""
    import torch
    xl, w_rm = int_mm_rows(x_q), w_q.contiguous()
    row_ms = median_ms(lambda: torch._int_mm(xl, w_rm), flush=flush)
    try:
        need(torch.equal(torch._int_mm(xl, w_q), torch._int_mm(xl, w_rm)),
             "torch._int_mm differs between the two layouts")
        return median_ms(lambda: torch._int_mm(xl, w_q), flush=flush), row_ms, ""
    except RuntimeError as e:          # a yardstick only: record why it is missing
        return None, row_ms, f"K-major _int_mm refused: {e}"


def host_us(fn, n=100):
    """The host's time per call of ``fn`` (the wrapper and its launch,
    not the device's work), enqueued back to back behind a device spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def matmul_kernels(eng, t, gen, flush, record, x_pre):
    """K2 and K3 at path A's shapes: each route against the plain version
    and against each other (equal bits but for K3's s1/s2, summed in
    another order), timed beside the plain version, ``torch._int_mm`` on
    both weight layouts and the bound; the host time per call of each
    route; K3's quantize tail from the kernel's own stamps."""
    import torch
    from repro_torch.kernels import w8a8_matmul as mm
    M, x = t["M"], t["x"]
    h_in = torch.randn((M, eng.cfg.d_ff), generator=gen,
                       device=eng.device).to(torch.bfloat16)
    cases = (("qkv", t["qkv"], x, True, True), ("wo", t["wo"], x, False, False),
             ("w_down", t["down"], h_in, False, False),
             ("qkv prefill", t["qkv"], x_pre, True, False))
    for label, rec, xin, per_block, primary in cases:
        base, (lo, hi) = epi_operands(rec, xin, per_block)
        args = base + (None, None, lo, hi)
        kw = dict(out_dtype=torch.bfloat16)
        need(mm.route_for(base[0], base[1]) == "wgmma", f"K2 {label} takes the generic route")
        yk = mm.w8a8_matmul_cuda(*args, **kw)
        yg = mm.w8a8_matmul_cuda(*args, route="generic", **kw)
        yp = mm.w8a8_matmul_plain(*args, **kw)
        err = max_abs(yk, yp)
        need(err <= 1e-6 * float(yp.float().abs().max()) + 1e-6,
             f"K2 {label} fp_clamp output differs from plain by {err}")
        need(torch.equal(yk, yg), f"K2 {label}: the wgmma and generic routes differ")
        # the requant epilogue on the same product: int8 codes equal
        qargs = base + (torch.full_like(lo, 0.05), torch.zeros_like(lo, dtype=torch.int32))
        qp = mm.w8a8_matmul_plain(*qargs)
        for route in ("wgmma", "generic"):
            need(torch.equal(mm.w8a8_matmul_cuda(*qargs, route=route), qp),
                 f"K2 {label} requant codes of the {route} route differ from plain")
        Mx, K = base[0].shape
        N = rec["q"].shape[1]
        E = lo.shape[1]
        # x_q, w_q, bf16 out, s_w, and per row s_x plus E (lo, hi) pairs
        b_ms, b_by = bound_ms(Mx * K + K * N + Mx * N * 2 + N * 4 + Mx * (4 + 8 * E),
                              2 * Mx * K * N, INT8_OPS)
        lib_ms, row_ms, note = library_int_mm(base[0], rec["q"], flush)
        record("w8a8_matmul", f"{label}: x ({Mx}, {K}) @ w ({K}, {N}), epilogue "
               f"({Mx}, {E}); plan {mm.wgmma_plan(Mx, K, N, False, mm._sms(eng.device))}"
               f"{'; ' + note if note else ''}", err,
               median_ms(lambda: mm.w8a8_matmul_cuda(*args, **kw), flush=flush),
               median_ms(lambda: mm.w8a8_matmul_plain(*args, **kw), flush=flush),
               b_ms, b_by, lib_ms, primary,
               generic_ms=median_ms(lambda: mm.w8a8_matmul_cuda(*args, route="generic", **kw),
                                    flush=flush),
               library_rowmajor_ms=row_ms,
               host_us=host_us(lambda: mm.w8a8_matmul_cuda(*args, **kw)),
               generic_host_us=host_us(lambda: mm.w8a8_matmul_cuda(*args, route="generic",
                                                                   **kw)))

    # K3: gate/up (M, 2048) @ (2048, 11264), decode and prefill rows
    gu = t["gu"]
    stamps = torch.zeros((2 * mm._sms(eng.device),), dtype=torch.int64, device=eng.device)
    for xin, primary in ((x, True), (x_pre, False)):
        base, (lo, hi) = epi_operands(gu, xin, True)
        sargs = base + (lo, hi)
        need(mm.route_for(base[0], base[1]) == "wgmma", "K3 takes the generic route")
        ko = mm.w8a8_swiglu_matmul_cuda(*sargs)      # (hsw, hsw_q, s_x, s1, s2)
        go = mm.w8a8_swiglu_matmul_cuda(*sargs, route="generic")
        po = mm.w8a8_swiglu_matmul_plain(*sargs)
        hsw_err = max_abs(ko[0], po[0])
        need(hsw_err <= 1e-6 * float(po[0].abs().max()) + 1e-30,
             f"K3 hsw differs from plain by {hsw_err}")
        same = ko[0] == po[0]
        dq = (ko[1].int() - po[1].int()).abs()
        need(bool((dq[same] == 0).all()) and int(dq.max()) <= 1,
             "K3 hsw_q differs from plain where hsw agrees, or by > 1 code")
        need(torch.equal(ko[2], po[2]), "K3 s_x differs from plain")
        absh = po[0].abs().sum(-1, keepdim=True)
        need(bool(((ko[3] - po[3]).abs() <= SUM_RTOL * absh).all()), "K3 s1 outside tolerance")
        need(bool(((ko[4] - po[4]).abs() <= SUM_RTOL * po[4]).all()), "K3 s2 outside tolerance")
        need(all(torch.equal(u, v) for u, v in zip(ko[:3], go[:3])),
             "K3: the wgmma and generic routes differ in hsw, hsw_q or s_x")
        err = max(max_abs(u, v) for u, v in zip(ko, po))
        Mx, K = base[0].shape
        N = gu["q"].shape[1]
        P = N // 2
        # what pdq_mlp reads and keeps: x_q, w_q, s_w, s_x, the (lo, hi)
        # pairs, hsw_q and its three row values (hsw is the kernel's scratch)
        b_ms, b_by = bound_ms(Mx * K + K * N + N * 4 + Mx * (4 + 8 * N // 128)
                              + Mx * P + 12 * Mx, 2 * Mx * K * N, INT8_OPS)
        # the quantize tail (phase 2): from the end of the last block's GEMM
        # items to the end of the last block's quantize, median of 10 launches
        tails = []
        for _ in range(10):
            flush.zero_()
            mm.w8a8_swiglu_matmul_cuda(*sargs, stamps=stamps)
            st = stamps.view(-1, 2)[:mm.wgmma_plan(Mx, K, N, True, mm._sms(eng.device)).grid]
            tails.append(float(st[:, 1].max() - st[:, 0].max()) / 1e6)
        tails.sort()
        lib_ms, row_ms, note = library_int_mm(base[0], gu["q"], flush)
        record("w8a8_swiglu_matmul", f"x ({Mx}, {K}) @ w ({K}, {N}); plan "
               f"{mm.wgmma_plan(Mx, K, N, True, mm._sms(eng.device))}; hsw code "
               f"mismatches {int((dq > 0).sum())}{'; ' + note if note else ''}", err,
               median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs), flush=flush),
               median_ms(lambda: mm.w8a8_swiglu_matmul_plain(*sargs), flush=flush),
               b_ms, b_by, lib_ms, primary,
               generic_ms=median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs,
                                                                       route="generic"),
                                    flush=flush),
               library_rowmajor_ms=row_ms, tail_ms=tails[len(tails) // 2],
               host_us=host_us(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs)),
               generic_host_us=host_us(lambda: mm.w8a8_swiglu_matmul_cuda(
                   *sargs, route="generic")))

    # K3 where the GEMM is trivial (K = 16) and the quantize tail is most of
    # the launch: 64 rows, one generic row tile, whose last block quantizes
    # all 64 x 5632 values alone
    xt = torch.randint(-127, 128, (64, 16), dtype=torch.int8, device=eng.device,
                       generator=gen)
    wt = mm.k_major(torch.randint(-127, 128, (16, gu["q"].shape[1]), dtype=torch.int8,
                                  device=eng.device, generator=gen))
    nb = gu["q"].shape[1] // 128
    targs = (xt, wt, torch.full((64, 1), 0.01, device=eng.device), None,
             gu["scale"].reshape(1, -1), None,
             torch.full((64, nb), -50.0, device=eng.device),
             torch.full((64, nb), 50.0, device=eng.device))
    tw = mm.w8a8_swiglu_matmul_cuda(*targs)
    tg = mm.w8a8_swiglu_matmul_cuda(*targs, route="generic")
    tp = mm.w8a8_swiglu_matmul_plain(*targs)
    need(all(torch.equal(u, v) for u, v in zip(tw[:3], tg[:3])),
         "K3 tail shape: the routes differ")
    need(bool(torch.isclose(tw[0], tp[0], rtol=1e-6, atol=0).all()),
         "K3 tail shape: hsw differs from plain")
    N = gu["q"].shape[1]
    record("w8a8_swiglu_matmul", f"tail shape: x (64, 16) @ w (16, {N})",
           max_abs(tw[0], tp[0]),
           median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*targs), flush=flush),
           median_ms(lambda: mm.w8a8_swiglu_matmul_plain(*targs), flush=flush),
           *bound_ms(64 * 16 + 16 * N + N * 4 + 64 * (4 + 8 * N // 128) + 64 * N // 2
                     + 12 * 64, 2 * 64 * 16 * N, INT8_OPS), None, False,
           generic_ms=median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*targs, route="generic"),
                                flush=flush))


def attend_kernels(eng, gen, flush, record):
    """K4 and K5 against their plain versions at the full-width decode
    shapes (B = slots, Hkv, G, Dh of the model, Sp of path A's cache),
    K5 with wo's prologue in bf16, as the main path runs it."""
    import torch
    from repro_torch.kernels import kv_cache as kv
    cfg = eng.cfg
    B, Hkv, Dh = eng.slots, cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // Hkv
    Sp = eng.caches["blocks"][0]["k"].shape[3]
    need(len(ATTEND_LENS) == B and max(ATTEND_LENS) <= Sp,
         f"attend lengths {ATTEND_LENS} do not fit B {B}, Sp {Sp}")
    dev = eng.device
    i8 = dict(dtype=torch.int8, device=dev, generator=gen)
    f = lambda *s: torch.rand(s, generator=gen, device=dev)      # noqa: E731
    args = (torch.randn((B, Hkv * G, Dh), generator=gen, device=dev),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
            torch.randint(-127, 128, (B, Hkv, Sp, Dh), **i8),
            0.01 + 0.04 * f(B, Hkv, Sp), 0.01 + 0.04 * f(B, Hkv, Sp),
            torch.tensor(ATTEND_LENS, dtype=torch.int32, device=dev))
    shape = (f"B {B} Hkv {Hkv} G {G} Dh {Dh} Sp {Sp}, lengths "
             f"{list(ATTEND_LENS)}")
    valid = sum(ATTEND_LENS) * Hkv
    qo_bytes = 2 * B * Hkv * G * Dh * 4 + 4 * B        # q in, o out, length
    kv_bytes = valid * (2 * Dh + 8)                    # valid K/V rows + scales
    ops = valid * 4 * G * Dh                           # q.k and p.v, f32

    ko = kv.decode_attend_i8kv_cuda(*args)
    po = kv.decode_attend_i8kv_plain(*args)
    need(bool(torch.isclose(ko, po, rtol=ATTEND_TOL, atol=ATTEND_TOL).all()),
         "K4 o outside tolerance of plain")
    b_ms, b_by = bound_ms(kv_bytes + qo_bytes, ops, F32_OPS)
    record("decode_attend_i8kv", shape, max_abs(ko, po),
           median_ms(lambda: kv.decode_attend_i8kv_cuda(*args), flush=flush),
           median_ms(lambda: kv.decode_attend_i8kv_plain(*args), flush=flush),
           b_ms, b_by, None, True)

    pro = torch.bfloat16
    ko = kv.decode_attend_i8kv_fused_cuda(*args, pro)
    po = kv.decode_attend_i8kv_fused_plain(*args, pro)
    need(bool(torch.isclose(ko[0], po[0], rtol=ATTEND_TOL, atol=ATTEND_TOL).all()),
         "K5 o outside tolerance of plain")
    need(bool(torch.isclose(ko[2], po[2], rtol=1e-5, atol=0).all()),
         "K5 s_x outside rtol 1e-5 of plain")
    kf, pf = (t.reshape(B, -1).to(pro) for t in (ko[0], po[0]))
    same = (kf == pf) & (ko[2] == po[2])
    dq = (ko[1].int() - po[1].int()).abs()
    need(bool((dq[same] == 0).all()) and int(dq.max()) <= 1,
         "K5 o_q differs from plain where o and s_x agree, or by > 1 code")
    absx = pf.float().abs().sum(-1, keepdim=True)
    need(bool(((ko[3] - po[3]).abs() <= SUM_RTOL * absx).all()), "K5 s1 outside tolerance")
    need(bool(((ko[4] - po[4]).abs() <= SUM_RTOL * po[4]).all()), "K5 s2 outside tolerance")
    b_ms, b_by = bound_ms(kv_bytes + qo_bytes + B * Hkv * G * Dh + 12 * B, ops, F32_OPS)
    record("decode_attend_i8kv_fused", f"{shape}, prologue in bf16; o_q code "
           f"mismatches {int((dq > 0).sum())}",
           max(max_abs(u, v) for u, v in zip(ko, po)),
           median_ms(lambda: kv.decode_attend_i8kv_fused_cuda(*args, pro), flush=flush),
           median_ms(lambda: kv.decode_attend_i8kv_fused_plain(*args, pro), flush=flush),
           b_ms, b_by, None, True)


def page_kernels(eng, gen, flush, record):
    """K7 against its plain version (the reference's composition through
    page rows) on path D's full-width leaves: the int8 K leaf's decode
    gather (pool (n, 65, Hkv, 64, Dh) -> logical (n, 8, Hkv, 512, Dh)
    scratch, frontiers ragged, -1 past them), its write-back (one page per
    row, two free slots both on the dump page 0), the COW copy (the pool
    onto itself, disjoint pages) and the f32 scale leaf's gather.  Bit-equal;
    the library call is ``index_copy_`` on the page axis from page rows
    already selected and laid out."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ref
    cfg, dev = eng.cfg, eng.device
    n, B, Hkv, Dh = cfg.n_layers, eng.slots, cfg.n_kv_heads, cfg.hd
    n_pp = eng.max_len // PAGE
    Sp = eng.max_len + (-eng.max_len) % 128
    n_leaf, N = Sp // PAGE, B * n_pp + 1
    lens = np.asarray(ATTEND_LENS)
    pt = np.full((B, n_pp), -1, np.int32)
    for b, L in enumerate(lens):          # slot b owns up to its frontier page
        k = min(L // PAGE + 1, n_pp)
        pt[b, :k] = 1 + b * n_pp + np.arange(k)
    gmap = np.full((B, n_leaf), -1, np.int32)
    gmap[:, :n_pp] = np.where(np.arange(n_pp)[None] * PAGE < lens[:, None], pt, -1)
    gmap = gmap.reshape(B * n_leaf)
    wpt = pt.copy()
    wpt[B - 2:] = -1                      # two free slots
    j = np.clip(lens // PAGE, 0, n_pp - 1)
    ent = wpt[np.arange(B), j]
    wmap = np.full((N,), -1, np.int32)
    wmap[np.where(ent > 0, ent, 0)] = np.arange(B) * n_leaf + j
    cmap = np.full((N,), -1, np.int32)
    cmap[N - 8:] = np.arange(1, 9)        # 8 fresh pages take 8 others

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=dtype)
        return torch.rand(shape, generator=gen, device=dev)

    def bits(t):
        return t.view(torch.uint8)

    leaves = {"k": ((n, B, Hkv, Sp, Dh), (n, N, Hkv, PAGE, Dh), torch.int8),
              "k_scale": ((n, B, Hkv, Sp), (n, N, Hkv, PAGE), torch.float32)}
    cases = (("k", "gather", gmap, True), ("k", "write-back", wmap, False),
             ("k", "copy", cmap, False), ("k_scale", "gather", gmap, False))
    for name, how, m_np, primary in cases:
        lshape, pshape, dtype = leaves[name]
        logical, pool = rand(lshape, dtype), rand(pshape, dtype)
        m = torch.as_tensor(m_np, device=dev)
        if how == "gather":
            dst, src, sa = logical, pool, 3
        elif how == "write-back":
            dst, src, sa = pool, logical, 3
        else:
            dst, src, sa = pool, None, None

        def run_kernel(d, s=src, m=m, sa=sa):
            return kv.cache_scatter_pages_cuda(d, d if s is None else s, m, sa, PAGE, 1,
                                               host_map=m_np if s is None else None)

        def run_plain(d, s=src, m=m, sa=sa):
            return kv.cache_scatter_pages_plain(d, d if s is None else s, m, sa, PAGE, 1)

        got, want = run_kernel(dst.clone()), run_plain(dst.clone())
        need(torch.equal(bits(got), bits(want)), f"K7 {name} {how} differs from plain")
        err = max_abs(got, want)
        del got, want
        moved = int((m_np >= 0).sum()) * n
        row_bytes = kv.page_side(pool, None, None, 1)[2]
        b_ms, b_by = bound_ms(2 * moved * row_bytes + 4 * m_np.size, 0, INT8_OPS)
        # the library call: index_copy_ on the page axis, from the page rows
        # already selected and laid out as the destination's page rows
        d_rows = torch.nonzero(m >= 0).flatten()
        s_rows = m[d_rows].long()
        s_pr = (ref.to_page_rows(src, sa, PAGE, batch_axis=1) if how == "write-back"
                else pool)
        sel = s_pr.index_select(1, s_rows)
        d_pr = (ref.to_page_rows(dst, sa, PAGE, batch_axis=1).contiguous()
                if how == "gather" else dst.clone())
        dk, dp = dst.clone(), dst.clone()
        src_shape = tuple((pool if src is None else src).shape)
        record("cache_scatter_pages",
               f"{name} {how}: {tuple(dst.shape)} <- {src_shape} {dtype}, "
               f"{moved} page rows of {row_bytes} B moved",
               err, median_ms(lambda: run_kernel(dk), flush=flush),
               median_ms(lambda: run_plain(dp), flush=flush), b_ms, b_by,
               median_ms(lambda: d_pr.index_copy_(1, d_rows, sel), flush=flush), primary)
        del logical, pool, dst, src, dk, dp, d_pr, sel, s_pr
        torch.cuda.empty_cache()


def quant_kernels(eng, gen, flush, record):
    """K8, K9 and K10 against their plain versions at path E's shapes (8
    and 2048 rows of d_model): K8 on f32 (what the unfused projection
    gives it) and bf16 and on the sampling stride's rows, within SUM_RTOL
    and bit-equal over two launches; K9 and K10 per row and per channel,
    f32 and bf16, and at ragged shapes with x on .5 ties, codes and bits
    equal.  Library calls, timed on f32 and not used by the port:
    torch.quantize_per_channel for K9 and torch.dequantize of the same
    codes for K10; none for K8, as no single PyTorch call returns both
    sums."""
    import torch
    from repro_torch.kernels import act_stats as st
    from repro_torch.kernels import quantize as qz
    dev, d = eng.device, eng.cfg.d_model

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x_pre = randn(2048, d)
    strided = randn(8, 2048 // 8, d).to(torch.bfloat16)[:, ::E_GAMMA]
    for xm, primary in ((randn(8, d), False), (x_pre, True),
                        (randn(8, d).to(torch.bfloat16), False),
                        (x_pre.to(torch.bfloat16), False), (strided, False)):
        k, p = st.act_stats_cuda(xm), st.act_stats_plain(xm)
        again = st.act_stats_cuda(xm)
        need(torch.equal(k[0], again[0]) and torch.equal(k[1], again[1]),
             "K8: two launches on one input differ")
        absx = xm.float().abs().sum(-1)
        need(bool(((k[0] - p[0]).abs() <= SUM_RTOL * absx).all()), "K8 s1 outside tolerance")
        need(bool(((k[1] - p[1]).abs() <= SUM_RTOL * p[1]).all()), "K8 s2 outside tolerance")
        rows, K = xm[..., 0].numel(), xm.shape[-1]
        b_ms, b_by = bound_ms(rows * K * xm.element_size() + 8 * rows, 3 * rows * K, F32_OPS)
        record("act_stats", f"x {tuple(xm.shape)} {str(xm.dtype)[6:]}"
               + (f" = x[:, ::{E_GAMMA}] in place" if xm.dim() == 3 else ""),
               max(max_abs(a, b) for a, b in zip(k, p)),
               median_ms(lambda: st.act_stats_cuda(xm), flush=flush),
               median_ms(lambda: st.act_stats_plain(xm), flush=flush), b_ms, b_by, None,
               primary)

    def affine(M, N, per_channel, ties):
        """Scales in [0.001, 0.3], powers of two on every other row or
        channel (x / s then exact), zero points in [-40, 40); x on .5 ties
        of the grid, or normal with some codes past the int8 range."""
        n = N if per_channel else M
        s = 0.001 + 0.299 * torch.rand((n,), generator=gen, device=dev)
        pow2 = 2.0 ** -torch.randint(1, 9, (n,), generator=gen, device=dev).float()
        s = torch.where(torch.arange(n, device=dev) % 2 == 0, pow2, s)
        z = torch.randint(-40, 40, (n,), generator=gen, device=dev, dtype=torch.int32)
        shape = (1, N) if per_channel else (M, 1)
        s, z = s.reshape(shape).contiguous(), z.reshape(shape).contiguous()
        if ties:
            k = torch.randint(-140, 140, (M, N), generator=gen, device=dev).float()
            return (k + 0.5) * s, s, z
        return 60 * randn(M, N) * s, s, z

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def library(fn):
        return fn(), median_ms(fn, flush=flush)

    # (M, N, per channel, dtype, .5 ties, timed, primary)
    cases = [(2048, d, False, torch.float32, False, True, True),
             (2048, d, True, torch.float32, False, True, False),
             (8, d, False, torch.float32, False, True, False),
             (2048, d, False, torch.bfloat16, False, True, False),
             (300, 290, False, torch.float32, True, False, False),
             (300, 290, True, torch.bfloat16, True, False, False),
             (2048, 2049, False, torch.bfloat16, True, False, False),
             (2048, 2049, True, torch.float32, True, False, False)]
    for M, N, pc, dtype, ties, timed, primary in cases:
        x, s, z = affine(M, N, pc, ties)
        x = x.to(dtype)
        how = f"({M}, {N}) {str(dtype)[6:]} per {'channel' if pc else 'row'}"
        kq, pq = qz.quantize_cuda(x, s, z), qz.quantize_plain(x, s, z)
        need(torch.equal(kq, pq), f"K9 {how}: codes differ from plain")
        q = torch.randint(-128, 128, (M, N), generator=gen, device=dev, dtype=torch.int8)
        for out_dtype in (torch.float32, torch.bfloat16):
            need(torch.equal(bits(qz.dequantize_cuda(q, s, z, out_dtype)),
                             bits(qz.dequantize_plain(q, s, z, out_dtype))),
                 f"K10 {how} -> {out_dtype}: bits differ from plain")
        if not timed:
            log(f"kernel quantize/dequantize {how}{', .5 ties' if ties else ''}: "
                f"equal to plain")
            continue
        n = N if pc else M
        axis = 1 if pc else 0
        sd, zl = s.reshape(n).double(), z.reshape(n).long()
        lib_q, lib_ms = (None, None)
        if dtype == torch.float32:
            lib_q, lib_ms = library(lambda: torch.quantize_per_channel(x, sd, zl, axis,
                                                                       torch.qint8))
        lib_note = ("" if lib_q is None else
                    f"; library codes differ in {int((lib_q.int_repr() != kq).sum())}")
        b_ms, b_by = bound_ms(M * N * (x.element_size() + 1) + 8 * n, 4 * M * N, F32_OPS)
        record("quantize", f"x {how} -> int8{lib_note}", max_abs(kq, pq),
               median_ms(lambda: qz.quantize_cuda(x, s, z), flush=flush),
               median_ms(lambda: qz.quantize_plain(x, s, z), flush=flush), b_ms, b_by,
               lib_ms, primary)
        out_dtype = dtype                  # K10 back to the type K9 was given
        ky = qz.dequantize_cuda(q, s, z, out_dtype)
        py = qz.dequantize_plain(q, s, z, out_dtype)
        lib_y, lib_ms = (None, None)
        if out_dtype == torch.float32:
            qt = torch._make_per_channel_quantized_tensor(q, sd, zl, axis)
            lib_y, lib_ms = library(lambda: torch.dequantize(qt))
        lib_note = ("" if lib_y is None else
                    f"; library values differ in {int((lib_y != ky).sum())}")
        b_ms, b_by = bound_ms(M * N * (1 + ky.element_size()) + 8 * n, 2 * M * N, F32_OPS)
        record("dequantize", f"q ({M}, {N}) per {'channel' if pc else 'row'} -> "
               f"{str(out_dtype)[6:]}{lib_note}", max_abs(ky, py),
               median_ms(lambda: qz.dequantize_cuda(q, s, z, out_dtype), flush=flush),
               median_ms(lambda: qz.dequantize_plain(q, s, z, out_dtype), flush=flush),
               b_ms, b_by, lib_ms, primary)


def make_requests(cfg, n=8, seed=0):
    """``n`` requests of 32 new tokens; prompts of 20-250 tokens, except
    that requests 0 and 1 are one seeded 128-token system prompt followed
    by their own prompts cut to 120 tokens (two full 64-token pages shared,
    both in the 256 bucket, so admitted in one round)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 251, size=n)
    prompts = [rng.integers(0, cfg.vocab, size=int(L)).astype(np.int32) for L in lens]
    system = np.random.default_rng(seed + 1).integers(0, cfg.vocab, size=128)
    for i in range(min(n, 2)):
        prompts[i] = np.concatenate([system, prompts[i][:120]]).astype(np.int32)
    return [Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)]


def census(path, n, pre, dec, restores=0):
    """Op entries a serving run of ``path`` makes with ``n`` layers, ``pre``
    prefill launches, ``dec`` decode steps and ``restores`` spill restores.
    Per layer: prefill runs the prologue 3x, W8A8 3x and SwiGLU once with
    PDQ weights; a decode step the same, except that with int8 KV and PDQ
    the fused attend (once) takes the place of wo's prologue (7 launches:
    tools/check_census.py's decode_int8kv).  A slot-row pool lands each
    cache leaf once a round (6 leaves with int8 KV, else 4).  A paged pool
    moves its 5 paged leaves (k, v, k_scale, v_scale, pos) with K7 and the
    flat ``len`` with K6: a round lands 5 + 1, a decode step gathers and
    writes back 10, a restore scatters 5 + 1."""
    int8_kv, pdq, _, paging = PATHS[path]
    want = dict(pdq_prologue=0, w8a8_matmul=0, w8a8_swiglu_matmul=0,
                decode_attend_i8kv=0, decode_attend_i8kv_fused=0,
                cache_scatter=(6 if int8_kv else 4) * pre, cache_scatter_pages=0,
                act_stats=0, quantize=0, dequantize=0)
    if paging:
        want.update(cache_scatter=pre + restores,
                    cache_scatter_pages=5 * pre + 10 * dec + 5 * restores)
    if pdq:
        want.update(pdq_prologue=n * (3 * pre + (2 if int8_kv else 3) * dec),
                    w8a8_matmul=3 * n * (pre + dec), w8a8_swiglu_matmul=n * (pre + dec))
    if int8_kv:
        want["decode_attend_i8kv_fused" if pdq else "decode_attend_i8kv"] = n * dec
    return want


def check_routes(path, counts):
    """Every K2 and K3 launch of a run took the wgmma route."""
    from repro_torch.kernels import ops
    routes = ops.route_counts()
    log(f"{path}: K2/K3 launches per route {routes}")
    for name, r in routes.items():
        need(r["generic"] == 0 and r["wgmma"] == counts[name]["launches"],
             f"{path}: {name} launches {counts[name]['launches']}, per route {r}")


def phase_serve(eng, path):
    import torch
    from repro_torch.kernels import ops
    reqs = make_requests(eng.cfg)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    log(f"serve {path}: {len(reqs)} requests in {wall:.2f} s; counts {counts}")
    check_routes(path, counts)
    log(f"serve {path}: stats {json.dumps(eng.stats)}")
    for name, c in counts.items():
        need(c["launches"] == c["entries"],
             f"{path}: {name}: {c['entries']} op entries but {c['launches']} launches")
        need((c["launches"] > 0) == (name in PATHS[path][2]),
             f"{path}: {name} launched {c['launches']} times")
    st = eng.stats
    want = census(path, eng.cfg.n_layers, st["prefill_batches"], st["decode_steps"],
                  st.get("spill_restores", 0))
    got = {k: c["entries"] for k, c in counts.items()}
    need(got == want, f"{path}: op entries {got}, census {want}")
    need(st["completed"] == len(reqs) and st["failed"] == 0,
         f"not every request completed: {st}")
    if PATHS[path][3]:
        # COW copies would move pages outside the census; none is expected
        # (only full prompt pages are shared)
        need(st["cow_copies"] == 0, f"{path}: {st['cow_copies']} COW copies")
        need(st["spills"] == st["preemptions"] and not eng.failures.count("spill"),
             f"{path}: a spill failed: {st}, {list(eng.failures.events)}")
    for r in reqs:
        need(r.done and r.error is None and len(r.generated) == r.max_new,
             f"request {r.uid}: {len(r.generated)} tokens, error {r.error}")
        need(all(0 <= tok < eng.cfg.vocab for tok in r.generated),
             f"request {r.uid}: token out of range")
    dec = [dt for dt, _ in eng.straggler.history]
    pre = [dt for dt, _ in eng.prefill_straggler.history]
    decode_tps = eng.stats["decode_tokens"] / sum(dec)
    steps = sorted(dec)
    log(f"serve {path}: prefill launches {len(pre)} total {sum(pre):.3f} s "
        f"({eng.stats['prefill_tokens']} prompt tokens, "
        f"{eng.stats['prefill_padded_tokens']} padded); decode steps "
        f"{len(dec)} median {steps[len(steps) // 2] * 1e3:.2f} ms, "
        f"{decode_tps:.1f} tokens/s over {eng.stats['decode_tokens']} tokens")
    return counts, dict(wall_s=wall, prefill_s=sum(pre), prefill_launches=len(pre),
                        decode_step_median_ms=steps[len(steps) // 2] * 1e3,
                        decode_tokens_per_s=decode_tps, stats=eng.stats,
                        streams={r.uid: list(r.generated) for r in reqs})


def device_rows(prof, per):
    """(ms, kernel, launches) per ``per`` runs of every device row of a
    torch.profiler trace, longest first."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / per / 1e3, ev.key, ev.count // per))
    rows.sort(reverse=True)
    return rows


def phase_profile(eng, path, step_ms, steps=3):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of the full pool at position 300 (on a paged pool: the
    gather, the step and the write-back, every slot holding pages up to
    its frontier).  Device busy time per step is the sum of the CUDA
    kernels' time; the idle share compares it with the serve phase's
    unprofiled median step (``step_ms``), since the profiler itself slows
    the host.  Reports null device numbers if the profiler records no
    kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    B = eng.slots
    tok = torch.zeros((B, 1), dtype=torch.int32, device=eng.device)
    pos = torch.full((B, 1), 300, dtype=torch.int32, device=eng.device)
    if eng.paged:
        po, n_pp = eng._paged_ops, eng.n_pp
        pt = (1 + np.arange(B * n_pp, dtype=np.int32)).reshape(B, n_pp)
        pos_np = np.full((B, 1), 300, np.int32)

        def step():
            logical = po.gather(eng.caches, pt, pos_np[:, 0])
            eng.bundle.decode_step(eng.params, logical, tok, pos)
            po.writeback(eng.caches, logical, pt, pos_np)
    else:
        def step():
            eng.bundle.decode_step(eng.params, eng.caches, tok, pos)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_rows(prof, steps)
    busy_ms = sum(r[0] for r in rows)
    top = [dict(kernel=k[:70], ms=ms, launches=n) for ms, k, n in rows[:10]]
    out = dict(step_ms=step_ms, step_ms_under_profiler=wall_ms,
               kernels_per_step=sum(r[2] for r in rows),
               device_busy_ms=busy_ms if rows else None,
               device_idle_share=(1 - busy_ms / step_ms) if rows else None,
               top_kernels=top)
    log(f"profile {path}: {json.dumps(out)}")
    # every device row (kernels and copies), for chiprun_out/chip_smoke.json
    out["all_device_rows"] = [dict(kernel=k[:120], ms=ms, launches=n) for ms, k, n in rows]
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions for CUDA tensors
    (this script's reference run only; the package never does this)."""
    from repro_torch.kernels import act_stats as st
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import pdq_prologue as pro
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import w8a8_matmul as mm
    swaps = [(pro, "pdq_prologue_cuda", pro.pdq_prologue_plain),
             (st, "act_stats_cuda", st.act_stats_plain),
             (qz, "quantize_cuda", qz.quantize_plain),
             (qz, "dequantize_cuda", qz.dequantize_plain),
             (mm, "w8a8_matmul_cuda", mm.w8a8_matmul_plain),
             (mm, "w8a8_swiglu_matmul_cuda", mm.w8a8_swiglu_matmul_plain),
             (kv, "decode_attend_i8kv_cuda", kv.decode_attend_i8kv_plain),
             (kv, "decode_attend_i8kv_fused_cuda", kv.decode_attend_i8kv_fused_plain),
             (kv, "cache_scatter_cuda", kv.cache_scatter_plain),
             (kv, "cache_scatter_pages_cuda", kv.cache_scatter_pages_plain)]
    saved = [getattr(m, a) for m, a, _ in swaps]
    try:
        for m, a, f in swaps:
            setattr(m, a, f)
        yield
    finally:
        for (m, a, _), f in zip(swaps, saved):
            setattr(m, a, f)


def phase_parity(eng, path, n_tokens=8):
    import torch
    bundle, params = eng.bundle, eng.params
    prompt = make_requests(eng.cfg, n=1, seed=7)[0].prompt
    L = len(prompt)
    tokens = torch.as_tensor(prompt, device=eng.device)[None]

    def run(teacher=None):
        caches = bundle.init_caches(1, 64 + L)
        logits, caches = bundle.prefill_many(
            params, {"tokens": tokens}, caches,
            torch.tensor([L], dtype=torch.int32, device=eng.device))
        out, toks = [logits[0].float()], []
        for i in range(n_tokens - 1):
            tok = int(out[-1].argmax()) if teacher is None else teacher[i]
            toks.append(tok)
            logits, caches = bundle.decode_step(
                params, caches,
                torch.tensor([[tok]], dtype=torch.int32, device=eng.device),
                torch.tensor([[L + i]], dtype=torch.int32, device=eng.device))
            out.append(logits[0].float())
        toks.append(int(out[-1].argmax()) if teacher is None else -1)
        return out, toks

    k_logits, k_toks = run()
    with plain_kernels():
        p_logits, _ = run(teacher=k_toks)
    tol = LOGIT_TOL[path]
    diffs = []
    for i, (kl, pl) in enumerate(zip(k_logits, p_logits)):
        d = float((kl - pl).abs().max())
        diffs.append(d)
        need(torch.isfinite(kl).all(), f"parity {path} step {i}: non-finite logits")
        need(d <= tol, f"parity {path} step {i}: logits differ by {d} > {tol}")
        if int(kl.argmax()) != int(pl.argmax()):
            top2 = pl.topk(2).values
            margin = float(top2[0] - top2[1])
            need(margin < tol, f"parity {path} step {i}: argmax differs "
                 f"with plain top-2 margin {margin}")
            log(f"parity {path} step {i}: argmax differs inside the margin "
                f"({margin:.4g})")
    log(f"parity {path}: {n_tokens} greedy tokens {k_toks}; max |logits diff| "
        f"per step {diffs} (tolerance {tol}); max |logit| "
        f"{float(max(kl.abs().max() for kl in k_logits)):.4g}")
    return max(diffs)


def e_records(eng):
    """Path E's weight records, from path A's engine: layer 0's Q segment
    of the grouped QKV (2048 x 2048), wo (2048 x 2048) and w_down (5632 x
    2048)."""
    from repro_torch.models import linops
    p0 = eng.params["blocks"][0]
    return {"q": linops.segment_record(p0["attn"]["wq"]), "wo": p0["attn"]["wo"],
            "w_down": p0["ffn"]["w_down"]}


def phase_unfused(recs):
    """Path E: the ops-level quantization entry points on path A's records
    at E_ROWS rows of seeded bf16 activations.  The drive - per (projection,
    rows) the unfused projection, act_stats of the same rows (the moments
    its grid was priced from), quantize and dequantize of its output on
    that grid, the fused projection, and on the prefill rows act_stats with
    the sampling stride - runs between zeroing and reading the counts, and
    each unfused call alone must enter and launch K8 and K2 once and
    nothing else.  Then, outside the census, the checks, the timings and
    a profile of three unfused calls per case, and last the CPU runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    dev = recs["wo"]["q"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    cases = [(name, rec, torch.randn((M, rec["q"].shape[0]), generator=gen,
                                     device=dev).to(torch.bfloat16))
             for name, rec in recs.items() for M in E_ROWS]
    torch.cuda.synchronize()
    ops.reset_counts()
    runs = []
    for name, rec, x in cases:
        before = ops.counts()
        y, s_out = ops.pdq_dense_unfused(x, rec)
        after = ops.counts()
        one = {k: (after[k]["entries"] - before[k]["entries"],
                   after[k]["launches"] - before[k]["launches"]) for k in after}
        need(one == {k: (1, 1) if k in ("act_stats", "w8a8_matmul") else (0, 0)
                     for k in after},
             f"E {name} ({len(x)} rows): one unfused call made {one}")
        s1, s2 = ops.act_stats(x.float())
        _, _, s_out2, z_out = ops.pdq_interval(rec, s1[..., None], s2[..., None])
        y_q = ops.quantize(y, s_out, z_out)
        runs.append(dict(name=name, rec=rec, x=x, y=y, s_out=s_out, s_out2=s_out2,
                         y_back=ops.dequantize(y_q, s_out, z_out),
                         y_fused=ops.pdq_dense(x, rec, out="fp"),
                         gamma=(ops.act_stats(x.reshape(8, -1, x.shape[-1]), gamma=E_GAMMA)
                                if len(x) > 8 else None)))
    torch.cuda.synchronize()
    counts = ops.counts()
    n, n_gamma = len(runs), sum(r["gamma"] is not None for r in runs)
    want = dict.fromkeys(counts, 0)
    want.update(act_stats=2 * n + n_gamma, w8a8_matmul=2 * n, pdq_prologue=n,
                quantize=n, dequantize=n)
    log(f"unfused E: counts {counts}")
    check_routes("E", counts)
    for name, c in counts.items():
        need(c["launches"] == c["entries"] == want[name],
             f"E: {name}: {c['entries']} entries, {c['launches']} launches, census "
             f"{want[name]}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for r in runs:
        rec, x, y, s_out = r["rec"], r["x"], r["y"], r["s_out"]
        (M, K), N = x.shape, y.shape[-1]
        r["label"] = label = f"E {r['name']} ({M}, {K}) @ ({K}, {N})"
        need(tuple(y.shape) == (M, N) and bool(torch.isfinite(y).all()),
             f"{label}: y {tuple(y.shape)} not finite")
        need(torch.equal(r["s_out2"], s_out),
             f"{label}: two K8 launches on the same rows priced two grids")
        need(torch.equal(r["y_back"], y),
             f"{label}: dequantize(quantize(y)) on y's own grid is not y")
        # fused against unfused: the reference's contract, one step a row
        df = (r["y_fused"] - y).abs()
        need(bool((df <= s_out + 1e-6).all()),
             f"{label}: fused and unfused differ by {float((df / s_out).max())} steps")
        # ~30 small launches a call: a ~10 ms spin lets the host enqueue them all
        t_unfused = median_ms(lambda: ops.pdq_dense_unfused(x, rec), flush=flush,
                              spin=E_SPIN)
        t_fused = median_ms(lambda: ops.pdq_dense(x, rec, out="fp"), flush=flush,
                            spin=E_SPIN)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(E_PROFILED):
                ops.pdq_dense_unfused(x, rec)
            torch.cuda.synchronize()
        prof_rows = device_rows(prof, E_PROFILED)
        rows.append(dict(projection=r["name"], M=M, K=K, N=N, fused_ms=t_fused,
                         unfused_ms=t_unfused, unfused_over_fused=t_unfused / t_fused,
                         fused_minus_unfused_steps=float((df / s_out).max()),
                         unfused_device_ms=(sum(p[0] for p in prof_rows)
                                            if prof_rows else None),
                         unfused_device_kernels=sum(p[2] for p in prof_rows),
                         unfused_kernels=[dict(kernel=k[:70], ms=ms, launches=c)
                                          for ms, k, c in prof_rows]))
    # the same function on CPU copies takes the plain versions (after every
    # timing, so that no CPU work shares the host with one): s_out is priced
    # from sums taken in another order (SUM_RTOL), which can move a code at
    # a tie, so y within one step
    for r, row in zip(runs, rows):
        rec, x, y, s_out, label = r["rec"], r["x"], r["y"], r["s_out"], r["label"]
        M, K = x.shape
        rec_c = {k: v.cpu() if torch.is_tensor(v) else v for k, v in rec.items()}
        y_c, s_c = ops.pdq_dense_unfused(x.cpu(), rec_c)
        need(bool(((s_out.cpu() - s_c).abs() <= SUM_RTOL * s_c).all()),
             f"{label}: s_out differs from the CPU run beyond {SUM_RTOL}")
        dy = (y.cpu() - y_c).abs()
        row["cpu_minus_card_steps"] = cpu_steps = float((dy / s_c).max())
        need(bool((dy <= s_c * (1 + SUM_RTOL) + 1e-6).all()),
             f"{label}: y {cpu_steps} steps from the CPU run")
        if r["gamma"] is not None:
            g1, g2 = r["gamma"]
            c1, c2 = ops.act_stats(x.cpu().reshape(8, -1, K), gamma=E_GAMMA)
            xs = x.cpu().reshape(8, -1, K)[:, ::E_GAMMA].float()
            need(tuple(g1.shape) == (8, M // 8 // E_GAMMA)
                 and bool(((g1.cpu() - c1).abs() <= SUM_RTOL * xs.abs().sum(-1)).all())
                 and bool(((g2.cpu() - c2).abs() <= SUM_RTOL * c2).all()),
                 f"{label}: act_stats with gamma {E_GAMMA} differs from the CPU run")
        log(f"unfused {label}: fused {row['fused_ms']:.4f} ms, unfused "
            f"{row['unfused_ms']:.4f} ms (x{row['unfused_over_fused']:.3f}); |fused - "
            f"unfused| <= {row['fused_minus_unfused_steps']:.3f} steps, card vs CPU <= "
            f"{cpu_steps:.3f} steps; profiled unfused call: "
            f"{row['unfused_device_kernels']} device kernels, "
            f"{row['unfused_device_ms']} ms busy")
    return counts, rows


def check_paged_run(path, run, ref_run):
    """D1/D2 against A's first run: the same greedy streams, request for
    request (prefill runs at (slots, bucket) whatever the pool, and every
    decode op is row-independent, so the pool's layout must not move a
    token); D1 shares the system prompt's pages, D2 preempts, spills every
    victim to host memory and restores it."""
    st = run["stats"]
    for uid, toks in ref_run["streams"].items():
        need(run["streams"][uid] == toks,
             f"{path}: request {uid} stream {run['streams'][uid]} differs from A's {toks}")
    need(st["prefix_hits"] >= 1, f"{path}: no prefix hit: {st}")
    if path == "D2":
        need(st["preemptions"] >= 1 and st["spill_restores"] >= 1,
             f"D2: pool of {D2_POOL_PAGES} pages did not preempt and restore: {st}")
    log(f"serve {path}: streams equal A's; prefix hits {st['prefix_hits']} "
        f"({st['prefix_shared_pages']} pages), preemptions {st['preemptions']}, "
        f"spills {st['spills']}, restores {st['spill_restores']}")


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeError("src/repro_torch is missing: run from a checkout "
                         "of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    cfg = get_config("stablelm-1.6b")
    params = build_model(cfg, "cuda").init(0)

    def engine(path):
        int8_kv, pdq, _, paging = PATHS[path]
        t0 = time.perf_counter()
        eng = build_engine(ServeConfig(arch="stablelm-1.6b", reduced=False, slots=8,
                                       max_len=512, int8_kv=int8_kv,
                                       quantize_weights=pdq, device="cuda", **paging),
                           cfg=cfg, params=params)
        torch.cuda.synchronize()
        log(f"model {path}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
            f"{cfg.dtype}, {'PDQ-int8' if pdq else 'bf16'} weights, "
            f"{'int8' if int8_kv else 'bf16'} KV cache, "
            f"{f'paged pool of {eng.pool_pages} pages of {PAGE}' if eng.paged else 'slot rows'}, "
            f"built in {time.perf_counter() - t0:.1f} s")
        return eng

    # A and C serve twice, in turns A (B) C C A, so that their end-to-end
    # times compare within this call whatever the host's warm-up costs; then
    # the paged pool at parity (D1) and under pressure (D2)
    serve, counts, parity = {}, {}, {}
    for path in ("A", "B", "C", "C", "A", "D1", "D2"):
        eng = engine(path)
        if path == "A" and not serve:
            rows, detail = phase_kernels(eng)
            recs = e_records(eng)
        c, run = phase_serve(eng, path)
        if path not in counts:
            counts[path] = c
            if path in ("A", "C", "D1"):
                run["profile"] = phase_profile(eng, path, run["decode_step_median_ms"])
            if path in ("A", "B", "C"):
                parity[path] = phase_parity(eng, path)
        if path in ("D1", "D2"):
            check_paged_run(path, run, serve["A"][0])
        serve.setdefault(path, []).append(run)
        del eng
        torch.cuda.empty_cache()
    for path, runs in serve.items():
        log(f"serve {path}: decode step median per run "
            f"{[r['decode_step_median_ms'] for r in runs]} ms, prefill per run "
            f"{[r['prefill_s'] for r in runs]} s")
    # path E: the unfused projection and the standalone quantization ops
    counts["E"], unfused = phase_unfused(recs)
    del recs

    replaces = {
        "act_stats": "src/repro/kernels/act_stats.py:33",
        "quantize": "src/repro/kernels/quantize.py:31",
        "dequantize": "src/repro/kernels/quantize.py:51",
        "cache_scatter_pages": "src/repro/kernels/kv_cache.py:291",
        "pdq_prologue": "src/repro/kernels/pdq_prologue.py:56",
        "w8a8_matmul": "src/repro/kernels/w8a8_matmul.py:72",
        "w8a8_swiglu_matmul": "src/repro/kernels/w8a8_matmul.py:200",
        "decode_attend_i8kv": "src/repro/kernels/kv_cache.py:62",
        "decode_attend_i8kv_fused": "src/repro/kernels/kv_cache.py:161",
        "cache_scatter": "src/repro/kernels/kv_cache.py:246",
    }
    sources = {
        "act_stats": "src/repro_torch/csrc/act_stats.cu",
        "quantize": "src/repro_torch/csrc/quantize.cu",
        "dequantize": "src/repro_torch/csrc/quantize.cu",
        "cache_scatter_pages": "src/repro_torch/csrc/kv_cache.cu",
        "pdq_prologue": "src/repro_torch/csrc/pdq_prologue.cu",
        "w8a8_matmul": "src/repro_torch/csrc/w8a8_matmul.cu",
        "w8a8_swiglu_matmul": "src/repro_torch/csrc/w8a8_matmul.cu",
        "decode_attend_i8kv": "src/repro_torch/csrc/decode_attend.cu",
        "decode_attend_i8kv_fused": "src/repro_torch/csrc/decode_attend.cu",
        "cache_scatter": "src/repro_torch/csrc/kv_cache.cu",
    }
    kernels = []
    path_of = {"decode_attend_i8kv": "B", "cache_scatter_pages": "D", "act_stats": "E",
               "quantize": "E", "dequantize": "E"}
    for name, row in rows.items():
        path = path_of.get(name, "A")
        c = counts["D1" if path == "D" else path][name]      # D: D1's run
        kernels.append(dict(name=name, route="cuda", source=sources[name],
                            replaces=replaces[name], path=path,
                            launches=c["launches"], entries=c["entries"],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"], shape=row["shape"],
                            **{k: v for k, v in row.items() if k in EXTRA_KEYS}))
    need(sorted(k["name"] for k in kernels) == sorted(replaces),
         f"kernel rows {[k['name'] for k in kernels]}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             kernels=kernels, kernel_shapes=detail, serve=serve,
             parity_max_logit_diff=parity, unfused=unfused), indent=1))
    log(json.dumps({"kernel_shapes": detail}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # every phase failure ends the run without a result
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        raise SystemExit(1) from e
