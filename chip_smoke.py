#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (any failure exits non-zero):

  1. build    - compile every kernel of the serving path from
                src/repro_torch/csrc/ with nvcc for sm_90a, in parallel;
  2. kernels  - call each kernel's wrapper on card tensors at the shapes
                the full-width main path gives it, hold the result against
                its plain PyTorch version on the same inputs, and time both
                (CUDA events, median, L2 flushed before every launch);
  3. serve    - full-width stablelm-1.6b (24 layers, bf16, random weights
                from a seeded generator) with PDQ-int8 weights in every
                layer and an fp KV cache, serving 8 requests (prompts of
                20-250 tokens, 32 new tokens each, 8 slots, max_len 512)
                through build_engine(ServeConfig(quantize_weights=True,
                device="cuda")); the kernels' launch counts are zeroed just
                before and read just after, and every kernel must have run;
  4. profile  - torch.profiler over three decode steps of the full pool:
                the kernels' device time per step, the device's idle share
                of the serve phase's median step, the top kernels;
  5. parity   - one request's first 8 greedy tokens through the kernels and
                through the plain versions on the card (teacher-forced on
                the kernel path's tokens): each step's argmax agrees, or
                the plain path's top-2 margin is below the logits
                tolerance.

It prints the card's name and power limit, one JSON line with every
kernel's launches, error and times, and as its last line
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

LOGIT_TOL = 0.05          # |kernel - plain| logits bound in the parity phase
SUM_RTOL = 1e-5           # s1/s2: another summation order than the plain one


class SmokeError(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
def median_ms(fn, reps=30, flush=None):
    """Median time of one call of ``fn`` on the card: CUDA events around
    each call, a 64 MB write before each to evict the 50 MB L2 (the main
    path reads each layer's weights once per step), then a ~1 ms device
    spin so that the host has enqueued the call before the device reaches
    it: the events time the device's work, not the host's launch cost."""
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
    """Each kernel against its plain version at main-path shapes; returns
    {kernel: row} for the JSON line plus per-shape detail rows."""
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import pdq_prologue as pro
    from repro_torch.kernels import w8a8_matmul as mm
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(1234)
    t = kernel_inputs(eng, gen)
    M, d, x = t["M"], t["d"], t["x"]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=eng.device)
    rows, detail = {}, []

    def record(name, shape, err, k_ms, p_ms, b_ms, b_by, lib_ms, primary):
        row = dict(name=name, shape=shape, max_abs_err=err, ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        detail.append(row)
        log(f"kernel {name} {shape}: err {err:.3g} kernel {k_ms:.4f} ms "
            f"plain {p_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        if primary:
            rows[name] = row

    # prefill-shaped rows: 8 slots x the 256-token bucket
    x_pre = torch.randn((2048, d), generator=gen, device=eng.device).to(torch.bfloat16)

    def int_mm_rows(x_q):
        # torch._int_mm needs more than 16 rows: decode rows pad to 32
        if x_q.shape[0] > 16:
            return x_q
        xl = torch.zeros((32, x_q.shape[1]), dtype=torch.int8, device=x_q.device)
        xl[:x_q.shape[0]] = x_q
        return xl

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

    # ---- K2 w8a8_matmul: grouped QKV (per-block), wo, w_down (per-row)
    h_in = torch.randn((M, eng.cfg.d_ff), generator=gen,
                       device=eng.device).to(torch.bfloat16)
    cases = (("qkv", t["qkv"], x, True, True), ("wo", t["wo"], x, False, False),
             ("w_down", t["down"], h_in, False, False),
             ("qkv prefill", t["qkv"], x_pre, True, False))
    for label, rec, xin, per_block, primary in cases:
        base, (lo, hi) = epi_operands(rec, xin, per_block)
        args = base + (None, None, lo, hi)
        kw = dict(out_dtype=torch.bfloat16)
        yk = mm.w8a8_matmul_cuda(*args, **kw)
        yp = mm.w8a8_matmul_plain(*args, **kw)
        err = max_abs(yk, yp)
        need(err <= 1e-6 * float(yp.float().abs().max()) + 1e-6,
             f"K2 {label} fp_clamp output differs from plain by {err}")
        # the requant epilogue on the same product: int8 codes equal
        qargs = base + (torch.full_like(lo, 0.05), torch.zeros_like(lo, dtype=torch.int32))
        need(torch.equal(mm.w8a8_matmul_cuda(*qargs), mm.w8a8_matmul_plain(*qargs)),
             f"K2 {label} requant codes differ from plain")
        Mx, K = base[0].shape
        N = rec["q"].shape[1]
        E = lo.shape[1]
        # x_q, w_q, bf16 out, s_w, and per row s_x plus E (lo, hi) pairs
        b_ms, b_by = bound_ms(Mx * K + K * N + Mx * N * 2 + N * 4 + Mx * (4 + 8 * E),
                              2 * Mx * K * N, INT8_OPS)
        xl, wq = int_mm_rows(args[0]), rec["q"]
        record("w8a8_matmul", f"{label}: x ({Mx}, {K}) @ w ({K}, {N}), epilogue "
               f"({Mx}, {E})", err,
               median_ms(lambda: mm.w8a8_matmul_cuda(*args, **kw), flush=flush),
               median_ms(lambda: mm.w8a8_matmul_plain(*args, **kw), flush=flush),
               b_ms, b_by,
               median_ms(lambda: torch._int_mm(xl, wq), flush=flush), primary)

    # ---- K3 w8a8_swiglu_matmul: gate/up (M, 2048) @ (2048, 11264)
    gu = t["gu"]
    for xin, primary in ((x, True), (x_pre, False)):
        base, (lo, hi) = epi_operands(gu, xin, True)
        sargs = base + (lo, hi)
        ko = mm.w8a8_swiglu_matmul_cuda(*sargs)      # (hsw, hsw_q, s_x, s1, s2)
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
        err = max(max_abs(u, v) for u, v in zip(ko, po))
        Mx, K = base[0].shape
        N = gu["q"].shape[1]
        P = N // 2
        # what pdq_mlp reads and keeps: x_q, w_q, s_w, s_x, the (lo, hi)
        # pairs, hsw_q and its three row values (hsw is the kernel's scratch)
        b_ms, b_by = bound_ms(Mx * K + K * N + N * 4 + Mx * (4 + 8 * N // 128)
                              + Mx * P + 12 * Mx, 2 * Mx * K * N, INT8_OPS)
        xl = int_mm_rows(base[0])
        record("w8a8_swiglu_matmul", f"x ({Mx}, {K}) @ w ({K}, {N}); hsw code "
               f"mismatches {int((dq > 0).sum())}", err,
               median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs), flush=flush),
               median_ms(lambda: mm.w8a8_swiglu_matmul_plain(*sargs), flush=flush),
               b_ms, b_by, median_ms(lambda: torch._int_mm(xl, gu["q"]), flush=flush),
               primary)

    # ---- K4 cache_scatter: one admission round's leaves, stacked rows
    pool = eng.bundle.init_caches(eng.slots, eng.max_len)["blocks"][0]
    sub = eng.bundle.init_caches(eng.slots, eng.max_len)["blocks"][0]
    for leaf in sub.values():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=eng.device))
        else:
            leaf.copy_(torch.randint(0, 512, leaf.shape, generator=gen,
                                     device=eng.device, dtype=torch.int32))
    n, B = pool["k"].shape[:2]
    smap = torch.tensor([2, -1, 0, 1, -1, 3, -1, -1], dtype=torch.int32,
                        device=eng.device)[:B]
    stack = torch.arange(n, device=eng.device, dtype=torch.int32)[:, None]
    fmap = torch.where(smap[None] >= 0, smap[None] + B * stack, -1).reshape(-1)
    fmap = fmap.to(torch.int32)
    landed = int((fmap >= 0).sum())
    for name in ("k", "v", "pos", "len"):
        dst = pool[name].reshape((n * B,) + pool[name].shape[2:])
        src = sub[name].reshape((n * B,) + sub[name].shape[2:])
        want = kv.cache_scatter_plain(dst.clone(), src, fmap)
        got = kv.cache_scatter_cuda(dst.clone(), src, fmap)
        need(torch.equal(got, want), f"K4 {name} leaf differs from plain")
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


def make_requests(cfg, n=8, seed=0):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 251, size=n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(L)).astype(np.int32),
                    max_new=32) for i, L in enumerate(lens)]


def phase_serve(eng):
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
    log(f"serve: {len(reqs)} requests in {wall:.2f} s; counts {counts}")
    log(f"serve: stats {json.dumps(eng.stats)}")
    for name, c in counts.items():
        need(c["launches"] > 0, f"{name} was never launched on the main path")
        need(c["launches"] == c["entries"],
             f"{name}: {c['entries']} op entries but {c['launches']} launches")
    need(eng.stats["completed"] == len(reqs) and eng.stats["failed"] == 0,
         f"not every request completed: {eng.stats}")
    for r in reqs:
        need(r.done and r.error is None and len(r.generated) == r.max_new,
             f"request {r.uid}: {len(r.generated)} tokens, error {r.error}")
        need(all(0 <= tok < eng.cfg.vocab for tok in r.generated),
             f"request {r.uid}: token out of range")
    dec = [dt for dt, _ in eng.straggler.history]
    pre = [dt for dt, _ in eng.prefill_straggler.history]
    decode_tps = eng.stats["decode_tokens"] / sum(dec)
    steps = sorted(dec)
    log(f"serve: prefill launches {len(pre)} total {sum(pre):.3f} s "
        f"({eng.stats['prefill_tokens']} prompt tokens, "
        f"{eng.stats['prefill_padded_tokens']} padded); decode steps "
        f"{len(dec)} median {steps[len(steps) // 2] * 1e3:.2f} ms, "
        f"{decode_tps:.1f} tokens/s over {eng.stats['decode_tokens']} tokens")
    return counts, dict(wall_s=wall, prefill_s=sum(pre), prefill_launches=len(pre),
                        decode_step_median_ms=steps[len(steps) // 2] * 1e3,
                        decode_tokens_per_s=decode_tps, stats=eng.stats)


def phase_profile(eng, step_ms, steps=3):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of the full pool.  Device busy time per step is the sum
    of the CUDA kernels' time; the idle share compares it with the serve
    phase's unprofiled median step (``step_ms``), since the profiler
    itself slows the host.  Reports null device numbers if the profiler
    records no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = eng.slots
    tok = torch.zeros((B, 1), dtype=torch.int32, device=eng.device)
    pos = torch.full((B, 1), 300, dtype=torch.int32, device=eng.device)
    eng.bundle.decode_step(eng.params, eng.caches, tok, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.bundle.decode_step(eng.params, eng.caches, tok, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / steps / 1e3, ev.key, ev.count // steps))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    top = [dict(kernel=k[:70], ms=ms, launches=n) for ms, k, n in rows[:10]]
    out = dict(step_ms=step_ms, step_ms_under_profiler=wall_ms,
               kernels_per_step=sum(r[2] for r in rows),
               device_busy_ms=busy_ms if rows else None,
               device_idle_share=(1 - busy_ms / step_ms) if rows else None,
               top_kernels=top)
    log(f"profile: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers to their plain versions for CUDA tensors
    (this script's reference run only; the package never does this)."""
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import pdq_prologue as pro
    from repro_torch.kernels import w8a8_matmul as mm
    swaps = [(pro, "pdq_prologue_cuda", pro.pdq_prologue_plain),
             (mm, "w8a8_matmul_cuda", mm.w8a8_matmul_plain),
             (mm, "w8a8_swiglu_matmul_cuda", mm.w8a8_swiglu_matmul_plain),
             (kv, "cache_scatter_cuda", kv.cache_scatter_plain)]
    saved = [getattr(m, a) for m, a, _ in swaps]
    try:
        for m, a, f in swaps:
            setattr(m, a, f)
        yield
    finally:
        for (m, a, _), f in zip(swaps, saved):
            setattr(m, a, f)


def phase_parity(eng, n_tokens=8):
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
    worst = 0.0
    for i, (kl, pl) in enumerate(zip(k_logits, p_logits)):
        d = float((kl - pl).abs().max())
        worst = max(worst, d)
        need(torch.isfinite(kl).all(), f"parity step {i}: non-finite logits")
        need(d <= LOGIT_TOL, f"parity step {i}: logits differ by {d} > {LOGIT_TOL}")
        if int(kl.argmax()) != int(pl.argmax()):
            top2 = pl.topk(2).values
            margin = float(top2[0] - top2[1])
            need(margin < LOGIT_TOL, f"parity step {i}: argmax differs with "
                 f"plain top-2 margin {margin}")
            log(f"parity step {i}: argmax differs inside the margin ({margin:.4g})")
    log(f"parity: {n_tokens} greedy tokens {k_toks}; max |logits diff| "
        f"{worst:.4g} (tolerance {LOGIT_TOL})")
    return worst


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
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(0)
    eng = build_engine(ServeConfig(arch="stablelm-1.6b", reduced=False,
                                   slots=8, max_len=512, quantize_weights=True,
                                   device="cuda"), cfg=cfg, params=params)
    del params
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, PDQ-int8 weights in every layer, built in "
        f"{time.perf_counter() - t0:.1f} s")

    rows, detail = phase_kernels(eng)
    counts, serve = phase_serve(eng)
    serve["profile"] = phase_profile(eng, serve["decode_step_median_ms"])
    parity = phase_parity(eng)

    replaces = {
        "pdq_prologue": "src/repro/kernels/pdq_prologue.py:56",
        "w8a8_matmul": "src/repro/kernels/w8a8_matmul.py:72",
        "w8a8_swiglu_matmul": "src/repro/kernels/w8a8_matmul.py:200",
        "cache_scatter": "src/repro/kernels/kv_cache.py:246",
    }
    sources = {
        "pdq_prologue": "src/repro_torch/csrc/pdq_prologue.cu",
        "w8a8_matmul": "src/repro_torch/csrc/w8a8_matmul.cu",
        "w8a8_swiglu_matmul": "src/repro_torch/csrc/w8a8_matmul.cu",
        "cache_scatter": "src/repro_torch/csrc/kv_cache.cu",
    }
    kernels = []
    for name, row in rows.items():
        kernels.append(dict(name=name, route="cuda", source=sources[name],
                            replaces=replaces[name],
                            launches=counts[name]["launches"],
                            entries=counts[name]["entries"],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"], shape=row["shape"]))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             kernels=kernels, kernel_shapes=detail, serve=serve,
             parity_max_logit_diff=parity), indent=1))
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
