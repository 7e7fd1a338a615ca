#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Serving paths of full-width stablelm-1.6b (24 layers, bf16, random weights
from a seeded generator), of full-width gemma3-12b (H, HD, HB, HBW:
chunked prefill and the local/global decoder) and of the MoE families at
full width, cut in depth (DS, DSD: deepseek-v2-236b; AR: arctic-480b)
and of the SSD families at full width and full depth (M: mamba2-2.7b; Z,
ZD: zamba2-7b) and of the prefill extras' families at full width and full
depth (V, VD: phi-3-vision-4.2b; S, SD: seamless-m4t-medium), each built
with build_engine(ServeConfig(..., device="cuda")), and one path of
ops-level calls on stablelm's weights (E):

  A  int8_kv=True, quantize_weights=True   the main path: PDQ-int8 weights
     in every layer and the int8 KV cache (kernels K1 pdq_prologue, K2
     w8a8_matmul, K3 w8a8_swiglu_matmul, K5 decode_attend_i8kv_fused,
     K6 cache_scatter, one launch a round for every cache leaf; 7 launches
     per layer and decode step);
  B  int8_kv=True, fp weights              K4 decode_attend_i8kv and K6;
  C  int8_kv=False, quantize_weights=True  the fp KV cache: K1, K2, K3, K6;
  D  A with the pool paged: paged=True, spill=True, page_size=64, where K7
     cache_scatter_pages takes K6's place: every pool movement (prefill
     landing, decode gather and write-back, COW copy, spill restore) is one
     launch over all its leaves, the gather writing its whole scratch, the
     init fill included; D1 with the default
     pool (every slot can hold max_len), D2 with a pool small enough that
     decode growth preempts requests and spills them to host memory;
  A16, D16  A and D1 with decode_steps=16: every dispatch runs a block of
     16 model steps, sampling on the card (a row past its budget freezes),
     and a paged dispatch gathers once and writes back each row's window of
     pages once;
  F  A with pdq_fallback=True, served through ServeService + HttpFrontend
     on 127.0.0.1 (every request an SSE stream): every PDQ projection is
     guarded - its W8A8 epilogue flags a non-finite value and the
     predicated fp-dequant fallback (fp_dequant, csrc/fp_dequant.cu) runs
     after it, returning at once when the flag is clear; the MLP takes the
     reference's unfused composition, so K3 does not run, and QKV's and
     gate/up's RMSNorm runs in plain torch before K1 (interval mode);
  FF F's engine built and run under ops.pdq_fault() (the capture reads
     it): every guarded projection's output is poisoned and the fallback
     carries every projection;
  E  the ops-level quantization entry points on path A's own PDQ records
     (layer 0's Q segment of the grouped QKV, wo and w_down) at 8 and 2048
     rows: ops.pdq_dense_unfused, the pre-fusion projection (K8 act_stats +
     K2's requant epilogue), ops.act_stats (also with the sampling stride
     gamma), ops.quantize (K9) and ops.dequantize (K10) of its output on its
     own grid, and the fused ops.pdq_dense (K1 + K2) beside it.
  H  gemma3-12b at full width (48 layers: 40 local over a 1024-position
     ring, 8 global; d_model 3840, 16 x 256 heads over 8 kv heads, d_ff
     15360, vocab 262144; seeded random bf16 weights, PDQ-int8 records
     made by H's engine), int8 KV, slot rows, 8 slots, max_len 2048, the
     default buckets with chunked_prefill=True: 8 requests of 32 new tokens
     with prompts of 40-1900 tokens (H_PROMPTS; two behind one 128-token
     system prompt), six of them chunked (the first chunk through
     prefill_many, the rest through prefill_chunk), three past the ring;
     K1, K2, K3, K5 (global layers only, the kernel's wide (2, 256)
     instance; a local layer attends its ring in plain torch) and K6, one
     launch landing all 36 leaves of a round;
  HD H on a paged pool (page 64, every slot can hold max_len: nothing is
     preempted) with prefix sharing: the ring leaves stay flat slot rows,
     the global layers' page; its streams must equal H's;
  HB, HBW  H with a bf16 KV cache, chunked (HB) and unchunked (HBW, the
     capacity bucket of 2047 tokens): their streams must be equal, or
     diverge where the token's top-2 margin is below H's LOGIT_TOL;
  DS deepseek-v2-236b at full width (d_model 5120, 128 heads, MLA with
     q_lora 1536 and kv_lora 512, 160 experts top-6 of 1536, 2 shared
     experts as one MLP of 12288, vocab 102400) cut to 4 layers: layer 0
     dense (global_dense, a head layer), 3 MoE layers whose experts stay
     bf16 (26.4 GB of seeded random bf16 weights; PDQ-int8 records of
     every 2-D projection made by DS's engine); a bf16 MLA cache (ckv,
     krope), slot rows, 8 slots, max_len 2048, chunked prefill, H's
     requests: K1 (the (wq_a, wkv_a) group with the attention norm, wq_b
     with q_norm, wo's and wk_b / wv_b's intervals, the shared and dense
     MLPs), K2, K3 and K6 (one launch landing the head layer's and the
     blocks' 8 leaves); 9 launches a layer and decode step.  The routed
     experts (dense-masked at decode, capacity buckets at prefill) and the
     absorbed MLA decode are plain torch, as in the reference;
  DSD DS on a paged pool (page 64, prefix sharing), K7 in K6's place; its
     streams must equal DS's;
  AR arctic-480b at full width (d_model 7168, 56 heads over 8 kv heads,
     128 experts top-2 of 4864 beside a dense residual MLP of 4864) cut to
     2 MoE layers (~55 GB of bf16 weights), PDQ-int8 projections, int8
     KV, slot rows, 8 slots, max_len 512, A's requests: K1, K2, K3, K5 (G
     7, the (8, 128) instance) and K6; A's 7 launches a layer;
  M  mamba2-2.7b at full width and full depth (64 mamba layers, d_model
     2560, 80 SSD heads of 64, state 128, vocab 50280; seeded random bf16
     weights, PDQ-int8 in_proj / out_proj records made by M's engine),
     slot rows, H's serving shape and requests (8 slots, max_len 2048,
     chunked prefill in chunks of 256): K1 (in_proj with the layer's
     RMSNorm, out_proj with the gated RMSNorm, both with the interval), K2
     and K6 (a round's landing of every layer's conv window and f32 state:
     2 leaves); 4 launches a layer and step.  The conv, the SSD scan and
     the decode update are plain torch, as the reference's are plain jnp;
  Z  zamba2-7b at full width and full depth (81 layers: 13 x (5 mamba + one
     occurrence of the shared attention + MLP block) + 3 mamba; d_model
     3584, 112 SSD heads of 64, state 64; the shared block's 32 x 112
     heads over 32 kv heads, d_ff 14336; vocab 32000), int8 KV, slot rows,
     A's serving shape and requests: the mamba layers as M's, the shared
     occurrences A's layer (K1, K2, K3, K5 at G 1, Dh 112: the (8, 128)
     instance), K6 landing a round's 22 leaves;
  ZD Z on a paged pool (page 64, prefix sharing, a pool that never
     preempts): the SSD leaves flat slot rows, the shared occurrences' K/V
     pages, K7 in K6's place; its streams must equal Z's;
  V  phi-3-vision-4.2b at full width and full depth (32 layers, d_model
     3072, 32 x 96 heads over 32 kv heads, d_ff 8192, vocab 32064; seeded
     random bf16 weights, PDQ-int8 records made by V's engine) with its
     1024 stub patch embeddings (models/frontend.py, seeded) prepended to
     every prompt, int8 KV, slot rows, A's requests on 8 slots, max_len
     1536: K1, K2, K3, K5 (G 1, Dh 96: the (8, 128) instance) and K6; A's 7
     launches a layer and step;
  VD V on a paged pool (page 64; a run's extras turn prefix sharing off):
     K7 in K6's place; its streams must equal V's;
  S  seamless-m4t-medium at full width and full depth (12 encoder and 12
     decoder layers, d_model 1024, 16 x 64 heads, d_ff 4096, vocab 256206)
     over 8 stub frame embeddings (the engine's mem_len), int8 KV, slot
     rows, A's serving shape: every prefill runs the bidirectional encoder
     (A's prefill layer each) and each decoder layer's cross block, whose
     (wk, wv) group projects the encoder's output once into the layer's
     cross K/V leaves; a decode step's layer is K1 x 4 (QKV, cross wq with
     its norm, cross wo's interval, gate/up), K2 x 5, K3 and K5; the
     cross-attention itself is plain torch, as the reference's is jnp;
  SD S on a paged pool: the cross K/V leaves flat slot rows beside the
     pages, moved in the same K7 launch; its streams must equal S's;
  G  the paper's CNN track (repro_torch.core, models/cnn.py,
     data/corruptions.py) at the widths of the repository's paper tables
     (benchmarks/_cnn_common.py: width 24, res 20, 16 classes): cls_resnet,
     cls_mobilenet and seg_unet trained with the reference's Adam on the
     card, calibrated (16 images), evaluated fp32 and static / dynamic / PDQ
     x per tensor / per channel on 384 images in-domain and corrupted
     (Tables 1-2), the surrogate's fidelity, PDQ at gamma 2 and 4 on
     cls_resnet, then held against the port's plain CPU run with TF32
     allowed for cuDNN globally; last Fig. 3's estimate / conv / range
     times.  It reaches none of the ten kernels.

On every path each decode dispatch is one replay of the engine's CUDA
graph of its N-step block, captured once per engine (serve/decode_graph.py):
one copy of the plan's rows in, the replay, one copy of the (8, N) tokens
and the block's PDQ health vector out.  Telemetry is on (the default):
the W8A8 epilogues count clip hits and outputs into the engine's counters,
and every path prints its pdq_clip_hits, pdq_clip_total and clip rate.

Phases, each of which must pass (any failure exits non-zero):

  1. build    - compile every kernel from src/repro_torch/csrc/ with nvcc
                for sm_90a, one process per source, in parallel;
  2. kernels  - call each kernel's wrapper on card tensors at the shapes
                the full-width paths give it, hold the result against its
                plain PyTorch version on the same inputs, and time both
                (CUDA events, median, L2 flushed before every launch); K1
                in its plain mode and with the RMSNorm in front and the
                interval after it (QKV's and gate/up's records, a nonzero
                norm weight), its normed row, x_q and s_x bit-equal to
                plain's, two launches bit-equal; K2
                and K3 on both routes (wgmma, the main path's, and generic,
                which must give the same bits), beside torch._int_mm on
                the K-major weights and on a row-major copy, with the host
                time per call of each route and K3's quantize tail; K4 and
                K5 on both routes (split, the paths', and single, the first
                design) at path A's cache and at a 4096-position one, within
                ATTEND_TOL of plain and of each other, split bit-equal over
                two launches with its tickets back at 0; K6 and K7 as one
                launch a movement over every leaf (a round's six-leaf
                landing; D1's whole gather at position 300 into a scratch
                poisoned with 0xFF, its write-back, a ragged gather, a COW
                copy), bit-equal to plain, bound from kv.move_plan; K8, K9
                and K10 at path E's rows and at 16384 rows (past the L2),
                beside a PyTorch kernel that moves the same bytes; K2 and
                K3 also with the health counters (tel_ms), their counts
                equal to plain's on both routes; the fallback at QKV's and
                w_down's shapes, taken (flag set) and not taken; before the
                H paths, rows at gemma3-12b's shapes (tagged "H"): K4 and K5
                at B 8, Hkv 8, G 2, Dh 256, Sp 2048 with lengths 1-2048
                (the wide instance), K6 landing one of H's rounds (36
                leaves, one launch) and K7 HD's decode gather; once H's
                engine has made its PDQ records, K1, K2 and K3 on them at
                decode and prefill rows, as A's above (QKV's three unequal
                segments, wo at 4096, gate/up at 2 x 15360, w_down at
                15360);
                The MoE paths' rows (tagged DS, DSD, AR) run on each
                engine's own records before it serves (``moe_kernels``):
                K1, K2 and K3 at MLA's, the shared experts' and arctic's
                shapes (a chunk continuation's wk_b over 16384 rows), K4/K5
                at G 7, K6 landing a round over every leaf, K7 DSD's
                gather.  The SSD paths' rows (tagged M, Z, ZD;
                ``ssm_kernels``): K1 and K2 at in_proj's and out_proj's
                shapes (ragged N 10576 and 14576), Z's shared QKV, wo,
                gate/up (K3) and w_down, K4/K5 at G 1, Dh 112, Sp 512, K6
                a round's landing with every conv and state leaf, K7 ZD's
                landing (slot rows and pages in one launch) and gather.
                The extras paths' rows (tagged V, VD, S, SD;
                ``extras_kernels``): K1-K3 at V's QKV (3072 -> 3 x 3072,
                also at 8 x (1024 + 256) prefill rows), wo, gate/up (2 x
                8192) and w_down, and at S's QKV, cross wq, the cross
                (wk, wv) group over 8 x 8 memory rows, cross wo, gate/up and
                w_down; K4/K5 at V's G 1, Dh 96, Sp 1536 and S's Hkv 16,
                Dh 64, Sp 512; K6 a round's landing (S's with the cross
                leaves); K7 VD's and SD's landing and gather;
  3. serve    - each path serves 8 requests (F over HTTP; FF 3 short ones;
                H's of H_PROMPTS; otherwise prompts of 20-250 tokens, the
                first two behind one 128-token system prompt, 32 new tokens
                each, 8 slots, max_len 512); the kernels' counts are zeroed
                just before and read just after each run (a replay adds what
                its capture counted), every decode dispatch must have been a
                graph replay, every kernel of
                the path must have launched as often as its op was entered,
                the census must hold exactly with N model steps a dispatch
                and every chunk continuation a prefill launch (K1's
                launches per mode too:
                QKV and gate/up with norm and interval, wo with the interval
                where K5 does not run its prologue), every K2/K3 launch must have
                taken the wgmma route, every K4/K5 launch the split route
                and every K8/K9 launch the vector route (MAIN_ROUTE), and
                the other paths' kernels must not have run (F and FF: no
                K3, one fallback launch a guarded projection, 4 a layer and
                model step; FF's pdq_fallbacks exactly that many, F's 0);
                the runs go in
                turns A B C C F A D1 D2 A16 D16 FF, so that A's, C's and F's
                times compare within one call; D1's, D2's, A16's and D16's greedy
                streams must equal A's first run's, D1 and D16 must
                share the system prompt's pages, D2 must preempt, spill and
                restore; per-token decode time and tokens/s of each run;
  4. step     - on A, B, C, D1, F, H, DS, DSD, AR, M, Z, V and S, one
                decode step of the full pool at position 300 (V's behind
                its 1024 patches) two ways on the
                same state, eager (ops
                launched from the host) and a replay of the engine's
                one-step graph, in five alternated pairs of three-step
                windows: wall ms a step; then torch.profiler over a window
                of each: device busy ms, kernels a step and idle share; on
                A also a graph of the same block captured with telemetry
                off, alternated with the two (the counting's cost);
  5. parity   - on A, B, C, F, FF, H, DS, DSD, AR, M, Z, V and S (F and
                FF under the guard, FF under the fault; H's and M's prompt
                of 1100 tokens prefilled in its 256-token chunks; V's and
                S's with the path's extras), one request's first 8 greedy
                tokens through
                the kernels and through the plain versions on the card
                (teacher-forced on the kernel path's tokens): logits within
                the path's LOGIT_TOL, and each step's argmax agrees or the
                plain path's top-2 margin is below it; the PDQ health
                vector of the kernel run equals the plain run's, also with
                every record's alpha and beta scaled by CLIP_SCALE so that
                outputs clip (then within TEL_SLACK: the clamp edges are
                priced from sums in another order than plain's).  On M and
                Z also one step at a time: each decode step again from a
                copy of the kernel run's caches as they stood before it,
                with every kernel plain, and with every kernel plain but
                K5: the latter within LOGIT_TOL at every step (argmax-margin
                check included), the former too but at a step whose K5
                parted codes from plain's within its contract
                (``code_flips``), where that step's own move is reported;
  6. unfused  - path E, after the serving runs: counts zeroed before and read
                after, an exact census (each unfused call one K8 and one K2,
                no K1; every K2 on the wgmma route, every K8 and K9 on the
                vector route), the re-quantized output equal to the
                projection's own codes and dequantized back bit
                for bit, the same calls on CPU copies of the inputs (the
                plain versions) within one int8 step, fused against unfused
                within one step per row (the
                reference's contract), both timed end to end, and three
                unfused calls profiled.  Then the H paths: their kernel
                rows, and phases 3-5 for H, HD, HB and HBW in turn (HD's
                streams against H's, HBW's against HB's).  Then the MoE
                paths DS, DSD and AR (each engine freed before the next):
                their kernel rows and phases 3-5, phase 4 also split a
                step's device time between the routed experts, the
                attention and the hand kernels (``step_split``), phase 5
                logging every router decision the kernel and plain runs
                took apart (ROUTER_EPS) and not binding the logits after
                one; DSD's streams against DS's.  Then the SSD paths M, Z
                and ZD (``phase_ssm``): their kernel rows, phases 3-5 for
                M and Z (phase 4's ``step_split`` puts the SSD blocks
                beside the attention and the hand kernels), ZD's phase 3
                and its streams against Z's.  Then the extras paths V, VD,
                S and SD (``phase_extras``): their kernel rows, phases 3-5
                for V and S with the paths' extras, VD's and SD's phase 3
                and their streams against V's and S's (no prefix hit).
  7. cnn      - path G, last: counts zeroed before and read after (every
                kernel 0), cls_resnet's fp32 top-1 >= G_FP32_FLOOR, every
                accuracy in [0, 1]; parity with the CPU: unquantized logits
                within G_LOGIT_RTOL of max |logit|, qstate within
                G_QSTATE_RTOL, top-1 agreement >= G_TOP1_AGREE in every
                quantized mode, every table entry within G_TABLE_TOL.

The seconds of every phase are logged ("phase <name>: <s> s").

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
LOGIT_TOL = {"A": 0.25, "B": 0.25, "C": 0.05, "F": 0.25, "FF": 0.25,
             # H (gemma3-12b): A's argument over twice the depth.  Its random
             # logits (final norm, then d_model 3840 x N(0, 0.02) rows) reach
             # |logit| ~6-8 across the 262144-token vocabulary: bf16 ulp
             # 0.03125 in [4, 8), and 48 layers in place of 24 give 16 such
             # ulps
             "H": 0.5,
             # DS, DSD: C's argument (a bf16 cache: K1-K3 give plain's bits
             # but for sums in another order) over 4 layers; AR: A's
             # (int8 KV) over 2.  Steps after a router decision the two
             # runs took apart (within ROUTER_EPS) are reported, not bound
             "DS": 0.05, "DSD": 0.05, "AR": 0.25,
             # M (mamba2): C's argument (no KV cache; K1/K2 give plain's bits
             # but for sums in another order, and the SSD is the same torch
             # code in both runs).  Z (zamba2): A's argument (its 13 shared
             # occurrences attend the int8 KV cache through K5), up to the
             # first step whose K5 gave wo's prologue a code one apart from
             # plain's (``code_flips``): the SSD state carries that code
             # into every later token and layer, where A's cache keeps it
             # to one token, so from there the bound holds the ONE-STEP
             # difference (each decode step run plain from the kernel
             # run's own caches as they stood before it) and the
             # teacher-forced difference is reported
             "M": 0.05, "Z": 0.25,
             # V (phi-3-vision): A's argument over 32 layers in place of 24,
             # 8 x 32 / 24 -> 11 bf16 ulps of 0.03125 (its random logits:
             # final norm, then d_model 3072 x N(0, 0.02) rows, reach
             # |logit| ~4-6 over 32064 tokens).  S (seamless): A's argument
             # (int8 KV through K5) over its 12 decoder and 12 encoder
             # layers, 24 as A's; its logits (d_model 1024) stay below 4
             "V": 0.34375, "S": 0.25}
# the parity phase's second health comparison: every record's alpha and
# beta times this, so that outputs clip
CLIP_SCALE = 0.25
# |kernel - plain| clip hits allowed in that comparison, as a share of the
# outputs.  With the records' own alpha and beta almost nothing clips, and
# kernel and plain count alike.  Once outputs sit on their clamp edges the
# edges themselves matter, and they are priced from sums taken in another
# order than plain's: K3's s1/s2 (w_down's interval; every PDQ path, C
# included) and K5's o (A, F, FF; within ATTEND_TOL).  An edge an ulp
# away moves every output clamped to it and everything after, so an output
# within an ulp of its edge can land on either side.  Measured 5.7e-6 (C)
# and 7.9e-6 (A) of the outputs.  On FF every projection's output is the
# fallback's f32 product, summed in another order than plain's, so every
# activation moves by ulps: measured 1.1e-4 (NVIDIA H100 80GB HBM3, 700 W,
# PR 21).
TEL_SLACK = {"A": 1e-4, "B": 0.0, "C": 1e-4, "F": 1e-4, "FF": 1e-3,
             "H": 1e-4,           # H: A's (K5's o and K3's sums move edges)
             "DS": 1e-4, "DSD": 1e-4, "AR": 1e-4,    # C's and A's
             "M": 1e-4, "Z": 1e-4, "V": 1e-4, "S": 1e-4}
SUM_RTOL = 1e-5           # s1/s2: another summation order than the plain one
ATTEND_TOL = 2e-4         # attend o, rtol = atol (tests/test_kernels.py:177)
ATTEND_LENS = (1, 57, 128, 129, 250, 300, 511, 512)   # ragged across the tile
# the kernel table's long cache: stablelm-2-1.6b's published context length
ATTEND_LONG_SP = 4096
ATTEND_LONG_LENS = (4096, 3500, 2048, 1500, 1024, 700, 129, 1)

E_ROWS = (8, 2048)        # path E: decode rows (the slots), prefill (8 x 256)
STREAM_ROWS = 16384       # K8/K9/K10 rows past the L2: 128 MiB of f32 at d_model
E_GAMMA = 4               # act_stats' sampling stride on E's (8, 256, K) input
E_SPIN = 20_000_000       # E's device spin before each timed call, cycles (~10 ms)
E_PROFILED = 3            # unfused calls in E's profile of each case
PAGE = 64                 # path D's page size
D2_POOL_PAGES = 17        # D2's physical pages: 16 usable, 2 slots' worth
N_BLOCK = 16              # A16's and D16's decode steps a dispatch
STEP_POS = 300            # phase 4: the position every row decodes at
STEP_PAIRS = 5            # phase 4: alternated (eager, graph) pairs
STEP_RUNS = 3             # phase 4: steps a timed or profiled window

# paths H, HD, HB, HBW: gemma3-12b at full width (48 layers: 40 local with a
# 1024-position ring, 8 global), 8 slots, max_len 2048, the default buckets
# (32-256) with chunked prefill: 8 requests of 32 new tokens with prompts of
# H_PROMPTS tokens, H_SHARED behind one 128-token system prompt
H_ARCH = "gemma3-12b"
H_MAX_LEN = 2048
H_PROMPTS = (40, 200, 300, 700, 1000, 1100, 1500, 1900)
H_SHARED = (1, 2)
H_PARITY_LEN = 1100       # the parity prompt: 5 chunks, past the ring
H_ATTEND_LENS = (2048, 1, 1900, 1025, 1024, 700, 129, 300)   # K4/K5 at H's cache

# paths DS, DSD, AR: the MoE families at full width, cut in depth only.
# DS: deepseek-v2-236b cut to 4 layers (layer 0 dense, then 3 MoE layers of
# 160 bf16 experts top-6 beside 2 shared experts as one int8 MLP of 12288),
# MLA (128 heads, kv_lora 512) over a bf16 cache, H's serving shape (8
# slots, max_len 2048, chunked prefill, H's prompts); DSD: DS paged (page
# 64, prefix sharing); AR: arctic-480b cut to 2 MoE layers (128 bf16
# experts top-2 beside a dense int8 MLP of 4864), int8 KV, A's serving
# shape (8 slots, max_len 512, A's prompts)
DS_ARCH, DS_LAYERS, DS_MAX_LEN = "deepseek-v2-236b", 4, 2048
AR_ARCH, AR_LAYERS, AR_MAX_LEN = "arctic-480b", 2, 512
AR_ATTEND_LENS = (512, 1, 250, 129, 128, 57, 300, 511)   # K5 at AR's cache
# a router decision the kernel and plain runs may take apart: the plain
# run's margin between the k-th and (k+1)-th expert probability at that
# token is below this (the two runs' activations differ by int8 codes at
# clamp edges, which move a router logit by ~1e-3 at most)
ROUTER_EPS = 1e-3

# paths M, Z, ZD: the SSD families at full width and full depth.  M:
# mamba2-2.7b (64 mamba layers, d_model 2560, 80 SSD heads of 64, state 128)
# on H's serving shape (8 slots, max_len 2048, chunked prefill in chunks of
# 256, H's prompts: the long prompts an attention-free model is chosen
# for); Z: zamba2-7b (81 layers: 68 mamba of d_model 3584, 112 heads of 64,
# state 64, and one shared attention + MLP block, 32 x 112 heads, at 13
# occurrences) with int8 KV on A's serving shape (8 slots, max_len 512, A's
# prompts); ZD: Z paged (page 64, prefix sharing, a pool that never
# preempts)
M_ARCH, M_MAX_LEN = "mamba2-2.7b", 2048
Z_ARCH, Z_MAX_LEN = "zamba2-7b", 512
Z_ATTEND_LENS = AR_ATTEND_LENS    # K5 at Z's cache (max_len 512, as AR's)
# paths V, VD, S, SD: the prefill extras' families at full width and full
# depth.  V: phi-3-vision-4.2b (32 layers, d_model 3072, 32 x 96 heads, d_ff
# 8192) with its 1024 stub patch embeddings prepended to every prompt,
# int8 KV, A's requests on 8 slots, max_len 1536 (1024 patches + a 250-token
# prompt + 32 new tokens fit); VD: V paged (page 64; patches turn prefix
# sharing off).  S: seamless-m4t-medium (12 encoder + 12 decoder layers,
# d_model 1024, 16 x 64 heads, vocab 256206) over S_FRAMES stub frame
# embeddings (the engine's mem_len), int8 KV, A's serving shape; SD: S
# paged, the cross K/V leaves flat slot rows beside the pages
V_ARCH, V_MAX_LEN = "phi-3-vision-4.2b", 1536
S_ARCH, S_MAX_LEN = "seamless-m4t-medium", 512
S_FRAMES = 8
V_ATTEND_LENS = (1536, 1, 1044, 1153, 1024, 1025, 1280, 1306)   # K5 at V's cache
S_ATTEND_LENS = AR_ATTEND_LENS    # K5 at S's cache (max_len 512, as AR's)
# K1-K3 and the attend kernels, by their CUDA function names
HAND_KERNEL = r"\b(prologue_kernel|w8a8_kernel|swiglu_kernel|gemm_kernel|split_kernel|" \
              r"attend_kernel|move_pages|act_stats_kernel|quantize_kernel|" \
              r"dequantize_kernel|fallback_kernel)\b"

# path: (int8_kv, quantize_weights, the kernels it must launch, the other
# ServeConfig fields: paging, decode_steps, the guard)
_A_KERNELS = ("pdq_prologue", "w8a8_matmul", "w8a8_swiglu_matmul",
              "decode_attend_i8kv_fused", "cache_scatter")
# the guard: the unfused MLP (no K3) and the fallback after every projection
_F_KERNELS = ("pdq_prologue", "w8a8_matmul", "decode_attend_i8kv_fused",
              "cache_scatter", "fp_dequant")
# a paged pool moves every leaf with K7, its slot-row ``len`` included
_D_KERNELS = _A_KERNELS[:-1] + ("cache_scatter_pages",)
_C_KERNELS = ("pdq_prologue", "w8a8_matmul", "w8a8_swiglu_matmul", "cache_scatter")
_PAGED = dict(paged=True, spill=True, page_size=PAGE)
PATHS = {
    "A": (True, True, _A_KERNELS, {}),
    "B": (True, False, ("decode_attend_i8kv", "cache_scatter"), {}),
    "C": (False, True, _C_KERNELS, {}),
    "D1": (True, True, _D_KERNELS, _PAGED),
    "D2": (True, True, _D_KERNELS, dict(_PAGED, pool_pages=D2_POOL_PAGES)),
    "A16": (True, True, _A_KERNELS, dict(decode_steps=N_BLOCK)),
    "D16": (True, True, _D_KERNELS, dict(_PAGED, decode_steps=N_BLOCK)),
    "F": (True, True, _F_KERNELS, dict(pdq_fallback=True)),
    "FF": (True, True, _F_KERNELS, dict(pdq_fallback=True)),
    # gemma3-12b: H chunked on slot rows, HD H paged (page 64, a pool that
    # never preempts), HB H with a bf16 KV cache, HBW HB unchunked (the
    # capacity bucket, 2047 tokens)
    "H": (True, True, _A_KERNELS, dict(chunked_prefill=True)),
    "HD": (True, True, _D_KERNELS, dict(chunked_prefill=True, paged=True,
                                        page_size=PAGE)),
    "HB": (False, True, _C_KERNELS, dict(chunked_prefill=True)),
    "HBW": (False, True, _C_KERNELS, {}),
    # the MoE families: DS chunked on slot rows with a bf16 MLA cache, DSD
    # DS paged (page 64, prefix sharing), AR with int8 KV on slot rows
    "DS": (False, True, _C_KERNELS, dict(chunked_prefill=True)),
    "DSD": (False, True, _C_KERNELS[:-1] + ("cache_scatter_pages",),
            dict(chunked_prefill=True, paged=True, page_size=PAGE)),
    "AR": (True, True, _A_KERNELS, {}),
    # the SSD families: M chunked on slot rows (no KV cache: K1, K2 and K6),
    # Z with int8 KV on slot rows (its shared block A's kernels), ZD Z paged
    "M": (False, True, ("pdq_prologue", "w8a8_matmul", "cache_scatter"),
          dict(chunked_prefill=True)),
    "Z": (True, True, _A_KERNELS, {}),
    "ZD": (True, True, _D_KERNELS, dict(paged=True, page_size=PAGE)),
    # the prefill extras' families: V (patches) and S (encoder frames) with
    # int8 KV on slot rows (A's kernels), VD and SD paged
    "V": (True, True, _A_KERNELS, {}),
    "VD": (True, True, _D_KERNELS, dict(paged=True, page_size=PAGE)),
    "S": (True, True, _A_KERNELS, {}),
    "SD": (True, True, _D_KERNELS, dict(paged=True, page_size=PAGE)),
}
H_PATHS = ("H", "HD", "HB", "HBW")
MOE_PATHS = ("DS", "DSD", "AR")
SSM_PATHS = ("M", "Z", "ZD")
EXTRAS_PATHS = ("V", "VD", "S", "SD")
ENCDEC_PATHS = ("S", "SD")
LONG_PATHS = H_PATHS + ("DS", "DSD", "M")      # H's prompts, max_len 2048
FAULT_PATH = "FF"         # built and run under ops.pdq_fault()
GUARDED_PER_LAYER = 4     # guarded projections a layer: QKV, wo, gate/up, w_down


def is_paged(path) -> bool:
    return bool(PATHS[path][3].get("paged"))


def block_of(path) -> int:
    """A path's decode steps a dispatch (N)."""
    return PATHS[path][3].get("decode_steps", 1)


def is_guarded(path) -> bool:
    return bool(PATHS[path][3].get("pdq_fallback"))


# K2/K3 rows also carry the generic route's time, torch._int_mm on the
# row-major copy, the host time per call of each route and K3's tail; K4/K5
# rows the single route's time and error
EXTRA_KEYS = ("generic_ms", "library_rowmajor_ms", "host_us", "generic_host_us",
              "tail_ms", "single_ms", "single_err", "mode", "same_bytes_ms", "tel_ms",
              "not_taken_ms", "not_taken_plain_ms", "not_taken_bound_ms", "library_note")


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
    random activations: decode M = slots rows (``x`` at d_model; ``xo``,
    wo's input, at H * Dh)."""
    import torch
    dev = eng.device
    M = eng.slots
    p0 = eng.params["blocks"][0]
    qkv = p0["attn"]["wq"]["group"]
    gu = p0["ffn"]["w_gate"]["group"]
    wo, down = p0["attn"]["wo"], p0["ffn"]["w_down"]
    d = eng.cfg.d_model
    x = torch.randn((M, d), generator=gen, device=dev).to(torch.bfloat16)
    return dict(M=M, d=d, x=x, xo=rows_for(x, wo, gen), qkv=qkv, gu=gu, wo=wo, down=down)


def rows_for(x, rec, gen):
    """``x``, or as many random bf16 rows at ``rec``'s input width where it
    differs (wo's H * Dh: stablelm's equals d_model, gemma3-12b's 4096 does
    not)."""
    import torch
    K = rec["q"].shape[0]
    if x.shape[1] == K:
        return x
    return torch.randn((x.shape[0], K), generator=gen, device=x.device).to(torch.bfloat16)


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


def recorder(rows, detail, path=None):
    """``record(name, shape, err, ms, plain_ms, bound_ms, bound_by,
    library_ms, primary, **extra)``: a kernel-phase row, logged and kept in
    ``detail`` (tagged with ``path`` if given); a ``primary`` row is also
    the kernel's row of the JSON line (``rows``)."""
    def record(name, shape, err, k_ms, p_ms, b_ms, b_by, lib_ms, primary, **extra):
        if path is not None:
            extra = dict(path=path, **extra)
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
    return record


def phase_kernels(eng):
    """Each kernel against its plain version at the shapes of path A's
    engine ``eng``; returns {kernel: row} for the JSON line plus per-shape
    detail rows."""
    import torch
    from repro_torch.kernels import kv_cache as kv
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(1234)
    t = kernel_inputs(eng, gen)
    d, x = t["d"], t["x"]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=eng.device)
    rows, detail = {}, []
    record = recorder(rows, detail)

    # prefill-shaped rows: 8 slots x the 256-token bucket
    x_pre = torch.randn((2048, d), generator=gen, device=eng.device).to(torch.bfloat16)

    # ---- K1 pdq_prologue: the plain mode and the main path's fused modes
    prologue_kernels(eng, t, gen, flush, record, x_pre)

    # ---- K2 w8a8_matmul and K3 w8a8_swiglu_matmul, both routes
    matmul_kernels(eng, t, gen, flush, record, x_pre)

    # ---- the guard's predicated fp-dequant fallback, taken and not
    fallback_kernels(eng, t, gen, flush, record, x_pre)

    # ---- K4 decode_attend_i8kv and K5 its fused form: one decode step's
    # attention over path A's int8 cache, lengths ragged across the tile
    attend_kernels(eng, gen, flush, record)

    # ---- K7 cache_scatter_pages: path D1's pool movements at full width
    page_kernels(eng, gen, flush, record)

    # ---- K8 act_stats, K9 quantize, K10 dequantize: path E's shapes
    quant_kernels(eng, gen, flush, record)

    # ---- K6 cache_scatter: one admission round's landing, six leaves
    slot_row_kernels(eng, gen, flush, record)
    return rows, detail


def check_prologue(x, norm, interval, label):
    """K1 against plain in one mode: the normed row (its mean of squares
    is the plain version's own reduction), x_q and s_x bit-equal to plain's;
    s1/s2 within SUM_RTOL of the row's sums; lo_g/hi_g bit-equal to the
    plain interval of the kernel's own s1/s2; a second launch bit-equal.
    Returns the largest |kernel - plain| over the outputs."""
    import torch
    from repro_torch.kernels import pdq_prologue as pro
    from repro_torch.kernels import ref
    k = pro.pdq_prologue_cuda(x, norm, interval, return_normed=True)
    p = pro.pdq_prologue_plain(x, norm, interval, return_normed=True)
    y = k[-1]
    own = pro.pdq_prologue_plain(y)
    need(torch.equal(y, x if norm is None else p[-1]),
         f"K1 {label}: the normed row differs from plain's")
    need(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
         f"K1 {label}: x_q/s_x differ from plain")
    yf = y.float()
    need(bool(((k[2] - own[2]).abs() <= SUM_RTOL * yf.abs().sum(-1, keepdim=True)).all()),
         f"K1 {label}: s1 outside tolerance")
    need(bool(((k[3] - own[3]).abs() <= SUM_RTOL * own[3]).all()),
         f"K1 {label}: s2 outside tolerance")
    if interval is not None:
        rec, blocks = interval
        lo_g, hi_g = ref.grid_extent(*ref.pdq_interval(rec, k[2], k[3])[2:])
        if blocks is not None:
            lo_g, hi_g = ref.blockwise(lo_g, blocks), ref.blockwise(hi_g, blocks)
        need(torch.equal(k[4], lo_g) and torch.equal(k[5], hi_g),
             f"K1 {label}: lo_g/hi_g differ from the plain interval of its own sums")
    again = pro.pdq_prologue_cuda(x, norm, interval)
    need(all(torch.equal(a, b) for a, b in zip(again, k)),
         f"K1 {label}: two launches differ")
    return max(max_abs(a, b) for a, b in zip(k[:-1], p[:-1]))


def prologue_kernels(eng, t, gen, flush, record, x_pre):
    """K1 at the shapes of ``eng``'s model (path A's, or H's): the plain
    mode (``ops.pdq_prologue``, the int8-out projections) at decode and
    prefill rows; the interval mode (wo: one column a row) at decode rows
    (where K5 does not run wo's prologue: H's local layers) and at prefill
    rows; and the main path's norm + prologue + interval launches: QKV
    (stablelm: 3 segments, 48 blocks) and gate/up (2 segments, 88 blocks) at
    decode, QKV at prefill, on layer 0's records and a seeded nonzero norm
    weight.
    Bound: the bytes the op must move (h, the norm weight and the weight
    stats read once; x_q, s_x, s1, s2, lo_g and hi_g written once).
    ``same_bytes_ms``: ``x.to(torch.int8)`` on the same rows, a PyTorch
    kernel that moves the plain mode's bytes and computes nothing, in the
    same harness; ``host_us``, the host's time per call (the wrapper and
    its launch)."""
    import torch
    from repro_torch.kernels import ops
    d, x = t["d"], t["x"]
    w = (0.2 * torch.randn((d,), generator=gen, device=eng.device)).to(torch.bfloat16)
    norm = (w, eng.cfg.norm_eps)
    cases = [(x, None, None, False), (x_pre, None, None, False),
             (t["xo"], None, (t["wo"], None), False),
             (rows_for(x_pre, t["wo"], gen), None, (t["wo"], None), False)]
    for rec, xm, primary in ((t["qkv"], x, True), (t["gu"], x, False),
                             (t["qkv"], x_pre, False)):
        cases.append((xm, norm, (rec, ops._blocks(rec["segs"])), primary))
    for xm, nrm, iv, primary in cases:
        k1_row(xm, nrm, iv, primary, flush, record)


def k1_row(xm, nrm, iv, primary, flush, record, label=""):
    """One K1 row: ``check_prologue`` on x ``xm`` with the norm ``nrm`` and
    the interval ``iv`` (or None), timed beside the plain version and a
    same-bytes PyTorch kernel, with the host's time per call."""
    import torch
    from repro_torch.kernels import pdq_prologue as pro
    Mx, K = xm.shape
    err = check_prologue(xm, nrm, iv, f"{label}({Mx}, {K})")
    blocks = () if iv is None else iv[1] or (1,)
    n_seg, cols = len(blocks), sum(blocks)
    b_ms, b_by = bound_ms(Mx * K * 3 + Mx * 12 + (0 if nrm is None else 2 * K)
                          + 8 * Mx * cols + 16 * n_seg,
                          (6 + (5 if nrm else 0)) * Mx * K, F32_OPS)
    mode = pro.mode_of(nrm, iv)
    record("pdq_prologue", f"{label}{mode}: x ({Mx}, {K}) bf16"
           + (f", {n_seg} segments, {cols} blocks" if iv else ""), err,
           median_ms(lambda: pro.pdq_prologue_cuda(xm, nrm, iv), flush=flush),
           median_ms(lambda: pro.pdq_prologue_plain(xm, nrm, iv), flush=flush),
           b_ms, b_by, None, primary, mode=mode,
           same_bytes_ms=median_ms(lambda: xm.to(torch.int8), flush=flush),
           host_us=host_us(lambda: pro.pdq_prologue_cuda(xm, nrm, iv)))


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


def k2_row(dev, label, rec, xin, per_block, primary, flush, record):
    """One K2 row: record ``rec`` on rows ``xin`` (per-128-column clamps
    if ``per_block``), each route against plain and each other, the
    requant codes, the health counters, and the times (``matmul_kernels``)."""
    import torch
    from repro_torch.kernels import w8a8_matmul as mm
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
    # the health counters: the epilogue's counts equal plain's, both routes
    tels = [torch.zeros(3, dtype=torch.int64, device=dev) for _ in range(3)]
    yt = mm.w8a8_matmul_cuda(*args, tel=tels[0], **kw)
    mm.w8a8_matmul_cuda(*args, route="generic", tel=tels[1], **kw)
    mm.w8a8_matmul_plain(*args, tel=tels[2], **kw)
    need(torch.equal(yt, yk) and torch.equal(tels[0], tels[2])
         and torch.equal(tels[1], tels[2]),
         f"K2 {label}: counts {[t.tolist() for t in tels]} (wgmma, generic, plain)")
    Mx, K = base[0].shape
    N = rec["q"].shape[1]
    E = lo.shape[1]
    # x_q, w_q, bf16 out, s_w, and per row s_x plus E (lo, hi) pairs
    b_ms, b_by = bound_ms(Mx * K + K * N + Mx * N * 2 + N * 4 + Mx * (4 + 8 * E),
                          2 * Mx * K * N, INT8_OPS)
    lib_ms, row_ms, note = library_int_mm(base[0], rec["q"], flush)
    record("w8a8_matmul", f"{label}: x ({Mx}, {K}) @ w ({K}, {N}), epilogue "
           f"({Mx}, {E}); plan {mm.wgmma_plan(Mx, K, N, False, mm._sms(dev))}"
           f"{'; ' + note if note else ''}", err,
           median_ms(lambda: mm.w8a8_matmul_cuda(*args, **kw), flush=flush),
           median_ms(lambda: mm.w8a8_matmul_plain(*args, **kw), flush=flush),
           b_ms, b_by, lib_ms, primary,
           generic_ms=median_ms(lambda: mm.w8a8_matmul_cuda(*args, route="generic", **kw),
                                flush=flush),
           library_rowmajor_ms=row_ms,
           tel_ms=median_ms(lambda: mm.w8a8_matmul_cuda(*args, tel=tels[0], **kw),
                            flush=flush),
           host_us=host_us(lambda: mm.w8a8_matmul_cuda(*args, **kw)),
           generic_host_us=host_us(lambda: mm.w8a8_matmul_cuda(*args, route="generic",
                                                               **kw)))


def k3_row(dev, gu, xin, primary, flush, record, stamps, label=""):
    """One K3 row: the gate/up record ``gu`` on rows ``xin``, each route
    against plain, the counters, the quantize tail and the times
    (``matmul_kernels``)."""
    import torch
    from repro_torch.kernels import w8a8_matmul as mm
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
    tels = [torch.zeros(3, dtype=torch.int64, device=dev) for _ in range(3)]
    mm.w8a8_swiglu_matmul_cuda(*sargs, tel=tels[0])
    mm.w8a8_swiglu_matmul_cuda(*sargs, route="generic", tel=tels[1])
    mm.w8a8_swiglu_matmul_plain(*sargs, tel=tels[2])
    need(torch.equal(tels[0], tels[2]) and torch.equal(tels[1], tels[2]),
         f"K3: counts {[t.tolist() for t in tels]} (wgmma, generic, plain)")
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
        st = stamps.view(-1, 2)[:mm.wgmma_plan(Mx, K, N, True, mm._sms(dev)).grid]
        tails.append(float(st[:, 1].max() - st[:, 0].max()) / 1e6)
    tails.sort()
    lib_ms, row_ms, note = library_int_mm(base[0], gu["q"], flush)
    record("w8a8_swiglu_matmul", f"{label}x ({Mx}, {K}) @ w ({K}, {N}); plan "
           f"{mm.wgmma_plan(Mx, K, N, True, mm._sms(dev))}; hsw code "
           f"mismatches {int((dq > 0).sum())}{'; ' + note if note else ''}", err,
           median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs), flush=flush),
           median_ms(lambda: mm.w8a8_swiglu_matmul_plain(*sargs), flush=flush),
           b_ms, b_by, lib_ms, primary,
           generic_ms=median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs,
                                                                   route="generic"),
                                flush=flush),
           library_rowmajor_ms=row_ms, tail_ms=tails[len(tails) // 2],
           tel_ms=median_ms(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs, tel=tels[0]),
                            flush=flush),
           host_us=host_us(lambda: mm.w8a8_swiglu_matmul_cuda(*sargs)),
           generic_host_us=host_us(lambda: mm.w8a8_swiglu_matmul_cuda(
               *sargs, route="generic")))


def matmul_kernels(eng, t, gen, flush, record, x_pre):
    """K2 and K3 at the shapes of ``eng``'s model (path A's, or H's), decode
    and prefill rows: each route against the plain version
    and against each other (equal bits but for K3's s1/s2, summed in
    another order), timed beside the plain version, ``torch._int_mm`` on
    both weight layouts and the bound; the host time per call of each
    route; K3's quantize tail from the kernel's own stamps."""
    import torch
    from repro_torch.kernels import w8a8_matmul as mm
    M, x = t["M"], t["x"]
    h_in = torch.randn((M, eng.cfg.d_ff), generator=gen,
                       device=eng.device).to(torch.bfloat16)
    h_pre = torch.randn((x_pre.shape[0], eng.cfg.d_ff), generator=gen,
                        device=eng.device).to(torch.bfloat16)
    cases = (("qkv", t["qkv"], x, True, True), ("wo", t["wo"], t["xo"], False, False),
             ("w_down", t["down"], h_in, False, False),
             ("qkv prefill", t["qkv"], x_pre, True, False),
             ("wo prefill", t["wo"], rows_for(x_pre, t["wo"], gen), False, False),
             ("w_down prefill", t["down"], h_pre, False, False))
    for label, rec, xin, per_block, primary in cases:
        k2_row(eng.device, label, rec, xin, per_block, primary, flush, record)

    # K3: gate/up (stablelm: (M, 2048) @ (2048, 11264)), decode and prefill rows
    gu = t["gu"]
    stamps = torch.zeros((2 * mm._sms(eng.device),), dtype=torch.int64, device=eng.device)
    for xin, primary in ((x, True), (x_pre, False)):
        k3_row(eng.device, gu, xin, primary, flush, record, stamps)

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


def fallback_kernels(eng, t, gen, flush, record, x_pre):
    """The predicated fp-dequant fallback at the guarded path's shapes: QKV
    (8, 2048) -> 6144 and w_down (8, 5632) -> 2048 at decode, QKV at
    prefill rows, bf16 in and out as path F runs it.  Taken (the flag set
    before each call, its one-element fill inside the timed call) against
    the plain version: within one bf16 rounding of the f32 product, summed
    in another order (one bf16 ulp, 2^-7 relative, apart where the two
    sums round to neighbours); the flag cleared and one fallback counted.  Not
    taken: y and the counters untouched.  Bound when taken: x, the int8
    weight and the scales read once, y written once, against 2 M N K f32
    operations; not taken: the flag's word read and written.  No single
    PyTorch call dequantizes an int8 weight and multiplies: library null."""
    import torch
    from repro_torch.kernels import fp_dequant as fd
    from repro_torch.kernels import ref
    h_in = torch.randn((t["M"], eng.cfg.d_ff), generator=gen,
                       device=eng.device).to(torch.bfloat16)
    cases = (("qkv", t["qkv"], t["x"], True), ("w_down", t["down"], h_in, False),
             ("qkv prefill", t["qkv"], x_pre, False))
    flag = fd.flag_buffer(eng.device)
    tel = torch.zeros(3, dtype=torch.int64, device=eng.device)
    for label, rec, x, primary in cases:
        (M, K), N = x.shape, rec["q"].shape[1]
        q, sc = rec["q"], rec["scale"]
        y0 = torch.randn((M, N), generator=gen, device=eng.device).to(torch.bfloat16)
        y = y0.clone()
        tel.zero_()
        fd.fp_dequant_fallback_cuda(y, x, q, sc, flag, tel)
        need(torch.equal(y, y0) and not bool(flag.any()) and not bool(tel.any()),
             f"fallback {label}: the untaken branch wrote y, the flag or the counters")
        flag[0] = 1
        fd.fp_dequant_fallback_cuda(y, x, q, sc, flag, tel)
        need(not bool(flag.any()) and tel.tolist() == [1, 0, 0],
             f"fallback {label}: flag {flag.tolist()}, counters {tel.tolist()} after a "
             f"taken call")
        p = y0.clone()
        fd.fp_dequant_fallback_plain(p, x, q, sc, torch.ones_like(flag))
        want = ref.fp_dequant_matmul(x, q, sc, torch.float32)
        err = max_abs(y, p)
        need(bool(((y.float() - p.float()).abs()
                   <= 2 ** -7 * p.float().abs() + 1e-5 * float(want.abs().max())).all()),
             f"fallback {label}: differs from plain by {err}")

        def taken():
            flag[:1].fill_(1)
            fd.fp_dequant_fallback_cuda(y, x, q, sc, flag)

        def taken_plain():
            flag[:1].fill_(1)
            fd.fp_dequant_fallback_plain(y, x, q, sc, flag)

        b_ms, b_by = bound_ms(M * K * 2 + K * N + 4 * N + M * N * 2 + 8, 2 * M * N * K,
                              F32_OPS)
        nt_ms = median_ms(lambda: fd.fp_dequant_fallback_cuda(y, x, q, sc, flag),
                          flush=flush)
        record("fp_dequant", f"{label}: taken, x ({M}, {K}) bf16 @ q ({K}, {N}) int8 "
               f"-> y bf16", err, median_ms(taken, flush=flush),
               median_ms(taken_plain, flush=flush), b_ms, b_by, None, primary,
               not_taken_ms=nt_ms,
               not_taken_plain_ms=median_ms(
                   lambda: fd.fp_dequant_fallback_plain(y, x, q, sc, flag), flush=flush),
               not_taken_bound_ms=bound_ms(8, 0, F32_OPS)[0],
               library_note="no single PyTorch call dequantizes and multiplies",
               host_us=host_us(lambda: fd.fp_dequant_fallback_cuda(y, x, q, sc, flag)))


def attend_kernels(eng, gen, flush, record):
    """K4 and K5 against their plain versions at the full-width decode
    shapes (B = slots, Hkv, G, Dh of the model, Sp of path A's cache,
    ATTEND_LENS), and at a long cache (Sp 4096, ATTEND_LONG_LENS) for the
    kernel table only (``attend_rows``)."""
    cfg = eng.cfg
    Sp = eng.caches["blocks"][0]["k"].shape[3]
    attend_rows(eng.device, eng.slots, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                cfg.hd, ((ATTEND_LENS, Sp, True), (ATTEND_LONG_LENS, ATTEND_LONG_SP, False)),
                gen, flush, record)


def attend_rows(dev, B, Hkv, G, Dh, cases, gen, flush, record):
    """K4 and K5 at (B, Hkv, G, Dh) for each (lengths, Sp, primary) of
    ``cases``; K5 with wo's prologue in bf16, as the main path runs it.
    Each on both routes: the split route (the one every path takes) and the
    single route (the first design), both within ATTEND_TOL of plain and of
    each other, the split route bit-equal over two launches with its
    tickets back at 0, both timed in this call."""
    import torch
    from repro_torch.kernels import kv_cache as kv
    for lens, sp, primary in cases:
        need(len(lens) == B and max(lens) <= sp,
             f"attend lengths {lens} do not fit B {B}, Sp {sp}")
        i8 = dict(dtype=torch.int8, device=dev, generator=gen)
        f = lambda *s: torch.rand(s, generator=gen, device=dev)      # noqa: E731
        args = (torch.randn((B, Hkv * G, Dh), generator=gen, device=dev),
                torch.randint(-127, 128, (B, Hkv, sp, Dh), **i8),
                torch.randint(-127, 128, (B, Hkv, sp, Dh), **i8),
                0.01 + 0.04 * f(B, Hkv, sp), 0.01 + 0.04 * f(B, Hkv, sp),
                torch.tensor(lens, dtype=torch.int32, device=dev))
        plan = kv.attend_plan(B, Hkv, G, sp, Dh)
        shape = (f"B {B} Hkv {Hkv} G {G} Dh {Dh} Sp {sp}, lengths {list(lens)} "
                 f"(sum {sum(lens)}); split plan {plan.splits} splits of {plan.chunk}, "
                 f"instance {kv.attend_instance(G, Dh)}")
        valid = sum(lens) * Hkv
        qo_bytes = 2 * B * Hkv * G * Dh * 4 + 4 * B        # q in, o out, length
        kv_bytes = valid * (2 * Dh + 8)                    # valid K/V rows + scales
        ops = valid * 4 * G * Dh                           # q.k and p.v, f32

        def close(a, b):
            return bool(torch.isclose(a, b, rtol=ATTEND_TOL, atol=ATTEND_TOL).all())

        def at_rest():
            torch.cuda.synchronize()
            return int(kv._tickets(dev, 1).abs().sum()) == 0

        ko = kv.decode_attend_i8kv_cuda(*args)
        need(torch.equal(ko, kv.decode_attend_i8kv_cuda(*args)) and at_rest(),
             "K4 split: two launches differ, or a ticket is left set")
        so = kv.decode_attend_i8kv_cuda(*args, route="single")
        po = kv.decode_attend_i8kv_plain(*args)
        need(close(ko, po) and close(so, po) and close(ko, so),
             "K4 o outside tolerance of plain or between the routes")
        b_ms, b_by = bound_ms(kv_bytes + qo_bytes, ops, F32_OPS)
        record("decode_attend_i8kv", shape, max_abs(ko, po),
               median_ms(lambda: kv.decode_attend_i8kv_cuda(*args), flush=flush),
               median_ms(lambda: kv.decode_attend_i8kv_plain(*args), flush=flush),
               b_ms, b_by, None, primary, single_err=max_abs(so, po),
               single_ms=median_ms(lambda: kv.decode_attend_i8kv_cuda(*args, route="single"),
                                   flush=flush))
        del ko, so, po

        pro = torch.bfloat16
        ko = kv.decode_attend_i8kv_fused_cuda(*args, pro)
        again = kv.decode_attend_i8kv_fused_cuda(*args, pro)
        need(all(torch.equal(u, v) for u, v in zip(ko, again)) and at_rest(),
             "K5 split: two launches differ, or a ticket is left set")
        so = kv.decode_attend_i8kv_fused_cuda(*args, pro, route="single")
        po = kv.decode_attend_i8kv_fused_plain(*args, pro)
        pf = po[0].reshape(B, -1).to(pro)
        mismatches = []
        for name, out in (("split", ko), ("single", so)):
            need(close(out[0], po[0]), f"K5 {name} o outside tolerance of plain")
            need(bool(torch.isclose(out[2], po[2], rtol=1e-5, atol=0).all()),
                 f"K5 {name} s_x outside rtol 1e-5 of plain")
            kf = out[0].reshape(B, -1).to(pro)
            same = (kf == pf) & (out[2] == po[2])
            dq = (out[1].int() - po[1].int()).abs()
            need(bool((dq[same] == 0).all()) and int(dq.max()) <= 1,
                 f"K5 {name} o_q differs from plain where o and s_x agree, or by > 1")
            # s1/s2 sum the kernel's own rounded o: within SUM_RTOL of those
            # sums, and of plain's within that plus the rounded rows' own
            # difference (o within ATTEND_TOL may round to a neighbouring
            # bf16 value; 0 where a row rounds alike)
            for i, (own, ref) in enumerate(((kf.float(), pf.float()),
                                            (kf.float() ** 2, pf.float() ** 2)), start=3):
                mag = own.abs().sum(-1, keepdim=True)
                apart = (own - ref).abs().sum(-1, keepdim=True)
                need(bool(((out[i] - own.sum(-1, keepdim=True)).abs() <= SUM_RTOL * mag).all())
                     and bool(((out[i] - po[i]).abs() <= SUM_RTOL * mag + apart).all()),
                     f"K5 {name} {'s1' if i == 3 else 's2'} outside tolerance")
            mismatches.append(int((dq > 0).sum()))
        need(close(ko[0], so[0]), "K5 o differs between the routes")
        b_ms, b_by = bound_ms(kv_bytes + qo_bytes + B * Hkv * G * Dh + 12 * B, ops, F32_OPS)
        record("decode_attend_i8kv_fused", f"{shape}, prologue in bf16; o_q code "
               f"mismatches split {mismatches[0]}, single {mismatches[1]}",
               max(max_abs(u, v) for u, v in zip(ko, po)),
               median_ms(lambda: kv.decode_attend_i8kv_fused_cuda(*args, pro), flush=flush),
               median_ms(lambda: kv.decode_attend_i8kv_fused_plain(*args, pro), flush=flush),
               b_ms, b_by, None, primary,
               single_err=max(max_abs(u, v) for u, v in zip(so, po)),
               single_ms=median_ms(lambda: kv.decode_attend_i8kv_fused_cuda(
                   *args, pro, route="single"), flush=flush))
        del ko, again, so, po, args
        torch.cuda.empty_cache()


def moved_bytes(moves, plans):
    """A movement's bytes for its bound: each visited row written once,
    each moved row read once (``kv.move_plan``), and each distinct map and
    row list on the card read once."""
    seen = {}
    for mv in moves:
        for t in (mv.map, mv.rows):
            if t is not None:
                seen[t.data_ptr()] = 4 * t.numel()
    return sum(p.bytes_written + p.bytes_read for p in plans) + sum(seen.values())


def time_movement(label, moves, count, flush, record, primary, name, lib_calls,
                  poison=False):
    """One movement (device ``moves``) as one launch against the plain
    version, bit for bit (with ``poison`` the kernel's destinations are set
    to 0xFF bytes first, so every byte the comparison reads was written),
    then timed: kernel, plain, and ``lib_calls`` (index_copy_ of the moved
    page rows of every leaf, in one timed region; null if None)."""
    import torch
    from repro_torch.kernels import kv_cache as kv

    def clones():
        out = []
        for mv in moves:
            d = mv.dst.clone()
            out.append(mv._replace(dst=d, src=d if mv.src is mv.dst else mv.src))
        return out

    plain = clones()
    kv.cache_move_plain(plain)
    kern = clones()
    if poison:
        for mv in kern:
            mv.dst.view(torch.uint8).fill_(0xFF)
    kv.cache_move_cuda(kern, count)
    torch.cuda.synchronize()
    for mv, w in zip(kern, plain):
        need(torch.equal(mv.dst.view(torch.uint8), w.dst.view(torch.uint8)),
             f"{name} {label}: leaf {tuple(mv.dst.shape)} {mv.dst.dtype} differs "
             f"from plain")
    err = 0.0                                   # bit-equal, checked above
    plans = kv.move_plan(moves)
    b_ms, b_by = bound_ms(moved_bytes(moves, plans), 0, INT8_OPS)
    k_ms = median_ms(lambda: kv.cache_move_cuda(kern, count), flush=flush)
    p_ms = median_ms(lambda: kv.cache_move_plain(plain), flush=flush)
    lib_ms = None if lib_calls is None else median_ms(
        lambda: [c() for c in lib_calls], flush=flush)
    runs = sum(p.runs for p in plans)
    record(name, f"{label}: {len(moves)} leaves, {runs} runs, "
           f"{sum(p.bytes_written for p in plans)} B written, "
           f"{sum(p.bytes_read for p in plans)} B read", err, k_ms, p_ms, b_ms,
           b_by, lib_ms, primary)
    del kern, plain


def index_copies(moves, to_rows):
    """The library yardstick of a movement's scatter part: per leaf,
    ``index_copy_`` along its batch axis of the moved page rows (selected
    beforehand) into dst's page rows (``to_rows`` lays a side out as page
    rows, a copy for a logical leaf)."""
    import torch
    calls = []
    for mv in moves:
        d_pr = to_rows(mv.dst, mv)
        m = mv.map
        d_rows = torch.nonzero(m >= 0).flatten()
        ax = mv.batch_axis
        sel = to_rows(mv.src, mv).index_select(ax, m[d_rows].long())
        calls.append(lambda d_pr=d_pr, d_rows=d_rows, sel=sel, ax=ax:
                     d_pr.index_copy_(ax, d_rows, sel))
    return calls


def page_rows(x, mv):
    """A side of page movement ``mv`` laid out as page rows: the pool's own
    leaf (or a flat leaf) as it is, a logical one as a contiguous copy."""
    from repro_torch.kernels import ref
    if mv.seq_axis is None or x.shape[mv.seq_axis] == PAGE:
        return x
    return ref.to_page_rows(x, mv.seq_axis, PAGE, batch_axis=mv.batch_axis).contiguous()


def page_kernels(eng, gen, flush, record):
    """K7, one launch per movement, against its plain version (each leaf's
    init fill, then the reference's composition through page rows) at path
    D1's profile shape, full width: the whole decode gather of 8 slots at
    position 300 (five leaves: pool (24, 65, 32, 64, 64) int8 k/v, f32
    scales, int32 pos -> the (24, 8, ...) logical tree, 5 of 8 pages from
    the pool, the rest the leaf's init fill) into a scratch poisoned with
    0xFF bytes, its write-back (one page per slot and leaf), the gather at
    ragged frontiers with two free slots, the COW copy of 8 pages, and the
    k leaf's gather alone (the pre-redesign kernel's unit).  Each bit-equal
    to plain.  Bound: ``kv.move_plan``'s bytes.  Library: ``index_copy_``
    of each leaf's moved page rows (``index_copies``; it writes no fill)."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    B, n_pp = eng.slots, eng.max_len // PAGE
    N = B * n_pp + 1
    po = eng.bundle.paged_cache(B, eng.max_len, PAGE)
    pool = po.init(N)
    for d in pool["blocks"]:
        for leaf in d.values():
            leaf.view(torch.uint8).copy_(torch.randint(
                0, 256, leaf.view(torch.uint8).shape, generator=gen, device=eng.device,
                dtype=torch.uint8))
    pt = (1 + np.arange(B * n_pp, dtype=np.int32)).reshape(B, n_pp)
    at300 = np.full((B,), 300, np.int32)

    logical, moves = po.gather_moves(pool, pt, at300)
    gather = ops.device_moves(moves)
    time_movement("D1 gather at position 300", gather, kv.PAGES_COUNT, flush, record,
                  True, "cache_scatter_pages", index_copies(gather, page_rows), poison=True)
    for mv in gather:
        mv.dst.copy_(torch.randint(-100, 100, mv.dst.shape, generator=gen,
                                   device=eng.device).to(mv.dst.dtype))
    wb = ops.device_moves(po.writeback_moves(pool, logical, pt, at300[:, None]))
    time_movement("D1 write-back at position 300", wb, kv.PAGES_COUNT, flush, record,
                  False, "cache_scatter_pages", index_copies(wb, page_rows))
    k_alone = [next(mv for mv in gather if mv.dst.dim() == 5)]
    time_movement("k gather alone", k_alone, kv.PAGES_COUNT, flush, record, False,
                  "cache_scatter_pages", index_copies(k_alone, page_rows), poison=True)
    del logical, moves, gather, wb
    torch.cuda.empty_cache()
    lens = np.asarray(ATTEND_LENS)
    rpt = pt.copy()
    rpt[B - 2:] = -1                           # two free slots
    _, moves = po.gather_moves(pool, rpt, lens)
    ragged = ops.device_moves(moves)
    time_movement(f"gather at ragged frontiers {tuple(int(x) for x in lens)}", ragged,
                  kv.PAGES_COUNT, flush, record, False, "cache_scatter_pages",
                  index_copies(ragged, page_rows), poison=True)
    del ragged
    del moves
    cmap = np.full((N,), -1, np.int32)
    cmap[N - 8:] = np.arange(1, 9)             # 8 fresh pages take 8 others
    copy = [kv.Move(p_, p_, batch_axis=1, host_map=cmap)
            for k, p_ in pool["blocks"][0].items()
            if po.meta["blocks"][0][k].kind == "seq"]
    copy = ops.device_moves(copy)
    time_movement("COW copy of 8 pages", copy, kv.PAGES_COUNT, flush, record, False,
                  "cache_scatter_pages", index_copies(copy, page_rows))
    del pool, copy
    torch.cuda.empty_cache()


def slot_row_kernels(eng, gen, flush, record):
    """K6: one admission round's landing into path A's slot-row pool, its
    six leaves (k, v, k_scale, v_scale, pos, len) in one launch, 4 of 8
    slots landed; then the k and pos leaves alone (the pre-redesign
    kernel's unit).  Library: ``index_copy_`` of the landed rows of every
    leaf in one timed region."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    pool = eng.bundle.init_caches(eng.slots, eng.max_len)["blocks"][0]
    sub = eng.bundle.init_caches(eng.slots, eng.max_len)["blocks"][0]
    for leaf in sub.values():
        leaf.view(torch.uint8).copy_(torch.randint(
            0, 256, leaf.view(torch.uint8).shape, generator=gen, device=eng.device,
            dtype=torch.uint8))
    smap = np.array([2, -1, 0, 1, -1, 3, -1, -1], np.int32)[:eng.slots]
    moves = ops.device_moves([kv.Move(pool[k], sub[k], batch_axis=1, host_map=smap)
                              for k in pool])
    time_movement("one round's landing, 4 of 8 slots", moves, kv.COUNT, flush, record,
                  True, "cache_scatter", index_copies(moves, lambda x, mv: x))
    for k in ("k", "pos"):
        mv = moves[list(pool).index(k)]
        time_movement(f"{k} leaf alone, {tuple(mv.dst.shape)} {mv.dst.dtype}", [mv],
                      kv.COUNT, flush, record, False, "cache_scatter",
                      index_copies([mv], lambda x, mv: x))
    del pool, sub, moves
    torch.cuda.empty_cache()


def h_kernels(cfg, detail):
    """The kernel phase at gemma3-12b's shapes (rows tagged "H", kept in
    ``detail``, none the JSON line's primary row): K4 and K5 at its global
    layers' cache (B 8, Hkv 8, G 2, Dh 256, Sp H_MAX_LEN, H_ATTEND_LENS: the
    wide instance); K6 landing one of H's rounds, 4 of 8 slots, all 36
    leaves of the int8 pool's six kinds in one launch; K7 HD's decode
    gather (the global layers' five paged leaves, page 64) at the frontiers
    of H's prompts 16 tokens into decode.  Library: ``index_copy_`` of
    every leaf's moved rows (K6/K7)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, quant_kv="dynamic")
    bundle = build_model(cfg, "cuda")
    dev, B = bundle.device, 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    record = recorder({}, detail, path="H")
    attend_rows(dev, B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                ((H_ATTEND_LENS, H_MAX_LEN, False),), gen, flush, record)

    def randomize(tree):
        for d in tree["blocks"]:
            for leaf in d.values():
                leaf.view(torch.uint8).copy_(torch.randint(
                    0, 256, leaf.view(torch.uint8).shape, generator=gen, device=dev,
                    dtype=torch.uint8))

    pool, sub = bundle.init_caches(B, H_MAX_LEN), bundle.init_caches(B, H_MAX_LEN)
    randomize(sub)
    smap = np.array([2, -1, 0, 1, -1, 3, -1, -1], np.int32)
    moves = ops.device_moves([kv.Move(c[k], s_[k], batch_axis=1, host_map=smap)
                              for c, s_ in zip(pool["blocks"], sub["blocks"]) for k in c])
    need(len(moves) == 6 * len(cfg.pattern), f"H's pool has {len(moves)} leaves")
    time_movement(f"H: one round's landing, {len(moves)} leaves ({len(cfg.pattern)} "
                  f"kinds), 4 of 8 slots", moves, kv.COUNT, flush, record, False,
                  "cache_scatter", index_copies(moves, lambda x, mv: x))
    del pool, sub, moves
    torch.cuda.empty_cache()
    po = bundle.paged_cache(B, H_MAX_LEN, PAGE)
    n_pp = H_MAX_LEN // PAGE
    pool = po.init(B * n_pp + 1)
    randomize(pool)
    pt = (1 + np.arange(B * n_pp, dtype=np.int32)).reshape(B, n_pp)
    lens = np.asarray(H_PROMPTS, np.int32) + 16

    _, moves = po.gather_moves(pool, pt, lens)
    gather = ops.device_moves(moves)
    time_movement(f"HD gather at frontiers {tuple(int(x) for x in lens)}", gather,
                  kv.PAGES_COUNT, flush, record, False, "cache_scatter_pages",
                  index_copies(gather, page_rows), poison=True)
    del pool, moves, gather
    torch.cuda.empty_cache()


def h_dense_kernels(eng, detail):
    """K1, K2 and K3 at gemma3-12b's shapes, on H's own PDQ records (layer
    0's) at decode rows (8 slots) and prefill rows (8 x the 256-token
    chunk): QKV (3840 -> 8192 in three unequal segments, 4096/2048/2048),
    wo (4096 -> 3840; K1's interval mode at 4096 as H's local layers run
    it), gate/up + SwiGLU (3840 -> 2 x 15360, whose epilogue runs w_down's
    prologue over the 15360-wide row) and w_down (15360 -> 3840), each held
    against its plain version with A's tolerances (``prologue_kernels``,
    ``matmul_kernels``); rows tagged "H"."""
    import torch
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(2468)
    t = kernel_inputs(eng, gen)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=eng.device)
    record = recorder({}, detail, path="H")
    x_pre = torch.randn((eng.slots * 256, t["d"]), generator=gen,
                        device=eng.device).to(torch.bfloat16)
    prologue_kernels(eng, t, gen, flush, record, x_pre)
    matmul_kernels(eng, t, gen, flush, record, x_pre)
    del t, x_pre, flush
    torch.cuda.empty_cache()


def phase_gemma3(detail):
    """Paths H, HD, HB and HBW: gemma3-12b at full width on seeded random
    bf16 weights, its kernel rows (``h_kernels``) first and K1-K3's on H's
    records once H's engine has made them (``h_dense_kernels``).  H's engine
    quantizes them (PDQ-int8 in every layer) and the bf16 tree is dropped;
    HD, HB and HBW serve H's records.  Returns (counts, serve runs,
    parity)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    cfg = get_config(H_ARCH)
    t0 = time.perf_counter()
    weights = {"bf16": build_model(cfg, "cuda").init(0)}
    torch.cuda.synchronize()
    log(f"model H: {cfg.name} {cfg.n_layers} layers (pattern {cfg.pattern}, window "
        f"{cfg.window}) d_model {cfg.d_model} {cfg.n_heads} x {cfg.hd} heads, "
        f"{cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}: random "
        f"bf16 weights in {time.perf_counter() - t0:.1f} s")
    with timed("kernels H"):
        h_kernels(cfg, detail)
    counts, serve, parity = {}, {}, {}
    for path in H_PATHS:
        int8_kv, pdq, _, extra = PATHS[path]
        need(pdq, f"{path}: the H paths serve PDQ records")
        t0 = time.perf_counter()
        quantize = "pdq" not in weights
        eng = build_engine(ServeConfig(arch=H_ARCH, reduced=False, slots=8,
                                       max_len=H_MAX_LEN, int8_kv=int8_kv,
                                       quantize_weights=quantize, device="cuda", **extra),
                           cfg=cfg, params=weights["bf16" if quantize else "pdq"])
        if quantize:                   # the later engines serve H's records
            weights = {"pdq": eng.params}
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        log(f"model {path}: {cfg.name}, PDQ-int8 weights "
            f"({'quantized by this engine' if quantize else 'the records of H'}), "
            f"{'int8' if int8_kv else 'bf16'} KV cache, "
            f"{f'paged pool of {eng.pool_pages} pages of {PAGE}' if eng.paged else 'slot rows'}, "
            f"buckets {eng.buckets}{' chunked' if eng.chunked_prefill else ''}, built in "
            f"{time.perf_counter() - t0:.1f} s, its decode graph captured in "
            f"{eng._graph.capture_s:.2f} s (pool {eng._graph.pool_bytes / 2**20:.1f} MiB); "
            f"card memory allocated {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
        if path == "H":
            with timed("kernels H dense"):
                h_dense_kernels(eng, detail)
        with timed(f"serve {path}"):
            counts[path], run = phase_serve(eng, path)
        if path == "H":
            with timed("step H"):
                run["step"] = phase_step(eng, path, run["decode_step_median_ms"])
            with timed("parity H"):
                parity[path], run["parity_pdq"] = phase_parity(eng, path)
        if path == "HD":
            check_paged_run(path, run, serve["H"][0], ref="H")
        if path == "HBW":
            run["twin"] = check_chunked_twin(eng, run, serve["HB"][0])
        serve[path] = [run]
        del eng
        torch.cuda.empty_cache()
    return counts, serve, parity


def landing_moves(bundle, B, max_len, gen, smap, mem_len=0):
    """A round's landing into a fresh slot-row pool of ``bundle``'s model
    from a random sub pool, every leaf of every section (head and tail
    layers at batch axis 0, the stacked blocks at 1; an encoder-decoder's
    ``mem_len`` rows of cross K/V included), as device moves."""
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    pool = bundle.init_caches(B, max_len, mem_len)
    sub = bundle.init_caches(B, max_len, mem_len)
    moves = []
    for sec, ba in (("head", 0), ("tail", 0), ("blocks", 1)):
        for c, s_ in zip(pool[sec], sub[sec]):
            for k in c:
                s_[k].view(torch.uint8).copy_(torch.randint(
                    0, 256, s_[k].view(torch.uint8).shape, generator=gen,
                    device=s_[k].device, dtype=torch.uint8))
                moves.append(kv.Move(c[k], s_[k], batch_axis=ba, host_map=smap))
    return ops.device_moves(moves)


def moe_kernels(eng, path, detail):
    """Phase 2 at a MoE path's shapes (rows tagged with ``path``), on the
    engine's own PDQ records (its first MoE layer's; deepseek's layer 0 has
    the same MLA shapes) at decode rows (8 slots) and prefill rows (8 x
    the 256 bucket).  DS: K1 on MLA's grouped (wq_a, wkv_a) (5120 -> 1536 |
    576, padded to 640) with the attention norm, wq_b with q_norm (1536),
    wo's interval over the 16384-wide row, wk_b's interval on ckv (512
    wide) at prefill and over a chunk continuation's whole buffer (8 x
    2048 rows), the shared experts' gate/up (2 x 12288); K2 on each of
    those records, wk_b at the continuation's 16384 rows, the shared
    w_down (12288 -> 5120); K3 the shared gate/up + SwiGLU; K6 a round's
    landing over the head layer's and the blocks' MLA leaves (8, one
    launch).  DSD: K7 its decode gather at H's frontiers + 16.  AR: K1 on
    QKV (7168 -> 7168 | 1024 | 1024) with the norm and the dense MLP's
    gate/up (2 x 4864); K2 QKV, wo (7168), w_down (4864 -> 7168); K3 the
    dense gate/up; K4 and K5 at G 7, Dh 128, Sp 512 (the (8, 128)
    instance); K6 a round's six leaves.  Each against its plain version as
    A's rows are (``k1_row``, ``k2_row``, ``k3_row``, ``attend_rows``,
    ``time_movement``); library: ``torch._int_mm``, ``index_copy_``."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    from repro_torch.kernels import w8a8_matmul as mm
    dev, cfg, M = eng.device, eng.cfg, eng.slots
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    record = recorder({}, detail, path=path)
    stamps = torch.zeros((2 * mm._sms(dev),), dtype=torch.int64, device=dev)

    def rows(n, k):
        return torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)

    def norm(k):
        w = (0.2 * torch.randn((k,), generator=gen, device=dev)).to(torch.bfloat16)
        return (w, cfg.norm_eps)

    def grouped(rec):
        return (rec, ops._blocks(rec["segs"]))

    layer = eng.params["blocks"][0]
    att = layer["attn"]
    mlp = layer["ffn"]["shared" if cfg.moe.n_shared else "dense"]
    gu, down = mlp["w_gate"]["group"], mlp["w_down"]
    tag = "shared" if cfg.moe.n_shared else "dense"
    x, x_pre = rows(M, cfg.d_model), rows(M * 256, cfg.d_model)
    if path == "DSD":
        po = eng._paged_ops
        n_pp = eng.max_len // PAGE
        pool = po.init(M * n_pp + 1)
        for _, _, leaf in _pool_leaves(pool):
            leaf.view(torch.uint8).copy_(torch.randint(
                0, 256, leaf.view(torch.uint8).shape, generator=gen, device=dev,
                dtype=torch.uint8))
        pt = (1 + np.arange(M * n_pp, dtype=np.int32)).reshape(M, n_pp)
        lens = np.asarray(H_PROMPTS, np.int32) + 16

        _, moves = po.gather_moves(pool, pt, lens)
        gather = ops.device_moves(moves)
        time_movement(f"DSD gather at frontiers {tuple(int(v) for v in lens)}", gather,
                      kv.PAGES_COUNT, flush, record, False, "cache_scatter_pages",
                      index_copies(gather, page_rows), poison=True)
        del pool, moves, gather
        torch.cuda.empty_cache()
        return
    if cfg.mla is not None:
        m, H = cfg.mla, cfg.n_heads
        grp = att["wq_a"]["group"]
        qa, xo = rows(M, m.q_lora), rows(M, H * m.v_head)
        xo_pre, ckv_pre = rows(M * 256, H * m.v_head), rows(M * 256, m.kv_lora)
        ckv_buf = rows(M * eng.max_len, m.kv_lora)
        for xm, nrm, iv, label in ((x, norm(cfg.d_model), grouped(grp), "MLA q_a|kv_a "),
                                   (x_pre, norm(cfg.d_model), grouped(grp),
                                    "MLA q_a|kv_a prefill "),
                                   (qa, norm(m.q_lora), (att["wq_b"], None), "wq_b "),
                                   (xo, None, (att["wo"], None), "wo "),
                                   (xo_pre, None, (att["wo"], None), "wo prefill "),
                                   (ckv_pre, None, (att["wk_b"], None), "wk_b on ckv "),
                                   (ckv_buf, None, (att["wk_b"], None),
                                    "wk_b on a continuation's buffer "),
                                   (x, None, grouped(gu), f"{tag} gate/up ")):
            k1_row(xm, nrm, iv, False, flush, record, label=label)
        k2_cases = (("MLA q_a|kv_a", grp, x, True), ("MLA q_a|kv_a prefill", grp, x_pre, True),
                    ("wq_b", att["wq_b"], qa, False), ("wo", att["wo"], xo, False),
                    ("wo prefill", att["wo"], xo_pre, False),
                    ("wk_b on a continuation's buffer", att["wk_b"], ckv_buf, False))
        del ckv_pre
    else:
        qkv = att["wq"]["group"]
        xo = rows(M, cfg.n_heads * cfg.hd)
        for xm, nrm, iv, label in ((x, norm(cfg.d_model), grouped(qkv), "QKV "),
                                   (x_pre, norm(cfg.d_model), grouped(qkv), "QKV prefill "),
                                   (x, None, grouped(gu), f"{tag} gate/up ")):
            k1_row(xm, nrm, iv, False, flush, record, label=label)
        k2_cases = (("QKV", qkv, x, True), ("QKV prefill", qkv, x_pre, True),
                    ("wo", att["wo"], xo, False))
    h_in = rows(M, down["q"].shape[0])
    for label, rec, xin, per_block in k2_cases + ((f"{tag} w_down", down, h_in, False),):
        k2_row(dev, label, rec, xin, per_block, False, flush, record)
    for xin in (x, x_pre):
        k3_row(dev, gu, xin, False, flush, record, stamps, label=f"{tag} gate/up: ")
    del x, x_pre, h_in
    torch.cuda.empty_cache()
    if cfg.mla is None:
        Sp = eng.caches["blocks"][0]["k"].shape[3]
        attend_rows(dev, M, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                    ((AR_ATTEND_LENS, Sp, False),), gen, flush, record)
    smap = np.array([2, -1, 0, 1, -1, 3, -1, -1], np.int32)[:M]
    moves = landing_moves(eng.bundle, M, eng.max_len, gen, smap)
    time_movement(f"{path}: one round's landing, 4 of {M} slots", moves, kv.COUNT, flush,
                  record, False, "cache_scatter", index_copies(moves, lambda t, mv: t))
    del moves
    torch.cuda.empty_cache()


def _pool_leaves(tree):
    """(section, index, leaf) over a cache-shaped tree."""
    for sec in ("head", "tail", "blocks"):
        for i, d in enumerate(tree[sec]):
            for leaf in d.values():
                yield sec, i, leaf


def param_bytes(tree) -> int:
    """The bytes of every tensor in a param tree, each counted once."""
    import torch
    seen, stack = {}, [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif torch.is_tensor(t):
            seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


def phase_moe(detail, models=(DS_ARCH, AR_ARCH)):
    """Paths DS and DSD (deepseek-v2-236b cut to DS_LAYERS layers) and AR
    (arctic-480b cut to AR_LAYERS): full width on seeded random bf16
    weights; the first engine of a model quantizes them (PDQ-int8 in every
    2-D projection; the expert stacks stay bf16, as in the reference) and
    the bf16 tree is dropped; DSD serves DS's records.  Each path: its
    kernel rows (``moe_kernels``), phase 3 (serve, census), phase 4
    (step, with ``step_split``) and phase 5 (parity, with the expert flips
    reported); DSD's streams must equal DS's.  Returns (counts, serve
    runs, parity)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    counts, serve, parity = {}, {}, {}
    for arch, n_layers, max_len, paths in ((DS_ARCH, DS_LAYERS, DS_MAX_LEN, ("DS", "DSD")),
                                           (AR_ARCH, AR_LAYERS, AR_MAX_LEN, ("AR",))):
        if arch not in models:
            continue
        # engines sit in reference cycles: collect the earlier paths' ones
        # before this model's weights (arctic's take ~55 GB)
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers).validate()
        t0 = time.perf_counter()
        weights = {"bf16": build_model(cfg, "cuda").init(0)}
        torch.cuda.synchronize()
        log(f"model {arch}: {cfg.n_layers} of its published layers (head {cfg.head}, "
            f"pattern {cfg.pattern} x {cfg.n_blocks}), d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads, MoE {cfg.moe}, MLA {cfg.mla}, vocab {cfg.vocab}: random "
            f"bf16 weights, {param_bytes(weights['bf16']) / 1e9:.2f} GB, in "
            f"{time.perf_counter() - t0:.1f} s")
        for path in paths:
            int8_kv, pdq, _, extra = PATHS[path]
            t0 = time.perf_counter()
            quantize = "pdq" not in weights
            eng = build_engine(ServeConfig(arch=arch, reduced=False, slots=8, max_len=max_len,
                                           int8_kv=int8_kv, quantize_weights=quantize,
                                           device="cuda", **extra),
                               cfg=cfg, params=weights["bf16" if quantize else "pdq"])
            if quantize:                   # DSD serves DS's records
                weights = {"pdq": eng.params}
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            log(f"model {path}: {cfg.name} cut to {cfg.n_layers} layers, PDQ-int8 "
                f"projections ({param_bytes(eng.params) / 1e9:.2f} GB of params, the "
                f"experts bf16), {'int8' if int8_kv else 'bf16'} "
                f"{'MLA ' if cfg.mla else ''}KV cache, "
                f"{f'paged pool of {eng.pool_pages} pages of {PAGE}' if eng.paged else 'slot rows'}, "
                f"buckets {eng.buckets}{' chunked' if eng.chunked_prefill else ''}, built in "
                f"{time.perf_counter() - t0:.1f} s, its decode graph captured in "
                f"{eng._graph.capture_s:.2f} s (pool {eng._graph.pool_bytes / 2**20:.1f} MiB); "
                f"card memory allocated {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
            with timed(f"kernels {path}"):
                moe_kernels(eng, path, detail)
            with timed(f"serve {path}"):
                counts[path], run = phase_serve(eng, path)
            with timed(f"step {path}"):
                run["step"] = phase_step(eng, path, run["decode_step_median_ms"])
            with timed(f"parity {path}"):
                parity[path], run["parity_pdq"] = phase_parity(eng, path)
            if path == "DSD":
                check_paged_run(path, run, serve["DS"][0], ref="DS")
            run["memory_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            serve[path] = [run]
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return counts, serve, parity


def ssm_kernels(eng, path, detail):
    """Phase 2 at an SSD path's shapes (rows tagged with ``path``), on the
    engine's own PDQ records (its first mamba layer's; zamba2's shared
    block) at decode rows (8 slots) and prefill rows (8 x the 256 bucket).
    M: K1 on ``in_proj`` with the layer's RMSNorm (2560 -> 10576: 82
    column tiles and 80 columns) and on ``out_proj`` with the gated RMSNorm
    (5120 -> 2560); K2 on both; K6 a round's landing of the 64 layers'
    conv and f32 state (2 leaves).  Z: the same at 3584 -> 14576 (113 tiles
    and 112 columns) and 7168 -> 3584, the shared block's QKV (3 x 3584,
    with its norm), wo, gate/up (2 x 14336) and w_down; K3 on the shared
    gate/up; K4 and K5 at G 1, Dh 112, Sp 512 (the (8, 128) instance); K6 a
    round's 22 leaves.  ZD: K7 a round's landing (the conv and state leaves
    as slot rows beside the shared occurrences' pages, one launch) and its
    decode gather at A's frontiers + 16.  Each against its plain version as
    A's rows are; library: ``torch._int_mm``, ``index_copy_``."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    from repro_torch.kernels import w8a8_matmul as mm
    dev, cfg, M = eng.device, eng.cfg, eng.slots
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    record = recorder({}, detail, path=path)

    def rows(n, k):
        return torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)

    def randomize(tree):
        for _, _, leaf in _pool_leaves(tree):
            leaf.view(torch.uint8).copy_(torch.randint(
                0, 256, leaf.view(torch.uint8).shape, generator=gen, device=dev,
                dtype=torch.uint8))
        return tree

    smap = np.array([2, -1, 0, 1, -1, 3, -1, -1], np.int32)[:M]
    if path == "ZD":
        paged_kernel_rows(eng, path, gen, flush, record, randomize, smap,
                          [len(r.prompt) + 16 for r in make_requests(cfg)])
        return
    stamps = torch.zeros((2 * mm._sms(dev),), dtype=torch.int64, device=dev)
    d, di = cfg.d_model, cfg.ssm.d_inner
    layer = eng.params["blocks"][cfg.pattern.index("mamba")]
    inp, outp = layer["ssm"]["in_proj"], layer["ssm"]["out_proj"]

    def norm(k):
        w = (0.2 * torch.randn((k,), generator=gen, device=dev)).to(torch.bfloat16)
        return (w, cfg.norm_eps)

    x, x_pre = rows(M, d), rows(M * 256, d)
    y, y_pre = rows(M, di), rows(M * 256, di)
    k1 = [(x, norm(d), (inp, None), "in_proj "), (x_pre, norm(d), (inp, None),
                                                  "in_proj prefill "),
          (y, norm(di), (outp, None), "out_proj "), (y_pre, norm(di), (outp, None),
                                                      "out_proj prefill ")]
    k2 = [("in_proj", inp, x, False), ("in_proj prefill", inp, x_pre, False),
          ("out_proj", outp, y, False), ("out_proj prefill", outp, y_pre, False)]
    shared = eng.params.get("shared_block")
    if shared is not None:
        qkv, gu = shared["attn"]["wq"]["group"], shared["ffn"]["w_gate"]["group"]
        wo, down = shared["attn"]["wo"], shared["ffn"]["w_down"]
        k1 += [(x, norm(d), (qkv, ops._blocks(qkv["segs"])), "shared QKV "),
               (x, norm(d), (gu, ops._blocks(gu["segs"])), "shared gate/up ")]
        k2 += [("shared QKV", qkv, x, True), ("shared wo", wo, rows(M, wo["q"].shape[0]),
                                              False),
               ("shared w_down", down, rows(M, down["q"].shape[0]), False)]
    for xm, nrm, iv, label in k1:
        k1_row(xm, nrm, iv, False, flush, record, label=label)
    for label, rec, xin, per_block in k2:
        k2_row(dev, label, rec, xin, per_block, False, flush, record)
    del x_pre, y_pre
    if shared is not None:
        for xin in (x, rows(M * 256, d)):
            k3_row(dev, gu, xin, False, flush, record, stamps, label="shared gate/up: ")
        j = cfg.pattern.index("shared")
        Sp = eng.caches["blocks"][j]["k"].shape[3]
        attend_rows(dev, M, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                    ((Z_ATTEND_LENS, Sp, False),), gen, flush, record)
    torch.cuda.empty_cache()
    moves = landing_moves(eng.bundle, M, eng.max_len, gen, smap)
    time_movement(f"{path}: one round's landing, 4 of {M} slots", moves, kv.COUNT, flush,
                  record, False, "cache_scatter", index_copies(moves, lambda t, mv: t))
    del moves
    torch.cuda.empty_cache()


def phase_ssm(detail):
    """Paths M (mamba2-2.7b) and Z, ZD (zamba2-7b): full width and full
    depth on seeded random bf16 weights; the first engine of a model
    quantizes them (PDQ-int8 in every in_proj / out_proj and the shared
    block's projections; the conv, A, D, dt_bias and the norms stay fp, as
    in the reference) and the bf16 tree is dropped; ZD serves Z's records.
    Each path: its kernel rows (``ssm_kernels``), phase 3 (serve, census);
    M and Z also phase 4 (step, with ``step_split``: the SSD blocks against
    the hand kernels) and phase 5 (parity); ZD's streams must equal Z's.
    Returns (counts, serve runs, parity)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    counts, serve, parity = {}, {}, {}
    for arch, max_len, paths in ((M_ARCH, M_MAX_LEN, ("M",)),
                                 (Z_ARCH, Z_MAX_LEN, ("Z", "ZD"))):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        weights = {"bf16": build_model(cfg, "cuda").init(0)}
        torch.cuda.synchronize()
        log(f"model {arch}: {cfg.n_layers} layers (head {cfg.head}, pattern {cfg.pattern} "
            f"x {cfg.n_blocks}, tail {cfg.tail}), d_model {cfg.d_model}, SSM {cfg.ssm} "
            f"({cfg.ssm.n_heads} heads), {cfg.n_heads} x {cfg.hd} attention heads, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}: random bf16 weights, "
            f"{param_bytes(weights['bf16']) / 1e9:.2f} GB, in "
            f"{time.perf_counter() - t0:.1f} s")
        for path in paths:
            int8_kv, pdq, _, extra = PATHS[path]
            t0 = time.perf_counter()
            quantize = "pdq" not in weights
            eng = build_engine(ServeConfig(arch=arch, reduced=False, slots=8, max_len=max_len,
                                           int8_kv=int8_kv, quantize_weights=quantize,
                                           device="cuda", **extra),
                               cfg=cfg, params=weights["bf16" if quantize else "pdq"])
            if quantize:                   # ZD serves Z's records
                weights = {"pdq": eng.params}
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            log(f"model {path}: {cfg.name}, {cfg.n_layers} layers, PDQ-int8 projections "
                f"({param_bytes(eng.params) / 1e9:.2f} GB of params), "
                f"{'int8 KV cache, ' if int8_kv and 'shared' in cfg.pattern else ''}"
                f"{f'paged pool of {eng.pool_pages} pages of {PAGE}' if eng.paged else 'slot rows'}, "
                f"buckets {eng.buckets}{' chunked' if eng.chunked_prefill else ''}, built in "
                f"{time.perf_counter() - t0:.1f} s, its decode graph captured in "
                f"{eng._graph.capture_s:.2f} s (pool {eng._graph.pool_bytes / 2**20:.1f} MiB); "
                f"card memory allocated {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
            with timed(f"kernels {path}"):
                ssm_kernels(eng, path, detail)
            with timed(f"serve {path}"):
                counts[path], run = phase_serve(eng, path)
            if path != "ZD":
                with timed(f"step {path}"):
                    run["step"] = phase_step(eng, path, run["decode_step_median_ms"])
                with timed(f"parity {path}"):
                    parity[path], run["parity_pdq"] = phase_parity(eng, path)
            else:
                check_paged_run(path, run, serve["Z"][0], ref="Z")
            run["memory_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            serve[path] = [run]
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return counts, serve, parity


def path_extras(path, cfg):
    """The prefill extras a V or S path serves with: the config's stub
    patches or S_FRAMES frames (``models.frontend.stub_extras``), drawn in
    the model dtype from a generator seeded 97 on the card; None
    elsewhere."""
    import torch
    from repro_torch.models import frontend
    if path not in EXTRAS_PATHS:
        return None
    need(frontend.N_FRAMES == S_FRAMES, f"the engine serves {frontend.N_FRAMES} frames")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(97)
    return frontend.stub_extras(cfg, gen)


def paged_kernel_rows(eng, path, gen, flush, record, randomize, smap, frontier):
    """K7 on a paged path's pool: a round's landing (4 of the slots, every
    page, the flat leaves as slot rows in the same launch) and a decode
    gather at each row's ``frontier`` (tokens written), both bit-equal to
    plain, beside ``index_copy_``."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    po, M = eng._paged_ops, eng.slots
    N = M * po.n_pp + 1
    pool = randomize(po.init(N))
    sub = randomize(eng.bundle.init_caches(M, eng.max_len, eng.mem_len))
    land_rows, land_js = np.full((N,), -1, np.int32), np.full((N,), -1, np.int32)
    land_rows[1:1 + 4 * po.n_pp] = np.repeat(np.arange(4), po.n_pp)
    land_js[1:1 + 4 * po.n_pp] = np.tile(np.arange(po.n_pp), 4)
    land = ops.device_moves(po.land_moves(pool, sub, smap, land_rows, land_js))
    time_movement(f"{path}: one round's landing, 4 of {M} slots, every page", land,
                  kv.PAGES_COUNT, flush, record, False, "cache_scatter_pages",
                  index_copies(land, page_rows))
    del land, sub
    pt = (1 + np.arange(M * po.n_pp, dtype=np.int32)).reshape(M, po.n_pp)
    lens = np.asarray(frontier, np.int32)
    _, moves = po.gather_moves(pool, pt, lens)
    gather = ops.device_moves(moves)
    time_movement(f"{path} gather at frontiers {tuple(int(v) for v in lens)}", gather,
                  kv.PAGES_COUNT, flush, record, False, "cache_scatter_pages",
                  index_copies(gather, page_rows), poison=True)
    del pool, moves, gather
    torch.cuda.empty_cache()


def extras_kernels(eng, path, detail):
    """Phase 2 at the extras paths' shapes (rows tagged with ``path``), on
    the engine's own PDQ records (decoder layer 0's) at decode rows (8
    slots) and prefill rows.  V (phi-3-vision-4.2b): K1 on QKV (3072 -> 3 x
    3072, with the norm) at decode rows and at 8 x (1024 patches + the 256
    bucket) prefill rows, and on gate/up; K2 on QKV, wo and w_down
    (8192 -> 3072) at decode, QKV at prefill; K3 on gate/up (3072 -> 2 x
    8192) at both; K4/K5 at G 1, Dh 96, Sp 1536 (the (8, 128) instance); K6
    a round's landing.  S (seamless-m4t-medium): K1 on QKV, the cross
    block's wq with its cross_norm and its (wk, wv) group at the memory's
    rows (8 slots x 8 frames; the interval alone), and gate/up; K2 on QKV,
    cross (wk, wv) (1024 -> 2 x 1024), cross wq, cross wo and w_down at
    decode, QKV at 8 x 256 prefill rows; K3 on gate/up (1024 -> 2 x 4096);
    K4/K5 at Hkv 16, G 1, Dh 64, Sp 512; K6 a round's landing with the
    cross leaves.  VD, SD: K7 a round's landing and a decode gather (SD's
    cross leaves as slot rows beside the pages).  Each against its plain
    version as A's rows are; library: ``torch._int_mm``, ``index_copy_``."""
    import numpy as np
    import torch
    from repro_torch.kernels import kv_cache as kv
    from repro_torch.kernels import ops
    from repro_torch.kernels import w8a8_matmul as mm
    dev, cfg, M = eng.device, eng.cfg, eng.slots
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    record = recorder({}, detail, path=path)
    P = cfg.frontend_tokens if cfg.frontend == "vision" else 0

    def rows(n, k):
        return torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)

    def randomize(tree):
        for _, _, leaf in _pool_leaves(tree):
            leaf.view(torch.uint8).copy_(torch.randint(
                0, 256, leaf.view(torch.uint8).shape, generator=gen, device=dev,
                dtype=torch.uint8))
        return tree

    smap = np.array([2, -1, 0, 1, -1, 3, -1, -1], np.int32)[:M]
    if eng.paged:
        frontier = [P + len(r.prompt) + 16 for r in make_requests(cfg)]
        paged_kernel_rows(eng, path, gen, flush, record, randomize, smap, frontier)
        return
    stamps = torch.zeros((2 * mm._sms(dev),), dtype=torch.int64, device=dev)
    d = cfg.d_model
    layer = eng.params["blocks"][0]
    qkv, gu = layer["attn"]["wq"]["group"], layer["ffn"]["w_gate"]["group"]
    wo, down = layer["attn"]["wo"], layer["ffn"]["w_down"]
    w = (0.2 * torch.randn((d,), generator=gen, device=dev)).to(torch.bfloat16)
    norm = (w, cfg.norm_eps)
    x, x_pre = rows(M, d), rows(M * (P + 256), d)
    k1 = [(x, norm, (qkv, ops._blocks(qkv["segs"])), "QKV "),
          (x_pre, norm, (qkv, ops._blocks(qkv["segs"])), "QKV prefill "),
          (x, norm, (gu, ops._blocks(gu["segs"])), "gate/up ")]
    k2 = [("QKV", qkv, x, True), ("QKV prefill", qkv, x_pre, True),
          ("wo", wo, rows(M, wo["q"].shape[0]), False),
          ("w_down", down, rows(M, down["q"].shape[0]), False)]
    if cfg.family == "encdec":
        cross = layer["cross"]
        ckv, cwq, cwo = cross["wk"]["group"], cross["wq"], cross["wo"]
        mem = rows(M * S_FRAMES, d)
        k1 += [(x, norm, (cwq, None), "cross wq "),
               (mem, None, (ckv, ops._blocks(ckv["segs"])), "cross (wk, wv) memory ")]
        k2 += [("cross (wk, wv) memory", ckv, mem, True), ("cross wq", cwq, x, False),
               ("cross wo", cwo, rows(M, cwo["q"].shape[0]), False)]
    for xm, nrm, iv, label in k1:
        k1_row(xm, nrm, iv, False, flush, record, label=label)
    for label, rec, xin, per_block in k2:
        k2_row(dev, label, rec, xin, per_block, False, flush, record)
    for xin in (x, x_pre):
        k3_row(dev, gu, xin, False, flush, record, stamps, label="gate/up: ")
    del x_pre
    Sp = eng.caches["blocks"][0]["k"].shape[3]
    attend_rows(dev, M, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                ((V_ATTEND_LENS if P else S_ATTEND_LENS, Sp, False),), gen, flush, record)
    torch.cuda.empty_cache()
    moves = landing_moves(eng.bundle, M, eng.max_len, gen, smap, eng.mem_len)
    time_movement(f"{path}: one round's landing, 4 of {M} slots", moves, kv.COUNT, flush,
                  record, False, "cache_scatter", index_copies(moves, lambda t, mv: t))
    del moves
    torch.cuda.empty_cache()


def phase_extras(detail):
    """Paths V, VD (phi-3-vision-4.2b) and S, SD (seamless-m4t-medium):
    full width and full depth on seeded random bf16 weights, served with
    their stub extras (``path_extras``); the first engine of a model
    quantizes them (PDQ-int8 in every 2-D projection, the encoder's and
    the cross blocks' included) and the bf16 tree is dropped; VD and SD
    serve V's and S's records.  Each path: its kernel rows
    (``extras_kernels``) and phase 3 (serve, census); V and S also phase 4
    (step, every row at the position of a 300-token prompt behind the
    patches) and phase 5 (parity); VD's and SD's streams must equal V's and
    S's, with no prefix hit (extras turn sharing off).  Returns (counts,
    serve runs, parity)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    counts, serve, parity = {}, {}, {}
    for arch, max_len, paths in ((V_ARCH, V_MAX_LEN, ("V", "VD")),
                                 (S_ARCH, S_MAX_LEN, ("S", "SD"))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        weights = {"bf16": build_model(cfg, "cuda").init(0)}
        torch.cuda.synchronize()
        log(f"model {arch}: {cfg.n_layers} decoder layers"
            f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} x {cfg.hd} heads over {cfg.n_kv_heads} kv heads, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, frontend {cfg.frontend} "
            f"({cfg.frontend_tokens or S_FRAMES} stub embeddings): random bf16 weights, "
            f"{param_bytes(weights['bf16']) / 1e9:.2f} GB, in "
            f"{time.perf_counter() - t0:.1f} s")
        for path in paths:
            int8_kv, pdq, _, extra = PATHS[path]
            t0 = time.perf_counter()
            quantize = "pdq" not in weights
            eng = build_engine(ServeConfig(arch=arch, reduced=False, slots=8, max_len=max_len,
                                           int8_kv=int8_kv, quantize_weights=quantize,
                                           device="cuda", **extra),
                               cfg=cfg, params=weights["bf16" if quantize else "pdq"])
            if quantize:                   # VD and SD serve V's and S's records
                weights = {"pdq": eng.params}
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            log(f"model {path}: {cfg.name}, PDQ-int8 projections "
                f"({param_bytes(eng.params) / 1e9:.2f} GB of params), "
                f"{'int8' if int8_kv else 'bf16'} KV cache, "
                f"{f'paged pool of {eng.pool_pages} pages of {PAGE}' if eng.paged else 'slot rows'}, "
                f"patch tokens {eng.patch_tokens}, mem_len {eng.mem_len}, max_len "
                f"{eng.max_len}, buckets {eng.buckets}, built in "
                f"{time.perf_counter() - t0:.1f} s, its decode graph captured in "
                f"{eng._graph.capture_s:.2f} s (pool {eng._graph.pool_bytes / 2**20:.1f} MiB); "
                f"card memory allocated {torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
            with timed(f"kernels {path}"):
                extras_kernels(eng, path, detail)
            with timed(f"serve {path}"):
                counts[path], run = phase_serve(eng, path)
            if not eng.paged:
                with timed(f"step {path}"):
                    run["step"] = phase_step(eng, path, run["decode_step_median_ms"],
                                             pos=eng.patch_tokens + STEP_POS)
                with timed(f"parity {path}"):
                    parity[path], run["parity_pdq"] = phase_parity(eng, path)
            else:
                check_paged_run(path, run, serve[path[0]][0], ref=path[0])
            run["memory_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"model {path}: peak card memory {run['memory_peak_gib']:.2f} GiB")
            serve[path] = [run]
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return counts, serve, parity


PHASE_S: dict = {}        # seconds of each phase, for chip_smoke.json


@contextlib.contextmanager
def timed(label):
    """Log the seconds a phase takes (and keep them in PHASE_S)."""
    t0 = time.perf_counter()
    yield
    PHASE_S[label] = time.perf_counter() - t0
    log(f"phase {label}: {PHASE_S[label]:.1f} s")


def quant_kernels(eng, gen, flush, record):
    """K8, K9 and K10 against their plain versions at path E's shapes (8
    and 2048 rows of d_model): K8 on f32 (what the unfused projection
    gives it) and bf16 and on the sampling stride's rows, within SUM_RTOL
    and bit-equal over two launches; K9 and K10 per row and per channel,
    f32 and bf16, and at ragged shapes with x on .5 ties, codes and bits
    equal; K8, K9 and K10 also at a streaming size (16384 rows, past the
    50 MB L2).  Library calls, timed on f32 and not used by the port:
    torch.quantize_per_channel for K9 and torch.dequantize of the same
    codes for K10; none for K8, as no single PyTorch call returns both
    sums.  Beside them (``same_bytes_ms``), a PyTorch kernel that moves the
    same bytes: x.sum(-1) for K8, x.to(int8) for K9, q.to(dtype) for K10."""
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
                        (x_pre.to(torch.bfloat16), False), (strided, False),
                        (randn(STREAM_ROWS, d), False)):
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
               primary, same_bytes_ms=median_ms(lambda: xm.sum(-1), flush=flush))

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
             (STREAM_ROWS, d, False, torch.float32, False, True, False),
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
               lib_ms, primary,
               same_bytes_ms=median_ms(lambda: x.to(torch.int8), flush=flush))
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
               b_ms, b_by, lib_ms, primary,
               same_bytes_ms=median_ms(lambda: q.to(out_dtype), flush=flush))


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


def h_requests(cfg, seed=0):
    """H's requests: 8 of 32 new tokens with prompts of H_PROMPTS tokens;
    requests H_SHARED begin with one seeded 128-token system prompt (two
    full 64-token pages for HD to share).  Six prompts exceed the 256
    bucket and are chunked, three of them past the 1024-position ring."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in H_PROMPTS]
    system = np.random.default_rng(seed + 1).integers(0, cfg.vocab, size=128)
    for i in H_SHARED:
        prompts[i][:128] = system
    return [Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)]


def layer_counts(cfg):
    """(layers, local layers) of a config: a local layer attends over its
    ring in plain torch at decode (no K4/K5), so wo's prologue is K1's."""
    return cfg.n_layers, cfg.n_blocks * cfg.pattern.count("local")


def census(path, cfg, st):
    """Op entries a serving run of ``path`` makes, from its stats: ``pre``
    prefill launches (rounds plus chunk continuations), ``rounds``
    landings, ``dec`` decode dispatches of N = ``block_of(path)`` model
    steps each (every row runs every step of a block) and the spill
    restores.  Per layer: prefill runs the prologue 3x, W8A8 3x and
    SwiGLU once with PDQ weights; a decode step the same, except that with
    int8 KV and PDQ a global layer's fused attend (once) takes the place of
    wo's prologue (7 launches: tools/check_census.py's decode_int8kv); a
    local layer (gemma3) attends in plain torch and keeps the prologue (7
    launches: K1 x 3, K2 x 3, K3).  Every pool movement is one launch over
    all its leaves: a slot-row pool lands a round with one K6; a paged pool
    lands a round, gathers and writes back a dispatch's block, and
    restores with one K7 each (its flat leaves ride in the landing's and
    the restore's).  Under the guard (F, FF) the MLP is unfused: per layer
    and launch four K2 and four fallbacks, no K3, and K1 for QKV, gate/up
    and w_down (and wo at prefill; at decode K5 runs wo's prologue)."""
    if path in MOE_PATHS:
        return moe_census(path, cfg, st)[0]
    if path in SSM_PATHS:
        return ssm_census(path, cfg, st)[0]
    if path in ENCDEC_PATHS:
        return encdec_census(path, cfg, st)[0]
    int8_kv, pdq = PATHS[path][:2]
    n, n_local = layer_counts(cfg)
    rounds = st["prefill_batches"]
    pre = rounds + st["chunk_batches"]
    want = dict(pdq_prologue=0, w8a8_matmul=0, w8a8_swiglu_matmul=0,
                decode_attend_i8kv=0, decode_attend_i8kv_fused=0,
                cache_scatter=rounds, cache_scatter_pages=0,
                act_stats=0, quantize=0, dequantize=0, fp_dequant=0)
    if is_paged(path):
        want.update(cache_scatter=0, cache_scatter_pages=(
            rounds + 2 * st["decode_steps"] + st.get("spill_restores", 0)))
    dec = st["decode_steps"] * block_of(path)
    if pdq and is_guarded(path):
        g = GUARDED_PER_LAYER
        want.update(pdq_prologue=n * (g * pre + (g - 1 if int8_kv else g) * dec),
                    w8a8_matmul=g * n * (pre + dec), fp_dequant=g * n * (pre + dec))
    elif pdq:
        want.update(pdq_prologue=3 * n * pre + (3 * n - (n - n_local if int8_kv else 0)) * dec,
                    w8a8_matmul=3 * n * (pre + dec), w8a8_swiglu_matmul=n * (pre + dec))
    if int8_kv:
        want["decode_attend_i8kv_fused" if pdq else "decode_attend_i8kv"] = (n - n_local) * dec
    return want


def prologue_mode_census(path, cfg, st):
    """K1's launches per mode in a serving run of ``path``: with PDQ
    weights QKV and gate/up take norm + interval at every prefill launch and
    decode step; wo takes the interval alone at prefill, and at decode too
    with the fp KV cache or in a local layer (with int8 KV a global layer's
    prologue runs in K5).  Under the guard the norm runs in plain torch
    first, so every K1 launch (QKV, gate/up, w_down, wo at prefill) takes
    the interval alone."""
    if path in MOE_PATHS:
        return moe_census(path, cfg, st)[1]
    if path in SSM_PATHS:
        return ssm_census(path, cfg, st)[1]
    if path in ENCDEC_PATHS:
        return encdec_census(path, cfg, st)[1]
    int8_kv, pdq = PATHS[path][:2]
    n, n_local = layer_counts(cfg)
    pre = st["prefill_batches"] + st["chunk_batches"]
    dec = st["decode_steps"] * block_of(path)
    want = dict.fromkeys(("prologue", "norm", "interval", "norm+interval"), 0)
    if pdq and is_guarded(path):
        g = GUARDED_PER_LAYER
        want["interval"] = n * (g * pre + (g - 1 if int8_kv else g) * dec)
    elif pdq:
        want.update({"norm+interval": 2 * n * (pre + dec),
                     "interval": n * pre + (n_local if int8_kv else n) * dec})
    return want


def moe_layer_ops(cfg, kind, int8_kv):
    """((ops, K1 modes) of a prefill launch, (ops, K1 modes) of a decode
    step) of one PDQ layer of a MoE config.  MLA (deepseek): the grouped
    (wq_a, wkv_a) with the attention norm and wq_b with q_norm take K1's
    norm + interval, K2 each; the expanded prefill's wk_b and wv_b on ckv
    (a continuation's on the whole buffer) and wo take the interval alone,
    K2 each (K1 x 6, K2 x 6 at prefill); the absorbed decode dequantizes
    wk_b / wv_b in plain torch (K1 x 4, K2 x 4).  GQA (arctic): A's layer,
    QKV with the norm.  The FFN: a MoE layer's router and experts are
    plain torch and its shared / dense MLP (K1, K3, K2) reads the norm run
    in plain torch, so its K1 takes the interval alone; a ``global_dense``
    layer's MLP takes the norm inside K1."""
    if cfg.mla is not None:
        pre = dict(pdq_prologue=6, w8a8_matmul=6, w8a8_swiglu_matmul=1)
        dec = dict(pdq_prologue=4, w8a8_matmul=4, w8a8_swiglu_matmul=1)
        pre_m, dec_m = {"norm+interval": 2, "interval": 3}, {"norm+interval": 2, "interval": 1}
    else:
        pre = dict(pdq_prologue=3, w8a8_matmul=3, w8a8_swiglu_matmul=1)
        dec = dict(pdq_prologue=3 - int(int8_kv), w8a8_matmul=3, w8a8_swiglu_matmul=1,
                   decode_attend_i8kv_fused=int(int8_kv))
        pre_m = {"norm+interval": 1, "interval": 1}
        dec_m = {"norm+interval": 1, "interval": 0 if int8_kv else 1}
    ffn = "norm+interval" if kind == "global_dense" else "interval"
    pre_m[ffn] += 1
    dec_m[ffn] += 1
    return (pre, pre_m), (dec, dec_m)


def moe_census(path, cfg, st):
    """(op entries, K1 launches per mode) of a serving run of a MoE path:
    ``moe_layer_ops`` over every layer (head and blocks) times the prefill
    launches and the decode steps, and the pool movements as ``census``
    counts them (a round's landing moves the head layer's leaves with the
    blocks' in its one launch)."""
    int8_kv, pdq = PATHS[path][:2]
    need(pdq, f"{path}: the MoE paths serve PDQ records")
    rounds = st["prefill_batches"]
    pre = rounds + st["chunk_batches"]
    dec = st["decode_steps"] * block_of(path)
    want = dict(pdq_prologue=0, w8a8_matmul=0, w8a8_swiglu_matmul=0,
                decode_attend_i8kv=0, decode_attend_i8kv_fused=0,
                cache_scatter=rounds, cache_scatter_pages=0,
                act_stats=0, quantize=0, dequantize=0, fp_dequant=0)
    if is_paged(path):
        want.update(cache_scatter=0, cache_scatter_pages=(
            rounds + 2 * st["decode_steps"] + st.get("spill_restores", 0)))
    modes = dict.fromkeys(("prologue", "norm", "interval", "norm+interval"), 0)
    for kind in cfg.head + cfg.pattern * cfg.n_blocks + cfg.tail:
        for (ops_, modes_), n in zip(moe_layer_ops(cfg, kind, int8_kv), (pre, dec)):
            for k, v in ops_.items():
                want[k] += v * n
            for k, v in modes_.items():
                modes[k] += v * n
    return want, modes


def ssm_census(path, cfg, st):
    """(op entries, K1 launches per mode) of a serving run of an SSD path.
    A mamba layer at every prefill launch and decode step: ``in_proj`` with
    the layer's RMSNorm and ``out_proj`` with the gated RMSNorm, each one
    K1 (norm + interval) and one K2; the conv, the scan and the decode
    update are plain torch.  A ``shared`` occurrence is A's layer (QKV and
    gate/up with their norms, wo's interval at prefill and at decode in K5
    with int8 KV; K2 x 3, K3).  The pool movements as ``census`` counts
    them (a round's landing carries every conv and state leaf)."""
    int8_kv, pdq = PATHS[path][:2]
    need(pdq, f"{path}: the SSD paths serve PDQ records")
    rounds = st["prefill_batches"]
    pre = rounds + st["chunk_batches"]
    dec = st["decode_steps"] * block_of(path)
    kinds = cfg.head + cfg.pattern * cfg.n_blocks + cfg.tail
    n_mamba, n_shared = kinds.count("mamba"), kinds.count("shared")
    need(n_mamba + n_shared == cfg.n_layers, f"{path}: layer kinds {set(kinds)}")
    want = dict(pdq_prologue=2 * n_mamba * (pre + dec)
                + n_shared * (3 * pre + (3 - int(int8_kv)) * dec),
                w8a8_matmul=2 * n_mamba * (pre + dec) + 3 * n_shared * (pre + dec),
                w8a8_swiglu_matmul=n_shared * (pre + dec),
                decode_attend_i8kv=0,
                decode_attend_i8kv_fused=n_shared * dec if int8_kv else 0,
                cache_scatter=rounds, cache_scatter_pages=0,
                act_stats=0, quantize=0, dequantize=0, fp_dequant=0)
    if is_paged(path):
        want.update(cache_scatter=0, cache_scatter_pages=(
            rounds + 2 * st["decode_steps"] + st.get("spill_restores", 0)))
    modes = dict.fromkeys(("prologue", "norm", "interval", "norm+interval"), 0)
    modes["norm+interval"] = 2 * (n_mamba + n_shared) * (pre + dec)
    modes["interval"] = n_shared * (pre + (0 if int8_kv else dec))
    return want, modes


def encdec_census(path, cfg, st):
    """(op entries, K1 launches per mode) of a serving run of an
    encoder-decoder path.  Every prefill launch runs the encoder: each of
    its ``enc_layers`` layers is A's prefill layer (QKV and gate/up with
    their norms, wo's interval; K2 x 3, K3).  A decoder layer at prefill:
    A's layer plus the cross block, whose (wk, wv) group over the encoder's
    output takes the interval alone, wq its cross_norm and the interval,
    wo the interval (K1 x 6, K2 x 6, K3); at a decode step the cross K/V
    come from the cache: QKV, cross wq and gate/up with their norms, cross
    wo's interval, wo's prologue in K5 with int8 KV (K1 x 4, K2 x 5, K3,
    K5: 11 launches).  The pool movements as ``census`` counts them (a
    round's landing carries the cross leaves)."""
    int8_kv, pdq = PATHS[path][:2]
    need(pdq, f"{path}: the extras paths serve PDQ records")
    rounds = st["prefill_batches"]
    pre = rounds + st["chunk_batches"]
    dec = st["decode_steps"] * block_of(path)
    n, ne = cfg.n_layers, cfg.enc_layers
    k5 = int(int8_kv)
    want = dict(pdq_prologue=3 * ne * pre + 6 * n * pre + (5 - k5) * n * dec,
                w8a8_matmul=3 * ne * pre + 6 * n * pre + 5 * n * dec,
                w8a8_swiglu_matmul=ne * pre + n * (pre + dec),
                decode_attend_i8kv=0, decode_attend_i8kv_fused=k5 * n * dec,
                cache_scatter=rounds, cache_scatter_pages=0,
                act_stats=0, quantize=0, dequantize=0, fp_dequant=0)
    if is_paged(path):
        want.update(cache_scatter=0, cache_scatter_pages=(
            rounds + 2 * st["decode_steps"] + st.get("spill_restores", 0)))
    modes = dict.fromkeys(("prologue", "norm", "interval", "norm+interval"), 0)
    modes["norm+interval"] = 2 * ne * pre + 3 * n * (pre + dec)
    modes["interval"] = ne * pre + 3 * n * pre + (2 - k5) * n * dec
    return want, modes


# the route every launch of a serving or ops-level run must take
MAIN_ROUTE = {"w8a8_matmul": "wgmma", "w8a8_swiglu_matmul": "wgmma",
              "decode_attend_i8kv": "split", "decode_attend_i8kv_fused": "split",
              "act_stats": "vector", "quantize": "vector"}


def check_routes(path, counts):
    """Every K2 and K3 launch of a run took the wgmma route, every K4 and
    K5 launch the split route, every K8 and K9 launch the vector route."""
    from repro_torch.kernels import ops
    routes = ops.route_counts()
    log(f"{path}: K2-K5, K8, K9 launches per route {routes}")
    for name, r in routes.items():
        main = MAIN_ROUTE[name]
        need(r[main] == counts[name]["launches"]
             and all(v == 0 for k, v in r.items() if k != main),
             f"{path}: {name} launches {counts[name]['launches']}, per route {r}")


def fault_requests(cfg, n=3, seed=5):
    """FF's requests: ``n`` short prompts (20-60 tokens, the 64 bucket) of
    8 new tokens, so that the fallback carries every projection of a run
    within seconds."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(L)).astype(np.int32),
                    max_new=8) for i, L in enumerate(rng.integers(20, 61, size=n))]


def run_batch(eng, reqs, extras=None):
    """Serve ``reqs`` with ``engine.run`` (and the run's prefill
    ``extras``): {request index: (tokens, finish reason, error)}."""
    eng.run(reqs, extras=extras)
    return {i: (list(r.generated), r.finish_reason if r.done else None, r.error)
            for i, r in enumerate(reqs)}


def run_http(eng, reqs):
    """Serve ``reqs`` through the front door: ``ServeService`` (its loop
    thread replays the engine's graph) and ``HttpFrontend`` on 127.0.0.1,
    each request its own client thread POSTing a streamed completion and
    reading its SSE events.  Returns {request index: (tokens, finish
    reason, error)}; stops the server, the service and every thread it
    started."""
    import asyncio
    import http.client
    import threading
    from repro_torch.serve import HttpFrontend, ServeService
    svc = ServeService(eng, max_pending=len(reqs)).start()
    box, ready = {}, threading.Event()

    def serve():
        async def amain():
            fe = await HttpFrontend(svc, port=0).start()
            box.update(port=fe.port, loop=asyncio.get_running_loop(), stop=asyncio.Event())
            ready.set()
            await box["stop"].wait()
            await fe.stop()
        asyncio.run(amain())

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    out = {}
    try:
        need(ready.wait(60), "the HTTP front door did not start")

        def client(i, r):
            c = http.client.HTTPConnection("127.0.0.1", box["port"], timeout=600)
            try:
                c.request("POST", "/v1/completions",
                          json.dumps({"prompt": [int(t) for t in r.prompt],
                                      "max_tokens": r.max_new, "stream": True}),
                          {"Content-Type": "application/json"})
                resp = c.getresponse()
                toks, fin = [], {}
                for raw in resp.fp:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    d = json.loads(line[6:])
                    if "token" in d:
                        toks.append(d["token"])
                    else:
                        fin = d
                out[i] = (toks, fin.get("finish_reason") if resp.status == 200
                          else f"HTTP {resp.status}", fin.get("error"))
            finally:
                c.close()

        clients = [threading.Thread(target=client, args=(i, r), daemon=True)
                   for i, r in enumerate(reqs)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(600)
    finally:
        if "loop" in box:
            box["loop"].call_soon_threadsafe(box["stop"].set)
        server.join(60)
        svc.stop()
    need(svc.error is None, f"the service loop failed: {svc.error!r}")
    return out


def pdq_health(st):
    """A run's PDQ health from its stats, with the clip rate."""
    total = st["pdq_clip_total"]
    return dict(pdq_fallbacks=st["pdq_fallbacks"], pdq_clip_hits=st["pdq_clip_hits"],
                pdq_clip_total=total,
                pdq_clip_rate=st["pdq_clip_hits"] / total if total else None)


def phase_serve(eng, path):
    import torch
    from repro_torch.kernels import ops
    reqs = (fault_requests(eng.cfg) if path == FAULT_PATH else h_requests(eng.cfg)
            if path in LONG_PATHS else make_requests(eng.cfg))
    extras = path_extras(path, eng.cfg)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    with ops.pdq_fault() if path == FAULT_PATH else contextlib.nullcontext():
        results = run_http(eng, reqs) if path == "F" else run_batch(eng, reqs, extras)
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
    # every decode dispatch replayed the engine's graph, captured once
    need(st["graph_replays"] == st["decode_steps"],
         f"{path}: {st['graph_replays']} graph replays, {st['decode_steps']} decode "
         f"dispatches")
    want = census(path, eng.cfg, st)
    got = {k: c["entries"] for k, c in counts.items()}
    need(got == want, f"{path}: op entries {got}, census {want}")
    modes = ops.prologue_modes()
    want_modes = prologue_mode_census(path, eng.cfg, st)
    log(f"{path}: K1 launches per mode {modes}")
    need(modes == want_modes, f"{path}: K1 launches per mode {modes}, census {want_modes}")
    need(st["completed"] == len(reqs) and st["failed"] == 0,
         f"not every request completed: {st}")
    if eng.chunked_prefill:
        chunked = sum(len(r.prompt) > eng.buckets[-1] for r in reqs)
        need(st["chunked_requests"] == chunked and st["chunk_batches"] > 0,
             f"{path}: {st['chunked_requests']} chunked requests, {chunked} expected")
    health = pdq_health(st)
    log(f"serve {path}: pdq {json.dumps(health)}")
    pdq = PATHS[path][1]
    need((st["pdq_clip_total"] > 0) == pdq, f"{path}: PDQ health {health}")
    launches = (st["prefill_batches"] + st["chunk_batches"]
                + st["decode_steps"] * block_of(path))
    want_fb = GUARDED_PER_LAYER * eng.cfg.n_layers * launches if path == FAULT_PATH else 0
    need(st["pdq_fallbacks"] == want_fb,
         f"{path}: {st['pdq_fallbacks']} fallbacks, {want_fb} expected")
    if is_paged(path):
        # COW copies would move pages outside the census; none is expected
        # (only full prompt pages are shared)
        need(st["cow_copies"] == 0, f"{path}: {st['cow_copies']} COW copies")
        need(st["spills"] == st["preemptions"] and not eng.failures.count("spill"),
             f"{path}: a spill failed: {st}, {list(eng.failures.events)}")
    need(sorted(results) == list(range(len(reqs))), f"{path}: results {sorted(results)}")
    for i, r in enumerate(reqs):
        toks, fin, err = results[i]
        need(fin == "complete" and err is None and len(toks) == r.max_new,
             f"{path}: request {i}: {len(toks)} tokens, finish {fin}, error {err}")
        need(all(0 <= tok < eng.cfg.vocab for tok in toks),
             f"{path}: request {i}: token out of range")
    dec = [dt for dt, _ in eng.straggler.history]
    pre = [dt for dt, _ in eng.prefill_straggler.history]
    decode_tps = eng.stats["decode_tokens"] / sum(dec)
    steps = sorted(dec)
    log(f"serve {path}: prefill launch sets {len(pre)} ({st['chunk_batches']} chunk "
        f"continuations) total {sum(pre):.3f} s "
        f"({eng.stats['prefill_tokens']} prompt tokens, "
        f"{eng.stats['prefill_padded_tokens']} padded); decode dispatches of "
        f"{block_of(path)} steps {len(dec)} median {steps[len(steps) // 2] * 1e3:.2f} ms, "
        f"{decode_tps:.1f} tokens/s ({1e3 / decode_tps:.3f} ms a token) over "
        f"{eng.stats['decode_tokens']} tokens; graph captured in "
        f"{eng._graph.capture_s:.2f} s, pool {eng._graph.pool_bytes / 2**20:.1f} MiB")
    return counts, dict(wall_s=wall, prefill_s=sum(pre), prefill_launches=len(pre),
                        prefill_s_per_round=pre, 
                        prologue_modes=modes, decode_steps_per_dispatch=block_of(path),
                        decode_step_median_ms=steps[len(steps) // 2] * 1e3,
                        decode_tokens_per_s=decode_tps,
                        decode_ms_per_token=1e3 / decode_tps,
                        graph_capture_s=eng._graph.capture_s,
                        graph_pool_bytes=eng._graph.pool_bytes, stats=eng.stats,
                        pdq=health, streams={i: res[0] for i, res in results.items()})


def device_rows(prof, per):
    """(ms, kernel, launches, recorded) per ``per`` runs of every device
    row of a torch.profiler trace, longest first: launches is the recorded
    count over ``per``, rounded down (a record the profiler misses near the
    window's start lowers it), ``recorded`` the count itself."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / per / 1e3, ev.key, ev.count // per, ev.count))
    rows.sort(reverse=True)
    return rows


def phase_step(eng, path, serve_step_ms, pos=STEP_POS):
    """Phase 4: one decode step of the full pool at position ``pos``
    (STEP_POS; V's behind its patches) (on a
    paged pool every slot holding pages up to its frontier), two ways on
    the same state: ``eager`` - the engine's one-step block (the step and
    its sampling) run as ops launched from the host, as every decode ran
    before the graph - and ``graph``, a replay of the engine's captured
    one-step graph.  On a paged pool both gather into the engine's scratch
    first and write the page back after; both end in the tokens' copy to
    the host.  STEP_PAIRS alternated pairs of STEP_RUNS-step windows (eager
    first, then graph first, and so on) give the wall ms a step; then
    torch.profiler over one window of each gives the device busy ms and
    kernels a step, and the idle share is 1 - busy / median wall.  Device
    numbers are null if the profiler records no kernels.  On A a third
    variant, ``graph_tel_off``: the same one-step block captured with
    telemetry off (no counter pointers, no counters' memset), in the same
    rotation - what the counting costs a replayed step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    need(block_of(path) == 1, f"{path}: phase 4 compares one-step blocks")
    B = eng.slots
    rows = (np.zeros(B, np.int32), np.full(B, pos, np.int32),
            np.arange(B, dtype=np.int32), np.zeros(B, np.int32), np.ones(B, np.int32))
    t = [torch.as_tensor(a, device=eng.device) for a in rows]
    caches = eng._logical if eng.paged else eng.caches
    po = eng._paged_ops if eng.paged else None
    pt = (1 + np.arange(B * eng.n_pp, dtype=np.int32)).reshape(B, -1) if eng.paged else None

    def around(fn):
        def step():
            if po is not None:
                po.gather(eng.caches, pt, rows[1], out=caches)
            fn()
            if po is not None:
                po.writeback(eng.caches, caches, pt, rows[1][:, None], n_steps=rows[4])
        return step

    tel = eng._tel_buffer()
    variants = {
        "eager": around(lambda: eng._block(caches, t[0][:, None], t[1][:, None],
                                           *t[2:], tel)[0].cpu()),
        "graph": around(lambda: eng._graph(*rows)),
    }
    if path == "A":
        from repro_torch.serve.decode_graph import DecodeGraph

        def block_off(c, tok, pos, uids, steps, n_steps, _tel):
            return eng._scan(c, tok, pos, uids, steps, n_steps, None)

        off = DecodeGraph(block_off, caches, eng.bundle.init_caches(B, eng.max_len), B,
                          eng.device)
        variants["graph_tel_off"] = around(lambda: off(*rows))

    def window(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_RUNS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEP_RUNS

    for fn in variants.values():
        fn()
    walls = {k: [] for k in variants}
    order = list(variants)
    for i in range(STEP_PAIRS):
        for name in (order if i % 2 == 0 else order[::-1]):
            walls[name].append(window(variants[name]))
    out = dict(serve_step_ms=serve_step_ms)
    for name, fn in variants.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_RUNS):
                fn()
            torch.cuda.synchronize()
        rows_ = device_rows(prof, STEP_RUNS)
        busy = sum(r[0] for r in rows_)
        wall = sorted(walls[name])[STEP_PAIRS // 2]
        out[name] = dict(wall_ms=walls[name], wall_ms_median=wall,
                         device_busy_ms=busy if rows_ else None,
                         device_idle_share=(1 - busy / wall) if rows_ else None,
                         kernels_per_step=sum(r[2] for r in rows_),
                         top_kernels=[dict(kernel=k[:70], ms=ms, launches=n)
                                      for ms, k, n, _ in rows_[:8]],
                         all_device_rows=[dict(kernel=k[:120], ms=ms, launches=n,
                                               recorded=c) for ms, k, n, c in rows_])
    if path in MOE_PATHS + SSM_PATHS:
        out["split"] = step_split(path, variants["eager"])
    g, e = out["graph"], out["eager"]
    out["speedup"] = e["wall_ms_median"] / g["wall_ms_median"]
    if "graph_tel_off" in out:
        o = out["graph_tel_off"]
        out["tel_cost_wall"] = g["wall_ms_median"] / o["wall_ms_median"] - 1
        if g["device_busy_ms"] is not None and o["device_busy_ms"] is not None:
            out["tel_cost_busy"] = g["device_busy_ms"] / o["device_busy_ms"] - 1
    if g["device_busy_ms"] is not None:
        out["serve_step_idle_share"] = 1 - g["device_busy_ms"] / serve_step_ms
    log(f"step {path}: " + json.dumps({
        **{k: {kk: v[kk] for kk in ("wall_ms", "wall_ms_median", "device_busy_ms",
                                    "device_idle_share", "kernels_per_step",
                                    "top_kernels")} for k, v in out.items()
           if k in variants},
        "speedup": out["speedup"], "serve_step_ms": serve_step_ms,
        "serve_step_idle_share": out.get("serve_step_idle_share"),
        "tel_cost_wall": out.get("tel_cost_wall"),
        "tel_cost_busy": out.get("tel_cost_busy")}))
    return out


def step_split(path, eager):
    """A MoE or SSD path's eager step, profiled with a range around each
    layer's routed experts (``moe_ffn_dense_masked``: the router, the E x 3
    expert products and the gated sum, all plain torch), around its
    attention (``mla_apply`` / ``gqa_apply``, its projections' K1 and K2
    included) and around its SSD block (``ssm_apply``: in_proj's and
    out_proj's K1 and K2, the conv, the state update and the gated norm):
    device ms a step in each range, in the hand kernels (K1-K10 by their
    CUDA names, ``HAND_KERNEL``) and in all.  The ranges are this script's
    (the module's names wrapped for the window); a range the profiler
    gives no device time reads null."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import transformer as tr
    names = ("moe_ffn_dense_masked", "mla_apply", "gqa_apply", "ssm_apply")
    saved = {n: getattr(tr, n) for n in names}

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(f"smoke.{name}"):
                return fn(*a, **kw)
        return call

    try:
        for n, fn in saved.items():
            setattr(tr, n, ranged(n, fn))
        eager()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_RUNS):
                eager()
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(tr, n, fn)
    from torch.autograd import DeviceType
    # the ranges' own rows on the device timeline are spans (gaps included)
    rows = [r for r in device_rows(prof, STEP_RUNS) if not r[1].startswith("smoke.")]
    hand = re.compile(HAND_KERNEL)
    ranges = {}
    for ev in prof.events():
        # a range's host event sums the device time of the kernels its ops
        # launched
        if ev.device_type == DeviceType.CPU and ev.name.startswith("smoke."):
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            ranges[ev.name[6:]] = ranges.get(ev.name[6:], 0.0) + us
    ranges = {k: us / STEP_RUNS / 1e3 if us else None for k, us in ranges.items()}
    out = dict(device_busy_ms=sum(r[0] for r in rows),
               hand_kernels_ms=sum(r[0] for r in rows if hand.search(r[1])),
               routed_experts_ms=ranges.get("moe_ffn_dense_masked"),
               attention_ms=ranges.get("mla_apply") or ranges.get("gqa_apply"),
               ssd_ms=ranges.get("ssm_apply"),
               hand_kernel_rows=[dict(kernel=k[:120], ms=ms, launches=n)
                                 for ms, k, n, _ in rows if hand.search(k)])
    log(f"step {path} split (eager, device ms a step): busy {out['device_busy_ms']:.3f}, "
        f"routed experts {out['routed_experts_ms']}, attention {out['attention_ms']}, "
        f"SSD blocks {out['ssd_ms']}, hand kernels {out['hand_kernels_ms']:.3f}")
    return out


@contextlib.contextmanager
def plain_kernels(keep=()):
    """Route the kernel wrappers to their plain versions for CUDA tensors
    (this script's reference run only; the package never does this), but
    the wrappers named in ``keep``.  K1's
    one wrapper takes every mode, so its swap covers the norm and interval
    stages too: the reference run applies rms_norm and prices intervals in
    plain torch."""
    from repro_torch.kernels import act_stats as st
    from repro_torch.kernels import fp_dequant as fd
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
             (kv, "cache_move_cuda", kv.cache_move_plain),
             (fd, "fp_dequant_fallback_cuda", fd.fp_dequant_fallback_plain)]
    swaps = [sw for sw in swaps if sw[1] not in keep]
    saved = [getattr(m, a) for m, a, _ in swaps]
    try:
        for m, a, f in swaps:
            setattr(m, a, f)
        yield
    finally:
        for (m, a, _), f in zip(swaps, saved):
            setattr(m, a, f)


def scale_records(tree, f, seen=None):
    """Every PDQ record's alpha and beta in ``tree`` times ``f``, in place
    (a grouped record shared by its segment views once)."""
    seen = set() if seen is None else seen
    if isinstance(tree, dict):
        if "alpha" in tree and id(tree) not in seen:
            seen.add(id(tree))
            tree["alpha"].mul_(f)
            tree["beta"].mul_(f)
        for v in tree.values():
            scale_records(v, f, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            scale_records(v, f, seen)


def tel_agree(path, label, k_tel, p_tel):
    """The kernel run's [fallbacks, clip_hits, clip_total] against the
    plain run's: fallbacks and totals equal, hits within TEL_SLACK of the
    total."""
    k, p = k_tel.tolist(), p_tel.tolist()
    slack = int(TEL_SLACK[path] * p[2])
    need(k[0] == p[0] and k[2] == p[2] and abs(k[1] - p[1]) <= slack,
         f"parity {path} ({label}): kernel PDQ health {k}, plain {p}, hit slack {slack}")
    log(f"parity {path} ({label}): PDQ health kernel {k}, plain {p} "
        f"(clip rate {k[1] / k[2] if k[2] else 0:.6g})")
    return dict(kernel=k, plain=p, slack=slack)


def clone_tree(caches):
    """A copy of a cache tree ({'head', 'tail', 'blocks'} of tuples of leaf
    dicts) on its device."""
    return {sec: tuple({k: v.clone() for k, v in d.items()} for d in caches[sec])
            for sec in caches}


def phase_parity(eng, path, n_tokens=8):
    """Phase 5 on ``eng`` (its guard, and for FF the fault, active around
    both runs; on H a prompt of H_PARITY_LEN tokens prefilled in the
    engine's chunks; on V and S the path's extras in the prefill).  On the
    SSD paths also the ONE-STEP comparison: every decode step run again
    from a copy of the kernel run's own caches as they stood before it, so
    that no earlier difference carries over, once with every kernel plain
    and once with every kernel plain but K5.  The latter is bound at every
    step, with the argmax-margin check; the former too, but at a step
    whose K5 gave codes one apart from plain's (the step's first such call
    held to K5's contract, ``code_flips``), where it is reported.  The
    teacher-forced difference is bound up to K5's first code flip and
    reported after it.  Returns (max logit difference, the health
    comparisons)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    bundle, params = eng.bundle, eng.params
    if path in LONG_PATHS:   # chunked: a prompt past gemma3's ring, in 5 chunks
        prompt = np.random.default_rng(7).integers(0, eng.cfg.vocab, size=H_PARITY_LEN)
    else:
        prompt = make_requests(eng.cfg, n=1, seed=7)[0].prompt
    L = len(prompt)
    P = eng.patch_tokens
    extras = path_extras(path, eng.cfg) or {}
    tokens = torch.as_tensor(np.asarray(prompt, np.int32), device=eng.device)[None]
    C = eng.buckets[-1] if eng.chunked_prefill else L
    one_step = path in SSM_PATHS

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=eng.device)

    step = [0]                # the output step the model calls feed (routing log)

    def run(teacher=None, snaps=None):
        """The kernel or plain run; ``snaps`` collects (a copy of the
        caches, token, position) before every decode step."""
        tel = eng._tel_buffer()
        with ops.pdq_guard(is_guarded(path)), ops.pdq_telemetry(counters=tel), \
                ops.pdq_fault() if path == FAULT_PATH else contextlib.nullcontext():
            caches = bundle.init_caches(1, 64 + P + L, eng.mem_len)
            step[0] = 0
            logits, caches = bundle.prefill_many(
                params, {"tokens": tokens[:, :C], **extras}, caches, i32(min(C, L)))
            for s0 in range(C, L, C):          # the engine's chunks of C
                n = min(C, L - s0)
                logits, caches = bundle.prefill_chunk(
                    params, {"tokens": tokens[:, s0:s0 + n]}, caches, i32(n), i32(s0))
            out, toks = [logits[0].float()], []
            for i in range(n_tokens - 1):
                tok = int(out[-1].argmax()) if teacher is None else teacher[i]
                toks.append(tok)
                step[0] = i + 1
                args = (torch.tensor([[tok]], dtype=torch.int32, device=eng.device),
                        torch.tensor([[P + L + i]], dtype=torch.int32, device=eng.device))
                if snaps is not None:
                    snaps.append((clone_tree(caches),) + args)
                logits, caches = bundle.decode_step(params, caches, *args)
                out.append(logits[0].float())
        toks.append(int(out[-1].argmax()) if teacher is None else -1)
        return out, toks, tel

    k_routes, p_routes, k_att, p_att, snaps = [], [], [], [], []
    with route_log(k_routes, step), attend_log(k_att, step):
        k_logits, k_toks, k_tel = run(snaps=snaps if one_step else None)
    with plain_kernels(), route_log(p_routes, step), attend_log(p_att, step):
        p_logits, _, p_tel = run(teacher=k_toks)
    flips = expert_flips(path, k_routes, p_routes)
    # SSD paths: the first K5 code a tolerance apart from plain's, and the
    # step it fed (None: the runs' K5 codes never parted); and each decode
    # step plain from the kernel run's caches before it (the prefill's
    # one-step logits are the teacher-forced run's own: both start empty)
    code_flip = code_flips(path, k_att, p_att) if path in SSM_PATHS else None
    # one-step: each decode step from the kernel run's caches before it,
    # once with every kernel plain and once with every kernel plain but K5
    # (the prefill runs no K5: both start from the plain prefill's logits)
    one_plain, one_k5, one_flips, a_att = None, None, [], []
    if one_step:
        one_plain, one_k5 = [p_logits[0]], [p_logits[0]]
        for i, (caches, tok, pos) in enumerate(snaps):
            step[0] = i + 1
            with plain_kernels(), attend_log(a_att, step):
                one_plain.append(bundle.decode_step(params, clone_tree(caches), tok,
                                                    pos)[0][0].float())
            with plain_kernels(keep=("decode_attend_i8kv_fused_cuda",)):
                one_k5.append(bundle.decode_step(params, caches, tok, pos)[0][0].float())
        del snaps
        # every step's first K5 call whose codes part from plain's ran on
        # equal inputs: it must hold K5's contract
        one_flips = code_flips(path, k_att, a_att, every_step=True)
    health = [tel_agree(path, "records' alpha, beta", k_tel, p_tel)]
    # the same with outputs clipping: every record's alpha and beta scaled
    # (this engine serves nothing after its parity phase)
    scale_records(params, CLIP_SCALE)
    _, s_toks, k_tel = run()
    with plain_kernels():
        _, _, p_tel = run(teacher=s_toks)
    scale_records(params, 1 / CLIP_SCALE)         # a power of 2: exactly undone
    health.append(tel_agree(path, f"alpha, beta x {CLIP_SCALE}", k_tel, p_tel))
    need(not PATHS[path][1] or health[-1]["kernel"][1] > 0,
         f"parity {path}: no output clipped at alpha, beta x {CLIP_SCALE}")
    tol = LOGIT_TOL[path]
    diffs = [float((kl - pl).abs().max()) for kl, pl in zip(k_logits, p_logits)]
    log(f"parity {path}: max |logits diff| per step {diffs} (tolerance {tol})")
    first_flip = min(flips) if flips else None

    def margin_check(i, kl, pl, what):
        if int(kl.argmax()) != int(pl.argmax()):
            top2 = pl.topk(2).values
            margin = float(top2[0] - top2[1])
            need(margin < tol, f"parity {path} step {i}: argmax differs from the "
                 f"{what} with plain top-2 margin {margin}")
            log(f"parity {path} step {i}: argmax differs from the {what} inside the "
                f"margin ({margin:.4g})")

    for i, (kl, pl) in enumerate(zip(k_logits, p_logits)):
        d = diffs[i]
        need(torch.isfinite(kl).all(), f"parity {path} step {i}: non-finite logits")
        if first_flip is not None and i >= first_flip:
            # a router decision taken apart (within ROUTER_EPS) at or before
            # this step moves the logits by an expert's contribution
            log(f"parity {path} step {i}: logits differ by {d} after the expert "
                f"flips of step {first_flip} (tolerance {tol} not applied)")
        elif code_flip is not None and i >= code_flip:
            # the state carries the flipped code on: the one-step
            # difference below is the bound one
            log(f"parity {path} step {i}: teacher-forced logits differ by {d} after "
                f"K5's code flip at step {code_flip} (reported; the one-step "
                f"difference is bound)")
            continue
        else:
            need(d <= tol, f"parity {path} step {i}: logits differ by {d} > {tol}")
        margin_check(i, kl, pl, "teacher-forced plain run")
    one = one_all = None
    if one_step:
        one = [float((kl - ol).abs().max()) for kl, ol in zip(k_logits, one_k5)]
        one_all = [float((kl - ol).abs().max()) for kl, ol in zip(k_logits, one_plain)]
        log(f"parity {path}: one-step max |logits diff| per step, every kernel plain "
            f"{one_all}, every kernel plain but K5 {one} (tolerance {tol}); K5 codes "
            f"one apart from plain's at steps {one_flips}")
        for i, (kl, ol) in enumerate(zip(k_logits, one_k5)):
            need(one[i] <= tol, f"parity {path} step {i}: one-step logits (every kernel "
                 f"plain but K5) differ by {one[i]} > {tol}")
            margin_check(i, kl, ol, "one-step run (every kernel plain but K5)")
            if i in one_flips:
                # the step's own K5 code flip (within K5's contract, checked
                # above) moves the logits of this one step
                log(f"parity {path} step {i}: one-step logits with every kernel plain "
                    f"differ by {one_all[i]}: K5's code flip at this step (reported)")
            else:
                need(one_all[i] <= tol, f"parity {path} step {i}: one-step logits "
                     f"differ by {one_all[i]} > {tol}")
    log(f"parity {path}: {n_tokens} greedy tokens {k_toks}; max |logits diff| "
        f"per step {diffs} (tolerance {tol}); max |logit| "
        f"{float(max(kl.abs().max() for kl in k_logits)):.4g}")
    if path in MOE_PATHS:
        health.append(dict(expert_flips=flips, logit_diff_per_step=diffs))
    if path in SSM_PATHS:
        health.append(dict(code_flip_step=code_flip, logit_diff_per_step=diffs,
                           one_step_code_flip_steps=one_flips,
                           one_step_logit_diff_per_step=one_all,
                           one_step_but_k5_logit_diff_per_step=one))
    return max(diffs if one is None else one), health


@contextlib.contextmanager
def attend_log(out, step):
    """Record every K5 call (``kv.decode_attend_i8kv_fused``, the op
    layer's entry, whichever version it runs) as (output step ``step[0]``,
    o, o_q, s_x), on the host."""
    from repro_torch.kernels import kv_cache as kv
    orig = kv.decode_attend_i8kv_fused

    def traced(*args):
        res = orig(*args)
        out.append((step[0],) + tuple(t.cpu() for t in res[:3]))
        return res

    kv.decode_attend_i8kv_fused = traced
    try:
        yield
    finally:
        kv.decode_attend_i8kv_fused = orig


def code_flips(path, k_att, p_att, every_step=False):
    """The output step at which the kernel run's K5 first gave wo's
    prologue other int8 codes than the plain run's, or None.  That first
    call ran on equal inputs, so it must hold K5's contract (the kernel
    phase's check): o within ATTEND_TOL, s_x within rtol 1e-5, codes one
    apart at most and only where o (rounded to bf16) or s_x differ; later
    calls run on inputs the flip moved and are not compared.  With
    ``every_step`` (a one-step run, which starts every step from the kernel
    run's caches) the same for each step's calls: the list of steps whose
    first parted call held the contract."""
    import torch
    need(len(k_att) == len(p_att), f"parity {path}: K5 calls {len(k_att)} (kernels) "
         f"and {len(p_att)} (plain)")
    steps = []
    for (sk, ok, qk, xk), (sp, op, qp, xp) in zip(k_att, p_att):
        need(sk == sp, f"parity {path}: K5 calls disagree on the step")
        if torch.equal(qk, qp) or sk in steps:
            continue
        B = qk.shape[0]
        same = ((ok.reshape(B, -1).to(torch.bfloat16) == op.reshape(B, -1).to(torch.bfloat16))
                & (xk == xp))
        dq = (qk.int() - qp.int()).abs()
        need(bool(torch.isclose(ok, op, rtol=ATTEND_TOL, atol=ATTEND_TOL).all())
             and bool(torch.isclose(xk, xp, rtol=1e-5, atol=0).all())
             and int(dq.max()) <= 1 and bool((dq[same] == 0).all()),
             f"parity {path}: step {sk}: K5's codes part from plain's outside its "
             f"contract (max code difference {int(dq.max())})")
        log(f"parity {path}: step {sk}: K5 gave {int((dq > 0).sum())} codes one apart "
            f"from plain's (o within {ATTEND_TOL})"
            + ("" if every_step else "; later steps' teacher-forced logits reported"))
        if not every_step:
            return sk
        steps.append(sk)
    return steps if every_step else None


@contextlib.contextmanager
def route_log(out, step):
    """Record every MoE router call (``models.moe.route``, which both MoE
    FFNs call through the module) as (output step ``step[0]``, ids sorted
    per token, the k-th less the (k+1)-th expert probability per token)."""
    import torch
    from repro_torch.models import moe
    orig = moe.route

    def traced(x, wr, cfg, token_mask=None):
        gates, ids, aux = orig(x, wr, cfg, token_mask)
        top = torch.softmax(x.float() @ wr, dim=-1).topk(cfg.top_k + 1, dim=-1).values
        out.append((step[0], ids.sort(-1).values.cpu(),
                    (top[:, -2] - top[:, -1]).cpu()))
        return gates, ids, aux

    moe.route = traced
    try:
        yield
    finally:
        moe.route = orig


def expert_flips(path, k_routes, p_routes):
    """The router decisions the kernel and plain runs took apart: {output
    step: [the plain run's top-k margin at each token whose expert set
    differs]}, every margin below ROUTER_EPS."""
    need(len(k_routes) == len(p_routes), f"parity {path}: router calls "
         f"{len(k_routes)} (kernels) and {len(p_routes)} (plain)")
    flips = {}
    for (sk, ik, _), (sp, ip, mp) in zip(k_routes, p_routes):
        need(sk == sp and ik.shape == ip.shape, f"parity {path}: router calls disagree")
        apart = (ik != ip).any(-1)
        if bool(apart.any()):
            flips.setdefault(sk, []).extend(float(m) for m in mp[apart])
    for st, margins in sorted(flips.items()):
        log(f"parity {path}: step {st}: {len(margins)} tokens routed apart, plain "
            f"top-k margins {[f'{m:.3g}' for m in margins]}")
        need(max(margins) < ROUTER_EPS, f"parity {path}: step {st}: an expert flip "
             f"with a router margin {max(margins)} >= {ROUTER_EPS}")
    if k_routes and not flips:
        log(f"parity {path}: every one of {len(k_routes)} router calls took the same "
            f"experts in both runs")
    return flips


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
    modes = ops.prologue_modes()
    need(modes == dict(prologue=0, norm=0, interval=n, **{"norm+interval": 0}),
         f"E: K1 launches per mode {modes}: every fused projection prices its "
         f"interval in K1")
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
                                          for ms, k, c, _ in prof_rows]))
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


def check_streams(path, run, ref_run, ref="A"):
    """A run's greedy streams equal ``ref``'s first run's, request for
    request (prefill runs at (slots, bucket) whatever the pool or the block,
    and every decode op is row-independent, so neither the pool's layout
    nor the steps a dispatch may move a token)."""
    for uid, toks in ref_run["streams"].items():
        need(run["streams"][uid] == toks,
             f"{path}: request {uid} stream {run['streams'][uid]} differs from "
             f"{ref}'s {toks}")
    log(f"serve {path}: streams equal {ref}'s")


def check_paged_run(path, run, ref_run, ref="A"):
    """D1/D2/D16 against A's first run, HD against H's, ZD against Z's, VD
    against V's, SD against S's: the same greedy streams
    (``check_streams``); each shares the system prompt's pages but VD and
    SD, whose extras turn sharing off; D2 preempts, spills every victim to
    host memory and restores it, HD, ZD, VD and SD never preempt."""
    st = run["stats"]
    check_streams(path, run, ref_run, ref)
    if path in EXTRAS_PATHS:    # a run's extras turn prefix sharing off
        need(st["prefix_hits"] == 0, f"{path}: prefix hits with extras: {st}")
    else:
        need(st["prefix_hits"] >= 1, f"{path}: no prefix hit: {st}")
    if path == "D2":
        need(st["preemptions"] >= 1 and st["spill_restores"] >= 1,
             f"D2: pool of {D2_POOL_PAGES} pages did not preempt and restore: {st}")
    if path in ("HD", "ZD", "VD", "SD"):
        need(st["preemptions"] == 0, f"{path}: the pool preempted: {st}")
    log(f"serve {path}: streams equal {ref}'s; prefix hits {st['prefix_hits']} "
        f"({st['prefix_shared_pages']} pages), preemptions {st['preemptions']}, "
        f"spills {st['spills']}, restores {st['spill_restores']}")


def check_chunked_twin(eng, run, chunked_run):
    """HBW (unchunked, the capacity bucket) against HB (chunked), both with
    a bf16 KV cache: the same greedy streams, or, at a request's first
    divergent step, HB's top-2 logit margin for that token (HBW's bundle,
    the prompt and the tokens before it in one unpadded prefill) below H's
    LOGIT_TOL.  Returns {uid: (step, margin)} of the divergences."""
    import numpy as np
    import torch
    out = {}
    for uid, toks in chunked_run["streams"].items():
        got = run["streams"][uid]
        if got == toks:
            continue
        i = next(k for k, (a, b) in enumerate(zip(got, toks)) if a != b)
        prompt = h_requests(eng.cfg)[uid].prompt
        seq = np.concatenate([prompt, np.asarray(toks[:i], np.int32)])[None]
        logits, _ = eng.bundle.prefill(eng.params, {"tokens": torch.as_tensor(
            seq, device=eng.device)}, eng.bundle.init_caches(1, seq.shape[1] + 1))
        top2 = logits[0].float().topk(2).values
        margin = float(top2[0] - top2[1])
        log(f"serve HBW: request {uid} diverges from HB's at step {i}, top-2 "
            f"margin {margin:.4g}")
        need(margin < LOGIT_TOL["H"], f"HBW: request {uid} diverges from HB's at step "
             f"{i} with a top-2 margin of {margin} >= {LOGIT_TOL['H']}")
        out[uid] = (i, margin)
    log(f"serve HBW: streams equal HB's but at {out or 'none'}")
    return out


# ------------------------------------------------------------------ path G
# The paper's CNN track at the widths of the repository's paper tables
# (benchmarks/_cnn_common.py:19-27, 44-58 and benchmarks/paper_tables.py:
# 24-68, copied here): task -> (arch, training steps)
G_TASKS = {"cls_resnet": ("mini_resnet", 250), "cls_mobilenet": ("mini_mobilenet", 250),
           "seg_unet": ("mini_seg", 200)}
G_WIDTH, G_RES, G_CLASSES = 24, 20, 16
G_BATCH = 32               # training batch
G_NOISE = 0.45             # the gratings' noise in every set
G_CALIB = (16, 8, 5)       # calibration images, batch, seed
G_EVAL = (384, 77)         # eval images and seed (Tables 1-2)
G_OOD = (0, 3)             # corrupt_batch's rng seed (one rng over the tasks), max severity
G_FIDELITY = 64            # images of the surrogate-fidelity tape
G_GAMMAS = (2, 4)          # PDQ's sampling stride swept on cls_resnet (Fig. 4)
G_EVAL_BATCH = 128
G_FP32_FLOOR = 0.90        # cls_resnet's fp32 top-1 (the reference: 0.990 on a CPU)
# card against the port's plain CPU run on the same weights, state and images:
# logits in the unquantized modes as a share of max |logit| (convolutions
# reduce in another order: ~1e-6); qstate relative (a static range's edges
# to its width); top-1 agreement in each quantized mode (a pre-activation at
# a .5 tie takes the neighbouring code); every table entry
G_LOGIT_RTOL = 1e-4
G_QSTATE_RTOL = 1e-4
G_TOP1_AGREE = 0.99
G_TABLE_TOL = 0.02
G_COLUMNS = [("fp32", "none", False)] + [
    (f"{name}_{'C' if pc else 'T'}", mode, pc)
    for name, mode in (("ours", "pdq"), ("dynamic", "dynamic"), ("static", "static"))
    for pc in (False, True)]
# Fig. 3's shapes (benchmarks/fig3_latency.py:34-71): N 1, 32 x 32, 3 x 3
G_FIG3_CIN = (4, 8, 16, 32, 64)      # C_out 3
G_FIG3_COUT = (4, 8, 16, 32, 64)     # C_in 3
G_FIG3_GAMMA = (1, 2, 4, 8)          # C_in 3, C_out 16


def g_leaves(tree):
    from repro_torch.models import cnn
    return cnn._leaves(tree)


def g_apply_fn(cfg):
    from repro_torch.models import cnn

    def apply_fn(params, batch, *, spec, qstate, tape=None):
        return cnn.cnn_apply(params, batch, cfg=cfg, spec=spec, qstate=qstate, tape=tape)
    return apply_fn


def g_run(params, cfg, imgs, spec, qstate):
    """Logits of every image, in G_EVAL_BATCH batches, on the params' device."""
    import torch
    from repro_torch.models import cnn
    dev = g_leaves(params)[0].device
    with torch.no_grad():
        return torch.cat([cnn.cnn_apply(params, torch.from_numpy(imgs[i:i + G_EVAL_BATCH]).to(dev),
                                        cfg=cfg, spec=spec, qstate=qstate)
                          for i in range(0, len(imgs), G_EVAL_BATCH)])


def g_calibrate(params, cfg, calib, per_channel, gamma=1):
    import torch
    from repro_torch.core import run_calibration, spec_for_mode
    dev = g_leaves(params)[0].device
    return run_calibration(g_apply_fn(cfg), params,
                           [torch.from_numpy(c).to(dev) for c in calib],
                           spec_for_mode("pdq", per_channel=per_channel, gamma=gamma))


def g_evaluate(params, cfg, data, labels, qstates, gamma=1, columns=G_COLUMNS):
    """Tables 1-2's row for each domain: {column: (accuracy, predictions)}."""
    from repro_torch.core import spec_for_mode
    rows = {}
    for domain, imgs in data.items():
        rows[domain] = {}
        for col, mode, pc in columns:
            pred = g_run(params, cfg, imgs, spec_for_mode(mode, per_channel=pc, gamma=gamma),
                         qstates[pc] if mode != "none" else None).argmax(-1).cpu().numpy()
            rows[domain][col] = (float((pred == labels).mean()), pred)
    return rows


def g_fidelity(params, cfg, imgs):
    """paper_tables.py:45-68: over an observe tape (per channel), the
    correlation of the surrogate's predicted means and stds with the
    empirical moments of each layer's pre-activations."""
    import numpy as np
    import torch
    from repro_torch.core import spec_for_mode
    from repro_torch.core.policy import as_observe
    from repro_torch.core.surrogate import empirical_moments
    tape = {}
    dev = g_leaves(params)[0].device
    with torch.no_grad():
        g_apply_fn(cfg)(params, torch.from_numpy(imgs[:G_FIDELITY]).to(dev),
                        spec=as_observe(spec_for_mode("pdq", per_channel=True)), qstate={},
                        tape=tape)
    mcorr, scorr = [], []
    for rec in tape.values():
        if rec["moments"] is None:
            continue
        emp = empirical_moments(rec["y"], per_channel=True)
        pm, em = (a.cpu().numpy().ravel() for a in (rec["moments"].mean, emp.mean))
        ps, es = (a.cpu().numpy().ravel() for a in (rec["moments"].std, emp.std))
        if np.std(em) > 1e-6 and np.std(pm) > 1e-6:
            mcorr.append(float(np.corrcoef(pm, em)[0, 1]))
        if np.std(es) > 1e-6 and np.std(ps) > 1e-6:
            scorr.append(float(np.corrcoef(ps, es)[0, 1]))
    return {"mean_corr": float(np.mean(mcorr)), "std_corr": float(np.mean(scorr)),
            "n_layers": len(tape)}


def g_parity(task, params, cfg, data, labels, qstates, card_rows, calib):
    """The card against the port's plain CPU run, with TF32 allowed for
    cuDNN globally: the module pins its own convolutions to IEEE f32, so
    the card's unquantized logits stay within G_LOGIT_RTOL of the CPU's."""
    import numpy as np
    import torch
    from repro_torch.core import spec_for_mode
    from repro_torch.models.cnn import _tree_map
    cpu = _tree_map(lambda a: a.cpu(), params)
    cpu_q = {pc: _tree_map(lambda a: a.cpu(), q) for pc, q in qstates.items()}
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        logit_err = {}
        for mode in ("none", "observe"):
            for domain, imgs in data.items():
                spec = spec_for_mode(mode, per_channel=True)
                a = g_run(params, cfg, imgs, spec, None).cpu()
                b = g_run(cpu, cfg, imgs, spec, None)
                err = max_abs(a, b) / float(b.abs().max())
                need(err <= G_LOGIT_RTOL, f"G {task} {mode} {domain}: card logits "
                     f"{err:.3g} of max|logit| from the CPU's")
                logit_err[f"{mode}_{domain}"] = err
        qstate_err, worst = 0.0, None
        for pc in (False, True):
            card_q = g_calibrate(params, cfg, calib, pc)
            host_q = g_calibrate(cpu, cfg, calib, pc)
            need(sorted(card_q) == sorted(host_q), f"G {task}: qstate layers")
            for name, entry in host_q.items():
                # a static range edge against its range's width (the grid it
                # sets: 1e-4 of it is 0.03 of a code), alpha and beta against
                # themselves
                width = (entry["static_hi"] - entry["static_lo"]).clamp_min(1e-12)
                for key, b in entry.items():
                    a = card_q[name][key].cpu()
                    scale = width if key.startswith("static") else b.abs()
                    e = float(((a - b).abs() / scale).max())
                    if e > qstate_err:
                        qstate_err, worst = e, f"{name}.{key} (pc {pc})"
                    need(e <= G_QSTATE_RTOL, f"G {task} {name}.{key} (pc {pc}): card "
                         f"qstate {e:.3g} relative from the CPU's")
        card_tf32 = g_evaluate(params, cfg, data, labels, qstates)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    host = g_evaluate(cpu, cfg, data, labels, cpu_q)
    agree, table_err, tf32_moved = {}, 0.0, 0
    for domain in data:
        for col, mode, _ in G_COLUMNS:
            a_acc, a_pred = card_tf32[domain][col]
            b_acc, b_pred = host[domain][col]
            tf32_moved += int((a_pred != card_rows[domain][col][1]).sum())
            share = float((a_pred == b_pred).mean())
            agree[f"{domain}/{col}"] = share
            need(mode == "none" or share >= G_TOP1_AGREE,
                 f"G {task} {domain} {col}: top-1 of the card and the CPU agree on "
                 f"{share:.4f} of the images")
            table_err = max(table_err, abs(a_acc - b_acc), abs(card_rows[domain][col][0] - b_acc))
            need(abs(a_acc - b_acc) <= G_TABLE_TOL
                 and abs(card_rows[domain][col][0] - b_acc) <= G_TABLE_TOL,
                 f"G {task} {domain} {col}: card {a_acc:.4f} / {card_rows[domain][col][0]:.4f} "
                 f"against the CPU's {b_acc:.4f}")
    return {"logit_err": logit_err, "qstate_rel_err": qstate_err, "qstate_worst": worst,
            "top1_agree_min": min(v for k, v in agree.items() if "fp32" not in k),
            "top1_agree": agree, "table_max_diff": table_err,
            "preds_moved_by_global_tf32": tf32_moved,
            "cpu_table": {d: {c: host[d][c][0] for c, _, _ in G_COLUMNS} for d in data}}


def g_fig3(flush):
    """Fig. 3 on the card: the PDQ moment estimate (window sums and the
    aggregation, weight stats precomputed) against the conv itself and
    against the dynamic baseline's range reduction over the conv's
    materialised output, per tensor, each `median_ms` (L2 flushed)."""
    import torch
    from repro_torch.core import qlinear, surrogate
    from repro_torch.core.policy import QuantPolicy
    gen = torch.Generator(device="cuda").manual_seed(3)
    none = QuantPolicy(mode="none")

    def case(cin, cout, gamma=1):
        x = torch.randn((1, 32, 32, cin), generator=gen, device="cuda")
        k = 0.1 * torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
        ws = surrogate.weight_stats(k, (0, 1, 2), per_channel=False)
        y = qlinear.conv2d(x, k, None, name="L", policy=none)
        return {"cin": cin, "cout": cout, "gamma": gamma, "positions": (32 // gamma) ** 2,
                "est_ms": median_ms(lambda: surrogate.conv_moments(
                    x, ws, (3, 3), (1, 1), "SAME", False, gamma), flush=flush),
                "conv_ms": median_ms(lambda: qlinear.conv2d(x, k, None, name="L", policy=none),
                                     flush=flush),
                "range_ms": median_ms(lambda: qlinear._example_range(y, False), flush=flush)}

    return {"vs_cin": [case(c, 3) for c in G_FIG3_CIN],
            "vs_cout": [case(3, c) for c in G_FIG3_COUT],
            "vs_gamma": [case(3, 16, g) for g in G_FIG3_GAMMA]}


def phase_cnn():
    """Path G: the paper's protocol on the card (Tables 1-2, the surrogate's
    fidelity, Fig. 4's stride on cls_resnet, Fig. 3's costs), each task
    trained, calibrated and evaluated there, then held against the port's
    plain CPU run.  It reaches none of the ten kernels: their counts are
    zeroed before and must read 0 after."""
    import numpy as np
    import torch
    from repro_torch.data.corruptions import corrupt_batch
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    ops.reset_counts()
    t_g = time.perf_counter()
    rng = np.random.default_rng(G_OOD[0])
    out = {"tasks": {}}
    for task, (arch, steps) in G_TASKS.items():
        seg = task.startswith("seg")
        cfg = cnn.CNNConfig(arch=arch, width=G_WIDTH, res=G_RES, n_classes=G_CLASSES)
        t0 = time.perf_counter()
        params = cnn.train_cnn(cfg, steps=steps, batch=G_BATCH, segmentation=seg,
                               device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        imgs, labels = cnn.make_gratings(G_EVAL[1], G_EVAL[0], res=G_RES,
                                         n_classes=G_CLASSES, noise=G_NOISE)
        if seg:
            labels = cnn.seg_labels(labels, G_RES, G_CLASSES)
        data = {"in_domain": imgs, "ood": corrupt_batch(imgs, rng, max_severity=G_OOD[1])}
        c_imgs, _ = cnn.make_gratings(G_CALIB[2], G_CALIB[0], res=G_RES,
                                      n_classes=G_CLASSES, noise=G_NOISE)
        calib = [c_imgs[i:i + G_CALIB[1]] for i in range(0, G_CALIB[0], G_CALIB[1])]
        t0 = time.perf_counter()
        qstates = {pc: g_calibrate(params, cfg, calib, pc) for pc in (False, True)}
        calib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = g_evaluate(params, cfg, data, labels, qstates)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        rec = {"train_s": train_s, "calibrate_s": calib_s, "eval_s": eval_s,
               "n_params": sum(a.numel() for a in g_leaves(params)),
               "table": {d: {c: rows[d][c][0] for c, _, _ in G_COLUMNS} for d in data},
               "surrogate": g_fidelity(params, cfg, imgs)}
        for v in g_leaves(rec["table"]):
            need(0.0 <= v <= 1.0, f"G {task}: accuracy {v}")
        if task == "cls_resnet":
            need(rec["table"]["in_domain"]["fp32"] >= G_FP32_FLOOR,
                 f"G {task}: fp32 top-1 {rec['table']['in_domain']['fp32']:.4f} < "
                 f"{G_FP32_FLOOR}")
            rec["gamma_sweep"] = []
            for gamma in G_GAMMAS:
                for pc in (False, True):
                    q = g_calibrate(params, cfg, calib, pc, gamma)
                    col = f"ours_{'C' if pc else 'T'}"
                    r = g_evaluate(params, cfg, data, labels, {pc: q}, gamma,
                                   [(col, "pdq", pc)])
                    rec["gamma_sweep"].append({"gamma": gamma, "granularity": col[-1],
                                               **{d: r[d][col][0] for d in data}})
        t0 = time.perf_counter()
        rec["parity"] = g_parity(task, params, cfg, data, labels, qstates, rows, calib)
        rec["parity_s"] = time.perf_counter() - t0
        out["tasks"][task] = rec
        t, s = rec["table"], rec["surrogate"]
        for d in data:
            log(f"G {task} {d}: " + ", ".join(f"{c} {t[d][c]:.4f}" for c, _, _ in G_COLUMNS))
        log(f"G {task}: {rec['n_params']} params, trained {steps} steps in {train_s:.1f} s, "
            f"calibrated in {calib_s:.2f} s, evaluated in {eval_s:.2f} s; surrogate "
            f"mean-corr {s['mean_corr']:.3f} std-corr {s['std_corr']:.3f} over "
            f"{s['n_layers']} layers; parity (TF32 allowed globally) in "
            f"{rec['parity_s']:.1f} s: logits {max(rec['parity']['logit_err'].values()):.3g} "
            f"of max|logit|, qstate {rec['parity']['qstate_rel_err']:.3g} "
            f"({rec['parity']['qstate_worst']}), top-1 agree >= "
            f"{rec['parity']['top1_agree_min']:.4f}, tables within "
            f"{rec['parity']['table_max_diff']:.4f}, predictions moved by the global TF32 "
            f"{rec['parity']['preds_moved_by_global_tf32']}")
        for r in rec.get("gamma_sweep", []):
            log(f"G {task} gamma {r['gamma']} {r['granularity']}: in_domain "
                f"{r['in_domain']:.4f} ood {r['ood']:.4f}")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out["fig3"] = g_fig3(flush)
    del flush
    for part, rows in out["fig3"].items():
        for r in rows:
            log(f"G fig3 {part}: cin {r['cin']} cout {r['cout']} gamma {r['gamma']} "
                f"positions {r['positions']}: estimate {r['est_ms'] * 1e3:.2f} us, conv "
                f"{r['conv_ms'] * 1e3:.2f} us, dynamic range {r['range_ms'] * 1e3:.2f} us")
    c = ops.counts()
    need(all(v["launches"] == 0 and v["entries"] == 0 for v in c.values()),
         f"G reached a kernel: {c}")
    out["seconds"] = time.perf_counter() - t_g
    log(f"G: the CNN track in {out['seconds']:.1f} s, K1-K10 entered and launched 0 times")
    return out


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

    with timed("build"):
        phase_build()

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    cfg = get_config("stablelm-1.6b")
    params = build_model(cfg, "cuda").init(0)

    from repro_torch.kernels import ops

    def engine(path):
        int8_kv, pdq, _, extra = PATHS[path]
        t0 = time.perf_counter()
        # FF's graph is captured under the fault hook, which it reads
        with ops.pdq_fault() if path == FAULT_PATH else contextlib.nullcontext():
            eng = build_engine(ServeConfig(arch="stablelm-1.6b", reduced=False, slots=8,
                                           max_len=512, int8_kv=int8_kv,
                                           quantize_weights=pdq, device="cuda", **extra),
                               cfg=cfg, params=params)
        torch.cuda.synchronize()
        log(f"model {path}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
            f"{cfg.dtype}, {'PDQ-int8' if pdq else 'bf16'} weights, "
            f"{'int8' if int8_kv else 'bf16'} KV cache, "
            f"{f'paged pool of {eng.pool_pages} pages of {PAGE}' if eng.paged else 'slot rows'}, "
            f"{eng.decode_steps} decode steps a dispatch, "
            f"{'guarded' + (' under the fault hook' if path == FAULT_PATH else '') if eng.pdq_fallback else 'unguarded'}, built in "
            f"{time.perf_counter() - t0:.1f} s, its decode graph captured in "
            f"{eng._graph.capture_s:.2f} s (pool {eng._graph.pool_bytes / 2**20:.1f} MiB)")
        return eng

    # A and C serve twice, in turns A (B) C C F A, so that their and F's
    # end-to-end times compare within this call whatever the host's warm-up
    # costs; then the paged pool at parity (D1) and under pressure (D2);
    # then A and D1 at 16 decode steps a dispatch; last FF, every projection
    # falling back
    serve, counts, parity = {}, {}, {}
    for path in ("A", "B", "C", "C", "F", "A", "D1", "D2", "A16", "D16", "FF"):
        eng = engine(path)
        if path == "A" and not serve:
            with timed("kernels"):
                rows, detail = phase_kernels(eng)
            recs = e_records(eng)
        with timed(f"serve {path}"):
            c, run = phase_serve(eng, path)
        if path not in counts:
            counts[path] = c
            if path in ("A", "B", "C", "D1", "F"):
                with timed(f"step {path}"):
                    run["step"] = phase_step(eng, path, run["decode_step_median_ms"])
            if path in ("A", "B", "C", "F", "FF"):
                with timed(f"parity {path}"):
                    parity[path], run["parity_pdq"] = phase_parity(eng, path)
        if path in ("D1", "D2", "D16"):
            check_paged_run(path, run, serve["A"][0])
        if path == "A16":
            check_streams(path, run, serve["A"][0])
        serve.setdefault(path, []).append(run)
        del eng
        torch.cuda.empty_cache()
    for path, runs in serve.items():
        log(f"serve {path}: decode dispatch median per run "
            f"{[r['decode_step_median_ms'] for r in runs]} ms, per token "
            f"{[r['decode_ms_per_token'] for r in runs]} ms, tokens/s "
            f"{[r['decode_tokens_per_s'] for r in runs]}, prefill per run "
            f"{[r['prefill_s'] for r in runs]} s, pdq {[r['pdq'] for r in runs]}")
    log("serve A and F (guarded, over HTTP): decode dispatch medians "
        f"A {[r['decode_step_median_ms'] for r in serve['A']]} ms, "
        f"F {[r['decode_step_median_ms'] for r in serve['F']]} ms; phase 4 graph step "
        f"A {serve['A'][0]['step']['graph']['wall_ms_median']:.3f} ms, "
        f"F {serve['F'][0]['step']['graph']['wall_ms_median']:.3f} ms")
    # path E: the unfused projection and the standalone quantization ops
    with timed("unfused E"):
        counts["E"], unfused = phase_unfused(recs)
    del recs, params
    torch.cuda.empty_cache()
    # paths H, HD, HB, HBW: gemma3-12b at full width with chunked prefill
    h_counts, h_serve, h_parity = phase_gemma3(detail)
    counts.update(h_counts)
    serve.update(h_serve)
    parity.update(h_parity)
    # paths DS, DSD, AR: deepseek-v2-236b and arctic-480b at full width
    m_counts, m_serve, m_parity = phase_moe(detail)
    counts.update(m_counts)
    serve.update(m_serve)
    parity.update(m_parity)
    # paths M, Z, ZD: mamba2-2.7b and zamba2-7b at full width and depth
    s_counts, s_serve, s_parity = phase_ssm(detail)
    counts.update(s_counts)
    serve.update(s_serve)
    parity.update(s_parity)
    # paths V, VD, S, SD: phi-3-vision-4.2b and seamless-m4t-medium at full
    # width and depth, served with their prefill extras
    x_counts, x_serve, x_parity = phase_extras(detail)
    counts.update(x_counts)
    serve.update(x_serve)
    parity.update(x_parity)
    # path G: the CNN track, trained, calibrated and evaluated on the card
    with timed("cnn G"):
        cnn_track = phase_cnn()

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
        # no pallas_call: the fallback branch of _guard_pdq's lax.cond
        "fp_dequant": "src/repro/kernels/ops.py:209",
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
        "fp_dequant": "src/repro_torch/csrc/fp_dequant.cu",
    }
    kernels = []
    path_of = {"decode_attend_i8kv": "B", "cache_scatter_pages": "D", "act_stats": "E",
               "quantize": "E", "dequantize": "E", "fp_dequant": "F"}
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
                            launches_by_path={p: c_[name]["launches"]
                                              for p, c_ in counts.items()},
                            **{f"shapes_{tag}": [
                                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms")}
                                for r in detail if r["name"] == name and r.get("path") == tag]
                               for tag in ("H",) + MOE_PATHS + SSM_PATHS
                               + EXTRAS_PATHS},
                            **{k: v for k, v in row.items() if k in EXTRA_KEYS}))
        if name == "fp_dequant":
            # F never takes it; FF takes every one
            kernels[-1].update(launches_fault=counts[FAULT_PATH][name]["launches"])
        if name == "pdq_prologue":
            # every mode's row, and A's launches per mode
            kernels[-1].update(
                mode_launches=serve["A"][0]["prologue_modes"],
                modes=[{k: r[k] for k in ("mode", "shape", "max_abs_err",
                                          "ms", "plain_ms", "bound_ms", "bound_by",
                                          "same_bytes_ms", "host_us")}
                       for r in detail if r["name"] == name and "path" not in r])
    need(sorted(k["name"] for k in kernels) == sorted(replaces),
         f"kernel rows {[k['name'] for k in kernels]}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             kernels=kernels, kernel_shapes=detail, serve=serve,
             parity_max_logit_diff=parity, unfused=unfused, cnn=cnn_track,
             phase_s=PHASE_S), indent=1,
        default=str))
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
