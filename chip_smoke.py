#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Serving paths of full-width stablelm-1.6b (24 layers, bf16, random weights
from a seeded generator), of full-width gemma3-12b (H, HD, HB, HBW:
chunked prefill and the local/global decoder) and of the MoE families at
full width, cut in depth (DS, DSD: deepseek-v2-236b; AR: arctic-480b)
and of the SSD families at full width and full depth (M: mamba2-2.7b; Z,
ZD: zamba2-7b) and of the prefill extras' families at full width and full
depth (V, VD: phi-3-vision-4.2b; S, SD: seamless-m4t-medium) and of the
last two dense families at full width and full depth (G2, G2D: gemma2-2b;
Y, YD: yi-6b), each built with build_engine(ServeConfig(...,
device="cuda")), and one path of ops-level calls on stablelm's weights
(E):

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
  G2 gemma2-2b at full width and full depth (26 layers, local and global
     alternating, window 4096; d_model 2304, 8 x 256 heads over 4 kv
     heads, d_ff 9216, vocab 256000, attention softcap 50, final logit
     softcap 30, embed_scale; seeded random bf16 weights, PDQ-int8 records
     made by G2's engine), int8 KV, slot rows, A's serving shape and
     requests: the softcap sends every layer, global ones too, to the
     plain attention over its dequantized int8 cache (at max_len 512 a
     local layer's ring holds 512 positions, so the window never binds),
     so wo's prologue is K1's: K1 x 3, K2 x 3, K3 a layer and step (182 a
     step), no K4/K5, and K6;
  G2D G2 on a paged pool (page 64, prefix sharing): every layer's int8
     K/V pages (the local rings too: max_len < window), K7 in K6's place;
     its streams must equal G2's;
  Y  yi-6b at full width and full depth (32 layers, d_model 4096, 32 x 128
     heads over 4 kv heads: G 8 at Dh 128, the limit of K4/K5's (8, 128)
     instance; d_ff 11008, vocab 64000; ~12 GB of seeded random bf16
     weights, PDQ-int8 records made by Y's engine), int8 KV, slot rows, A's
     serving shape and requests: A's 7 launches a layer and step (K5 at
     G 8);
  YD Y on a paged pool (page 64, prefix sharing): K7 in K6's place; its
     streams must equal Y's;
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
  AL A through the per-request prefill baseline (batch_prefill=False): A's
     weights, slots, max_len and requests; each request prefills alone at
     its exact length (K1-K3 a layer as one of A's rounds) and lands with
     one K6 launch; decode is A's.  Its streams must equal A's, or diverge
     where the token's top-2 margin is below A's LOGIT_TOL, and its prefill
     seconds are logged beside A's.
  TR, TD, T, TQ  training, in a child process (``--train-child``) whose
     environment sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before its first
     cuBLAS handle, for the trainer's deterministic algorithms.  TR: every
     registered config at its reduced size (f32, TF32 off), one train_loss
     + backward and one train step (f32 moments, then int8) on the card
     against the CPU from the same seeded weights and SyntheticLM batch
     (stub patches / frames where needed): loss within TR_LOSS_RTOL, every
     grad within TR_TOL, AdamW from the same grads within TR_TOL (int8
     codes one apart at most), the train step's params bit-equal on each
     device to AdamW of that device's grads and the two devices' within
     adamw.first_step_bound of them; a router decision that differs is reported
     and that config not bound; the grads twice without and twice with the
     deterministic algorithms (the latter bit-equal).  TD: the same
     determinism probe at stablelm-1.6b's full width (2 layers, T's batch).
     T: stablelm-1.6b uncut (24 layers, d_model 2048, vocab 100352, bf16,
     init(0)), the Trainer with f32 AdamW (lr 1e-3, warmup_cosine), remat
     "full", loss_chunk 512, SyntheticLM 8 x 1024, T_STEPS steps, one blocking
     checkpoint at the end; a second Trainer on the same directory restores
     it bit for bit; every loss finite, the last five steps' mean below the
     first five's, no restart; s/step, tokens/s, model TFLOP/s, peak GiB,
     checkpoint bytes and seconds.  TQ: T with int8 moments, a checkpoint
     every TQ_CKPT_EVERY steps and one injected failure at step TQ_FAIL_AT:
     one restart, the
     replayed steps' losses bit-equal; its loss beside T's per step and its
     optimizer state's bytes beside T's.  TH: T's steps from T's state
     under remat "save_heavy" (each layer's attention output kept for the
     backward beside the block's input, the rest recomputed): every
     step's loss and the final params bit-equal to T's (else within
     TR_LOSS_RTOL / TR_TOL, the leaves apart named); s/step, peak GiB and
     a profiled step's busy ms beside T's.  No training path reaches a hand
     kernel (the reference trains fp params; ``lin`` of an fp leaf is a
     plain matmul).
  TM, TMF  the sharded train step (``build_train_step(..., mesh)`` under
     ``dist_context_for(mesh)``) over a 2x2 (data, model) mesh of four
     child processes (``--train-mesh-child``), every entry cuda:0, one gloo
     group (NCCL refuses ranks that share a card; gloo stages each
     collective through host copies), CUBLAS_WORKSPACE_CONFIG set, every
     step under ``deterministic()``.  TM: every registered config at its
     reduced size (f32), SyntheticLM 4 x 32 (stub extras where needed), two
     steps at a constant schedule from the same seeded weights, against the
     one-process step on the card (rank 0): each step's loss within
     TR_LOSS_RTOL, the params after both within TR_TOL at all but 1 in 1000
     elements and within 2 lr a step everywhere.  deepseek-v2 and arctic
     run expert-parallel (8 experts, 4 a model rank): each rank routes its
     own token block with the capacity of its own tokens and the aux is the
     mean of the blocks', as in the reference, so one process computes
     another function; their reference is the same 2x2 step on CPU tensors
     (the CPU tests hold that against the reference's EP), under the same
     gates unless a router decision differs between the two (reported, as
     TR does).  Then ``compressed_psum``
     over the four ranks on CUDA tensors against the same call on CPU
     tensors, and stablelm's TM state, gathered whole and checkpointed,
     restored over 2x1 (ranks 0-1) and on one process: the next step's loss
     and params equal the 2x2 run's within TR_LOSS_RTOL / TR_TOL.  TMF:
     stablelm-1.6b uncut (bf16, remat "full", f32 AdamW, warmup_cosine),
     SyntheticLM 4 x 1024 (2 rows a data rank), TMF_STEPS steps; first one
     process (rank 0) takes the same steps alone; step 1's loss within
     TMF_LOSS_RTOL of its, every loss finite, the later steps' gaps
     reported; s/step, the collectives' share of it (each collective timed
     between two synchronizations), host bytes staged a step, peak GiB a
     rank.  Both reach no hand kernel (every count 0).
  SP the sequence-parallel prefill (``serve/seq_parallel.SeqPrefill``, the
     reference's opt prefill) in the same four children after TMF, over a
     1x4 mesh of them on cuda:0 (gloo): stablelm-1.6b uncut with A's
     PDQ-int8 weights (``quantize_param_tree`` of init(0)) and the int8 KV
     cache, SP_ROWS rows of SP_SEQ seeded tokens, SP_SEQ / 4 positions a
     rank; each rank gathers each layer's weights whole over the four
     (int8 codes K-major), its layer's fp K/V over the model group, and
     lands its 1024 slots of every cache leaf.  First one process (rank 0)
     prefills the same rows alone with ``bundle.prefill``.  Gates: every
     layer's int8 K/V codes, scales and ``pos``, joined from the ranks'
     blocks, equal to the one-process cache's; every rank's logits equal
     and within LOGIT_TOL["A"] of one process's (the largest difference
     printed), the greedy next token equal wherever one process's top-2
     margin is at least that; each rank's K1/K2/K3 launches equal to the
     one-process prefill's (each rank runs every layer's projections over
     its rows), each > 0.  Printed: the seconds (one process and the
     mesh), the collectives' seconds, calls and bytes, the bytes staged
     through the host, each rank's peak.
  DR the dry run (``repro_torch.launch.dryrun``: rank 0's program traced
     under FakeTensorMode over fake cards, allocating nothing) in
     DR_GROUPS child processes (``--dryrun-child``, niced, no card visible)
     started after the build, so that their CPU time runs beside the card's
     phases: T's cell (stablelm-1.6b, 8 x 1024, remat "full", one card),
     A's decode step (PDQ-int8, int8 KV, 8 slots, max_len 512), TMF's cell
     (2x2), and one full-size cell of each kind on the 16x16 production
     mesh: yi-6b's train_4k and decode_32k, and mamba2-2.7b's prefill_32k
     (an attention layer's prefill_32k traces 2048 score tiles, ~50 s a
     layer of CPU time: yi-6b's would take ~half an hour, past this run's
     limit), and SP's cell (the opt prefill over a 1x4 fake mesh, on
     PDQ-int8 weights and the int8 KV cache, as SP runs it).  Gates, after
     SP: every cell ``ok``; A's ``kernels`` census equal to the entries of
     one eager step of A's engine; TMF's collective bytes by kind and by
     group equal, exactly, to what ``hlo_analysis.collective_counter``
     reads around each of rank 0's real TMF steps (the host bytes gloo
     stages beside them); SP's likewise to rank 0's SP prefill, and its
     census to that run's entries.  T's and SP's predicted ``peak_bytes``
     are printed beside their measured ``torch.cuda.max_memory_allocated``
     and their ratio.

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
                equal to plain's on both routes; the fallback at the four
                guarded projections' decode shapes and QKV's prefill rows,
                taken (flag set) and not taken, on the wgmma route; before the
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
                ``family_kernels``): K1-K3 at V's QKV (3072 -> 3 x 3072,
                also at 8 x (1024 + 256) prefill rows), wo, gate/up (2 x
                8192) and w_down, and at S's QKV, cross wq, the cross
                (wk, wv) group over 8 x 8 memory rows, cross wo, gate/up and
                w_down; K4/K5 at V's G 1, Dh 96, Sp 1536 and S's Hkv 16,
                Dh 64, Sp 512; K6 a round's landing (S's with the cross
                leaves); K7 VD's and SD's landing and gather.  The
                dense families' rows (tagged G2, G2D, Y, YD, the same
                ``family_kernels``): K1-K3 at G2's QKV (2304 -> 2048 + 2 x
                1024), wo's interval at 2048 (every G2 layer runs it),
                gate/up (2 x 9216) and w_down, and at Y's QKV (4096 ->
                4096 + 2 x 512), wo, gate/up (2 x 11008, w_down's prologue
                over the 11008-wide row) and w_down; K4/K5 at Y's B 8,
                Hkv 4, G 8, Dh 128, Sp 512; K6 a round's landing; K7
                G2D's and YD's landing and gather;
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
                taken the wgmma route, every K4/K5 launch the split route,
                every K8/K9/K10 launch the vector route and every fallback
                launch the wgmma route (MAIN_ROUTE), and
                the other paths' kernels must not have run (F and FF: no
                K3, one fallback launch a guarded projection, 4 a layer and
                model step; FF's pdq_fallbacks exactly that many, F's 0);
                the runs go in
                turns A B C C F A D1 D2 A16 D16 FF, so that A's, C's and F's
                times compare within one call; D1's, D2's, A16's and D16's greedy
                streams must equal A's first run's, D1 and D16 must
                share the system prompt's pages, D2 must preempt, spill and
                restore; per-token decode time and tokens/s of each run;
  4. step     - on A, B, C, D1, F, H, DS, DSD, AR, M, Z, V, S, G2 and Y, one
                decode step of the full pool at position 300 (V's behind
                its 1024 patches) two ways on the
                same state, eager (ops
                launched from the host) and a replay of the engine's
                one-step graph, in five alternated pairs of three-step
                windows: wall ms a step; then torch.profiler over a window
                of each: device busy ms, kernels a step and idle share; on
                A also a graph of the same block captured with telemetry
                off, alternated with the two (the counting's cost);
  5. parity   - on A, B, C, F, FF, H, DS, DSD, AR, M, Z, V, S, G2 and Y (F and
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
                S and SD (``phase_dense``): their kernel rows, phases 3-5
                for V and S with the paths' extras, VD's and SD's phase 3
                and their streams against V's and S's (no prefix hit).
                Then the dense families G2, G2D, Y and YD
                (``phase_dense``): their kernel rows, phases 3-5 for G2
                and Y, G2D's and YD's phase 3 and their streams against
                G2's and Y's.
  7. cnn      - path G, last: counts zeroed before and read after (every
                kernel 0), cls_resnet's fp32 top-1 >= G_FP32_FLOOR, every
                accuracy in [0, 1]; parity with the CPU: unquantized logits
                within G_LOGIT_RTOL of max |logit|, qstate within
                G_QSTATE_RTOL, top-1 agreement >= G_TOP1_AGREE in every
                quantized mode, every table entry within G_TABLE_TOL.

  8. train    - after G: path AL (phase 3's gates on its census, then its
                streams against A's), then the child process of TR, TD, T,
                TQ and TH, whose results land in chiprun_out/chip_smoke_train.json
                and in chip_smoke.json's "train".
  9. mesh     - after A's runs and before E (``phase_mesh``): A's engine on
                a ('data', 'model') mesh whose every entry is cuda:0, 4
                slots a replica, A's requests: X21 (2x1: data only), X22
                (2x2: each replica's projections split over 2 column
                shards, K2 once a shard over its own block of columns,
                shard 1 on a stream of its own, no K3) and X22D (X22
                paged, D1's pool a replica); each path logs its split
                weights a device and its streams a replica (the same
                code serves a row over four cards:
                tools/torch_serve_mesh_cards.py).  First the K2 rows at
                every TP column block of A's records at 8 and 2048 rows
                (wgmma from the shifted base, against plain and against
                the unsplit launch's columns) and the fallback over a
                shard's columns, taken and not (rows tagged "X").  Each
                path: phase 3's gates with the exact census a replica
                (``mesh_census``: 4 + 4T launches a layer and decode step
                under TP), every decode dispatch a replay of each
                replica's graph, streams equal to A's but at tokens whose
                top-2 margin in A's run is below A's LOGIT_TOL (counted);
                X22's parity (phase 5 under the replica's shards) and its
                replayed step against A's (five alternated pairs, wall and
                profiler busy ms); X22D's streams equal X22's.  Then MH:
                X22's mesh served by two child processes (``--mesh-child``,
                a gloo group on 127.0.0.1), process p hosting replica p,
                decode_steps=4: tokens and every stat that does not depend
                on the dispatch's N identical to X22's, both processes
                admitting and drained, each child's census for its replica.

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
BF16_OPS = 989e12
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
             "V": 0.34375, "S": 0.25,
             # G2 (gemma2-2b): C's argument.  Its softcaps keep K4/K5 off
             # the path: every layer attends its int8 cache in the same
             # plain torch code in both runs, and the cache write is the
             # same torch code too, so the kernels that differ are K1-K3
             # (plain's bits but for sums in another order), over 26
             # layers in place of C's 24.  The final cap 30 tanh(x / 30)
             # has slope at most 1: it cannot widen a difference before
             # it.  Y (yi-6b): A's argument (K5 at G 8) over 32 layers,
             # V's 11 bf16 ulps of 0.03125 (its random logits: final norm,
             # then d_model 4096 x N(0, 0.02) rows, reach |logit| ~5-7
             # over 64000 tokens, inside [4, 8))
             "G2": 0.05, "Y": 0.34375,
             # X22: A's program with each projection's columns split over
             # two shards (bit for bit) and the unfused MLP in K3's place
             # (within K3's 1e-4): A's argument
             "X22": 0.25}
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
             "M": 1e-4, "Z": 1e-4, "V": 1e-4, "S": 1e-4,
             "G2": 1e-4, "Y": 1e-4,          # C's and A's
             "X22": 1e-4}         # X22: A's
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
# paths G2, G2D, Y, YD: the last two dense families at full width and full
# depth on A's serving shape (8 slots, max_len 512, A's requests), int8 KV.
# G2: gemma2-2b, every layer's decode attention plain torch (its softcaps);
# Y: yi-6b, K5 at G 8, Dh 128; G2D, YD: paged (page 64, prefix sharing)
G2_ARCH, Y_ARCH, FAMILY_MAX_LEN = "gemma2-2b", "yi-6b", 512
Y_ATTEND_LENS = AR_ATTEND_LENS    # K4/K5 at Y's cache (max_len 512, as AR's)
# K1-K3 and the attend kernels, by their CUDA function names
HAND_KERNEL = r"\b(prologue_kernel|w8a8_kernel|swiglu_kernel|gemm_kernel|split_kernel|" \
              r"attend_kernel|move_pages|act_stats_kernel|quantize_kernel|" \
              r"dequantize_kernel|fma_kernel)\b"

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
    # the dense families: G2 (gemma2-2b: no K4/K5, its softcaps keep every
    # layer's decode attention plain) and Y (yi-6b) with int8 KV on slot
    # rows, G2D and YD paged
    "G2": (True, True, _C_KERNELS, {}),
    "G2D": (True, True, _C_KERNELS[:-1] + ("cache_scatter_pages",),
            dict(paged=True, page_size=PAGE)),
    "Y": (True, True, _A_KERNELS, {}),
    "YD": (True, True, _D_KERNELS, dict(paged=True, page_size=PAGE)),
    # the per-request prefill baseline: A with every request prefilled alone
    "AL": (True, True, _A_KERNELS, dict(batch_prefill=False)),
    # the mesh paths (``phase_mesh``): A over a 2x1 mesh, a 2x2 mesh (no K3
    # under TP), the 2x2 mesh paged, and the 2x2 mesh over two processes
    "X21": (True, True, _A_KERNELS, {}),
    "X22": (True, True, _F_KERNELS[:-1], {}),
    "X22D": (True, True, _D_KERNELS[:2] + _D_KERNELS[3:], dict(paged=True, page_size=PAGE)),
    "MH": (True, True, _F_KERNELS[:-1], dict(decode_steps=4)),
}
# data x model of each mesh path; its slots a replica
X_MESH = {"X21": (2, 1), "X22": (2, 2), "X22D": (2, 2), "MH": (2, 2)}
X_SPR = 4
MH_TIMEOUT = 900          # seconds a mesh child may take, its startup included
MH_LAUNCH_TIMEOUT = 600.0  # the fleet's deadline watchdog on every collective
H_PATHS = ("H", "HD", "HB", "HBW")
MOE_PATHS = ("DS", "DSD", "AR")
SSM_PATHS = ("M", "Z", "ZD")
EXTRAS_PATHS = ("V", "VD", "S", "SD")
ENCDEC_PATHS = ("S", "SD")
FAMILY_PATHS = ("G2", "G2D", "Y", "YD")
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
              "not_taken_ms", "not_taken_plain_ms", "not_taken_bound_ms", "library_note",
              "kernel_route", "ops_peak")


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
    """The predicated fp-dequant fallback at the guarded path's shapes: its
    four guarded projections at decode (QKV, wo, gate/up, w_down, x (8, K))
    and QKV at the prefill rows, bf16 in and out as path F runs it
    (``fallback_row``)."""
    import torch
    from repro_torch.kernels import fp_dequant as fd
    h_in = torch.randn((t["M"], eng.cfg.d_ff), generator=gen,
                       device=eng.device).to(torch.bfloat16)
    cases = (("qkv", t["qkv"], t["x"], True), ("wo", t["wo"], t["xo"], False),
             ("gate/up", t["gu"], t["x"], False), ("w_down", t["down"], h_in, False),
             ("qkv prefill", t["qkv"], x_pre, False))
    flag = fd.flag_buffer(eng.device)
    for label, rec, x, primary in cases:
        fallback_row(record, flush, gen, label, x, rec["q"], rec["scale"], flag, primary)


def fallback_row(record, flush, gen, label, x, q, sc, flag, primary, shape=None):
    """The fallback over x @ q on the route its operands take
    (``fd.route_for``: wgmma for bf16 x, fma for f32 x).  Not taken: y, the
    flag and the counters untouched.  Taken (the flag set before each
    call, its one-element fill inside the timed call): the flag cleared and
    one fallback counted, two calls equal bit for bit, and y against the
    plain version within one bf16 rounding of the f32 product, summed in
    another order (one bf16 ulp, 2^-7 relative, apart where the two sums
    round to neighbours).  Bound when taken: x, the int8 weight and the
    scales read once, y written once, against 2 M N K operations at the
    bf16 tensor cores' peak for bf16 x, the f32 units' for f32 x; not
    taken: the flag's word read and written.  No single PyTorch call
    dequantizes an int8 weight and multiplies: library null."""
    import torch
    from repro_torch.kernels import fp_dequant as fd
    from repro_torch.kernels import ref
    dev = x.device
    (M, K), N = x.shape, q.shape[1]
    route = fd.route_for(x, q)
    tel = torch.zeros(3, dtype=torch.int64, device=dev)
    y0 = torch.randn((M, N), generator=gen, device=dev).to(x.dtype)
    y = y0.clone()
    fd.fp_dequant_fallback_cuda(y, x, q, sc, flag, tel)
    need(torch.equal(y, y0) and not bool(flag.any()) and not bool(tel.any()),
         f"fallback {label}: the untaken branch wrote y, the flag or the counters")
    flag[0] = 1
    fd.fp_dequant_fallback_cuda(y, x, q, sc, flag, tel)
    need(not bool(flag.any()) and tel.tolist() == [1, 0, 0],
         f"fallback {label}: flag {flag.tolist()}, counters {tel.tolist()} after a "
         f"taken call")
    again = y0.clone()
    flag[0] = 1
    fd.fp_dequant_fallback_cuda(again, x, q, sc, flag)
    need(torch.equal(again.view(torch.uint8), y.view(torch.uint8)),
         f"fallback {label}: two taken calls differ")
    p = y0.clone()
    fd.fp_dequant_fallback_plain(p, x, q, sc, torch.ones_like(flag))
    want = ref.fp_dequant_matmul(x, q, sc, torch.float32)
    err = max_abs(y, p)
    tol = 2 ** -7 if y.dtype == torch.bfloat16 else 1e-5
    need(bool(((y.float() - p.float()).abs()
               <= tol * p.float().abs() + 1e-5 * float(want.abs().max())).all()),
         f"fallback {label}: differs from plain by {err}")

    def taken():
        flag[:1].fill_(1)
        fd.fp_dequant_fallback_cuda(y, x, q, sc, flag)

    def taken_plain():
        flag[:1].fill_(1)
        fd.fp_dequant_fallback_plain(y, x, q, sc, flag)

    rate = BF16_OPS if x.dtype == torch.bfloat16 else F32_OPS
    b_ms, b_by = bound_ms(M * K * x.element_size() + K * N + 4 * N + M * N * y.element_size()
                          + 8, 2 * M * N * K, rate)
    dt = str(x.dtype)[6:]
    record("fp_dequant", f"{label}: taken, {shape or f'x ({M}, {K}) {dt} @ q ({K}, {N}) int8'}"
           f" -> y {dt}; route {route}, plan {fd.plan(route, M, K, N, fd._sms(dev))}", err,
           median_ms(taken, flush=flush), median_ms(taken_plain, flush=flush), b_ms, b_by,
           None, primary, kernel_route=route,
           ops_peak="bf16 tensor cores" if rate == BF16_OPS else "f32",
           not_taken_ms=median_ms(lambda: fd.fp_dequant_fallback_cuda(y, x, q, sc, flag),
                                  flush=flush),
           not_taken_plain_ms=median_ms(
               lambda: fd.fp_dequant_fallback_plain(y, x, q, sc, flag), flush=flush),
           not_taken_bound_ms=bound_ms(8, 0, rate)[0],
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


def family_kernels(eng, path, detail):
    """Phase 2 at the shapes of a dense family's path (the extras paths and
    the last two families; rows tagged with ``path``), on the engine's own
    PDQ records (decoder layer 0's) at decode rows (8 slots) and prefill
    rows.  V (phi-3-vision-4.2b): K1 on QKV (3072 -> 3 x
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
    cross leaves as slot rows beside the pages).  G2 (gemma2-2b): K1 on
    QKV (2304 -> 2048 + 2 x 1024, with the norm) at decode and 8 x 256
    prefill rows, on wo's interval alone at 2048 (every G2 layer's decode
    runs it: no K5), and on gate/up; K2 on QKV, wo and w_down (9216 ->
    2304); K3 on gate/up (2304 -> 2 x 9216); no K4/K5 (none runs on its
    path); K6 a round's landing.  Y (yi-6b): the same at 4096 -> 4096 + 2 x
    512, wo 4096, gate/up 2 x 11008 (w_down's prologue over the
    11008-wide row), w_down 11008 -> 4096; K4/K5 at B 8, Hkv 4, G 8, Dh
    128, Sp 512 (the (8, 128) instance at its full G).  G2D, YD: K7 a
    round's landing and a decode gather.  Each against its plain version
    as A's rows are; library: ``torch._int_mm``, ``index_copy_``."""
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
    if cfg.attn_softcap is not None:       # wo's prologue is K1's in every layer
        k1.append((rows(M, wo["q"].shape[0]), None, (wo, None), "wo interval "))
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
    lens = {"V": V_ATTEND_LENS, "S": S_ATTEND_LENS, "Y": Y_ATTEND_LENS}.get(path)
    if lens is not None:
        Sp = eng.caches["blocks"][0]["k"].shape[3]
        attend_rows(dev, M, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                    ((lens, Sp, False),), gen, flush, record)
    torch.cuda.empty_cache()
    moves = landing_moves(eng.bundle, M, eng.max_len, gen, smap, eng.mem_len)
    time_movement(f"{path}: one round's landing, 4 of {M} slots", moves, kv.COUNT, flush,
                  record, False, "cache_scatter", index_copies(moves, lambda t, mv: t))
    del moves
    torch.cuda.empty_cache()


EXTRAS_MODELS = ((V_ARCH, V_MAX_LEN, ("V", "VD")), (S_ARCH, S_MAX_LEN, ("S", "SD")))
FAMILY_MODELS = ((G2_ARCH, FAMILY_MAX_LEN, ("G2", "G2D")), (Y_ARCH, FAMILY_MAX_LEN, ("Y", "YD")))


def phase_dense(detail, models):
    """Each (arch, max_len, (path, paged path)) of ``models`` at full width
    and full depth on seeded random bf16 weights: V, VD (phi-3-vision-4.2b)
    and S, SD (seamless-m4t-medium) served with their stub extras
    (``path_extras``), or G2, G2D (gemma2-2b) and Y, YD (yi-6b).  The first
    engine of a model quantizes them (PDQ-int8 in every 2-D projection,
    the encoder's and the cross blocks' included) and the bf16 tree is
    dropped; the paged path serves its records.  Each path: its kernel rows
    (``family_kernels``) and phase 3 (serve, census); the slot-row path
    also phase 4 (step, every row at the position of a 300-token prompt,
    behind V's patches) and phase 5 (parity); the paged path's streams must
    equal the slot-row path's (with no prefix hit where extras turn sharing
    off).  Returns (counts, serve runs, parity)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    counts, serve, parity = {}, {}, {}
    for arch, max_len, paths in models:
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
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, pattern {cfg.pattern}, window "
            f"{cfg.window}, softcaps {cfg.attn_softcap} / {cfg.logit_softcap}, frontend "
            f"{cfg.frontend}: random bf16 weights, "
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
            if quantize:                   # the paged path serves these records
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
                family_kernels(eng, path, detail)
            with timed(f"serve {path}"):
                counts[path], run = phase_serve(eng, path)
            if not eng.paged:
                with timed(f"step {path}"):
                    run["step"] = phase_step(eng, path, run["decode_step_median_ms"],
                                             pos=eng.patch_tokens + STEP_POS)
                with timed(f"parity {path}"):
                    parity[path], run["parity_pdq"] = phase_parity(eng, path)
            else:
                check_paged_run(path, run, serve[path[:-1]][0], ref=path[:-1])
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
        route = qz.dequantize_plan(M, N, ky.element_size(), True).route
        record("dequantize", f"q ({M}, {N}) per {'channel' if pc else 'row'} -> "
               f"{str(out_dtype)[6:]}{lib_note}; route {route}", max_abs(ky, py),
               median_ms(lambda: qz.dequantize_cuda(q, s, z, out_dtype), flush=flush),
               median_ms(lambda: qz.dequantize_plain(q, s, z, out_dtype), flush=flush),
               b_ms, b_by, lib_ms, primary, kernel_route=route,
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
    """(layers, layers that attend in plain torch at decode) of a config: a
    local layer over its ring, and every layer of a config with an
    attention softcap (gemma2), skip K4/K5, so wo's prologue is K1's."""
    if cfg.attn_softcap is not None:
        return cfg.n_layers, cfg.n_layers
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
    local layer (gemma3), and every layer of a softcapped config (gemma2),
    attends in plain torch and keeps the prologue (7 launches: K1 x 3, K2 x
    3, K3).  Every pool movement is one launch over
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
              "act_stats": "vector", "quantize": "vector", "dequantize": "vector",
              "fp_dequant": "wgmma"}


def check_routes(path, counts, routes=None):
    """Every K2 and K3 launch of a run took the wgmma route, every K4 and
    K5 launch the split route, every K8, K9 and K10 launch the vector
    route, every fallback launch the wgmma route (``routes``: another
    process's route counts, else this one's)."""
    from repro_torch.kernels import ops
    routes = ops.route_counts() if routes is None else routes
    log(f"{path}: K2-K5, K8-K10, fallback launches per route {routes}")
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
    # the per-request path feeds no prefill watchdog: AL times its calls
    pre = ([dt for dt, _ in eng.prefill_straggler.history] if eng.batch_prefill
           else list(eng.legacy_prefill_s))
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

    eager_entries = None
    if path == "A":             # DR's census: one eager step's entries
        from repro_torch.kernels import ops
        before, c0 = ops.count_state(), ops.counts()
        variants["eager"]()
        c1 = ops.counts()
        ops.set_counts(before)
        eager_entries = {k: c1[k]["entries"] - c0[k]["entries"] for k in c1
                         if c1[k]["entries"] != c0[k]["entries"]}
    for fn in variants.values():
        fn()
    walls = {k: [] for k in variants}
    order = list(variants)
    for i in range(STEP_PAIRS):
        for name in (order if i % 2 == 0 else order[::-1]):
            walls[name].append(window(variants[name]))
    out = dict(serve_step_ms=serve_step_ms)
    if eager_entries is not None:
        out["eager_entries"] = eager_entries
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


def check_twin(path, eng, run, ref_run, ref, reqs, tol):
    """``path``'s greedy streams against ``ref``'s run: the same, or, at a
    request's first divergent step, ``ref``'s top-2 logit margin for that
    token (``path``'s bundle, the prompt and the tokens before it in one
    unpadded prefill) below ``tol``.  Returns {uid: (step, margin)} of the
    divergences."""
    import numpy as np
    import torch
    out = {}
    for uid, toks in ref_run["streams"].items():
        got = run["streams"][uid]
        if got == toks:
            continue
        i = next(k for k, (a, b) in enumerate(zip(got, toks)) if a != b)
        seq = np.concatenate([reqs[uid].prompt, np.asarray(toks[:i], np.int32)])[None]
        logits, _ = eng.bundle.prefill(eng.params, {"tokens": torch.as_tensor(
            seq, device=eng.device)}, eng.bundle.init_caches(1, seq.shape[1] + 1))
        top2 = logits[0].float().topk(2).values
        margin = float(top2[0] - top2[1])
        log(f"serve {path}: request {uid} diverges from {ref}'s at step {i}, top-2 "
            f"margin {margin:.4g}")
        need(margin < tol, f"{path}: request {uid} diverges from {ref}'s at step "
             f"{i} with a top-2 margin of {margin} >= {tol}")
        out[uid] = (i, margin)
    log(f"serve {path}: streams equal {ref}'s but at {out or 'none'}")
    return out


def check_chunked_twin(eng, run, chunked_run):
    """HBW (unchunked, the capacity bucket) against HB (chunked), both with
    a bf16 KV cache: ``check_twin`` within H's LOGIT_TOL."""
    return check_twin("HBW", eng, run, chunked_run, "HB", h_requests(eng.cfg),
                      LOGIT_TOL["H"])


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


# ------------------------------------------------- paths AL, TR, TD, T, TQ
# TR: every registered config at its reduced size (float32, TF32 off), one
# loss + backward and one train step on the card against the same on the
# CPU; the loss within TR_LOSS_RTOL, every grad leaf within TR_TOL (rtol =
# atol), and AdamW's new params and moments from the same grads within
# TR_TOL, an int8 moment code within one.  The integrated step's params
# are held to ``adamw.first_step_bound`` of the grads each device took:
# Adam's first step normalizes each grad, g / (|g| + eps), so a grad
# difference far inside TR_TOL where |g| is near eps (1e-8) moves a param
# by a good part of lr (1e-3), and TR_TOL alone would not hold there.  On
# each device the step's params are bit-equal to AdamW of that device's
# grads (the step's wiring: batch, schedule, grads into the update)
TR_SEQ, TR_BATCH = 32, 2
TR_LOSS_RTOL = 1e-5
TR_TOL = 1e-4
# TD: the determinism probe, stablelm-1.6b at full width cut to 2 layers,
# T's batch; grads twice with the deterministic algorithms off and twice on
TD_LAYERS = 2
# T / TQ: stablelm-1.6b uncut, bf16, init(0), the launcher's lr and the
# reference's default warmup_cosine, remat "full", loss_chunk 512
T_ARCH = "stablelm-1.6b"
# (12 steps since the sequence-parallel prefill's SP joined the run: 20 before)
T_BATCH, T_SEQ, T_STEPS, T_LR = 8, 1024, 12, 1e-3
TQ_CKPT_EVERY, TQ_FAIL_AT = 6, 9
TRAIN_CHILD_TIMEOUT = 900     # seconds
CUBLAS_CONFIG = ":4096:8"     # the deterministic cuBLAS workspace
# TM / TMF: the sharded train step over a 2x2 mesh of four processes on
# cuda:0 (``--train-mesh-child``)
TM_MESH = (2, 2)
TM_SEQ, TM_BATCH, TM_STEPS = 32, 4, 2
TM_OUTLIERS = 1e-3            # share of param elements past TR_TOL
TM_CKPT_ARCH = "stablelm-1.6b"
TMF_SEQ, TMF_BATCH, TMF_STEPS = 1024, 4, 3   # ~12.5 s a step: the run's time limit
TMF_LOSS_RTOL = 1e-3          # step 1: the same batch and params, sums in another order
TM_TIMEOUT = 700              # seconds the four children may take, startup included
# SP: the sequence-parallel prefill over a 1x4 mesh of the same four children
SP_MESH = (1, 4)
SP_ROWS, SP_SEQ, SP_SEED = 2, 4096, 7
# DR: each cell (arch, shape - a SHAPES name or ShapeSpec fields -, variant,
# mesh or None for the 16x16 production mesh), and the child processes that
# trace them, the longest alone
DR_CELLS = {
    "T": (T_ARCH, ("T", "train", T_SEQ, T_BATCH), "baseline", (1, 1)),
    "A": ("stablelm-1.6b", ("A", "decode", 512, 8), "opt", (1, 1)),
    "TMF": (T_ARCH, ("TMF", "train", TMF_SEQ, TMF_BATCH), "baseline", TM_MESH),
    "yi-6b train_4k": ("yi-6b", "train_4k", "baseline", None),
    "mamba2-2.7b prefill_32k": ("mamba2-2.7b", "prefill_32k", "baseline", None),
    "yi-6b decode_32k": ("yi-6b", "decode_32k", "baseline", None),
    # SP's cell as SP runs it: PDQ-int8 weights, the int8 KV cache
    "SP": (T_ARCH, ("SP", "prefill", SP_SEQ, SP_ROWS), "opt", SP_MESH,
           dict(pdq=True, quant_kv="dynamic")),
}
DR_GROUPS = (("yi-6b train_4k",), ("mamba2-2.7b prefill_32k", "yi-6b decode_32k"),
             ("T", "A", "TMF", "SP"))
DR_TIMEOUT = 1000             # seconds the children may take from their start


# ------------------------------------------------------------------ mesh paths
def x_mesh(path, processes=1):
    """``path``'s ('data', 'model') mesh, every entry cuda:0."""
    from repro_torch.launch.mesh import make_serve_mesh
    D, T = X_MESH[path]
    return make_serve_mesh(D, T, ["cuda:0"] * (D * T), processes=processes)


def x_config(path, **kw):
    """A's serving config over ``path``'s mesh, X_SPR slots a replica."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(arch=T_ARCH, reduced=False, slots_per_replica=X_SPR, max_len=512,
                       int8_kv=True, quantize_weights=True, device="cuda",
                       mesh=x_mesh(path, kw.pop("processes", 1)),
                       **dict(PATHS[path][3], **kw))


def split_weight_bytes(eng):
    """{device: bytes} of a mesh engine's split weight storage (replicas
    that share a placement count it once)."""
    seen, per = set(), {}
    for rep in eng.replicas:
        for d, b in rep.row.weight_bytes(seen).items():
            per[d] = per.get(d, 0) + b
    return per


def mesh_layout(eng):
    """A mesh engine's split weights a device and streams a replica."""
    return (f"split weights a device {split_weight_bytes(eng)} bytes; streams a replica "
            f"{[rep.row.stream_count() for rep in eng.replicas]}")


def tp_k2_per_layer(eng, T):
    """K2 launches a layer and model step under T column shards: QKV, wo,
    gate/up and w_down each launch once a shard where their columns (a
    grouped record's 128-column blocks) divide over T, else once (A's
    records all divide: 4 T)."""
    p0 = eng.params["blocks"][0]
    recs = (p0["attn"]["wq"]["group"], p0["attn"]["wo"], p0["ffn"]["w_gate"]["group"],
            p0["ffn"]["w_down"])
    cols = [r["q"].shape[1] // 128 if "segs" in r else r["q"].shape[1] for r in recs]
    return sum(T if c % T == 0 else 1 for c in cols)


def mesh_census(path, cfg, st, replicas, k2_layer):
    """Op entries of ``replicas`` replicas in a serving run of a mesh path
    (every replica runs every launch of the run, as the reference's SPMD
    program does).  A replica runs A's program on its slots; under TP (T
    > 1 column shards) each PDQ projection's K2 runs once a shard
    (``k2_layer`` a layer, ``tp_k2_per_layer``) and the MLP is unfused:
    per layer K1 for QKV, gate/up and w_down (and wo at prefill; at decode
    K5 runs wo's prologue), no K3 - 4 + 4T launches a decode step with K5
    at A's shapes.  Returns (entries, K1 launches per mode)."""
    T = X_MESH[path][1]
    n = cfg.n_layers
    rounds = st["prefill_batches"]
    pre = rounds + st["chunk_batches"]
    dec = st["decode_steps"] * block_of(path)
    want = dict(pdq_prologue=0, w8a8_matmul=0, w8a8_swiglu_matmul=0, decode_attend_i8kv=0,
                decode_attend_i8kv_fused=n * dec, cache_scatter=0, cache_scatter_pages=0,
                act_stats=0, quantize=0, dequantize=0, fp_dequant=0)
    modes = dict.fromkeys(("prologue", "norm", "interval", "norm+interval"), 0)
    modes["norm+interval"] = 2 * n * (pre + dec)
    if T > 1:
        want.update(pdq_prologue=n * (4 * pre + 3 * dec), w8a8_matmul=k2_layer * n * (pre + dec))
        modes["interval"] = n * pre + n * (pre + dec)
    else:
        want.update(pdq_prologue=n * (3 * pre + 2 * dec), w8a8_matmul=3 * n * (pre + dec),
                    w8a8_swiglu_matmul=n * (pre + dec))
        modes["interval"] = n * pre
    if is_paged(path):
        want["cache_scatter_pages"] = rounds + 2 * st["decode_steps"]
    else:
        want["cache_scatter"] = rounds
    return ({k: replicas * v for k, v in want.items()},
            {k: replicas * v for k, v in modes.items()})


def check_mesh_counts(path, cfg, st, counts, modes, replicas, k2_layer, routes=None):
    """A mesh run's counts: launches == entries, the exact census, K1's
    modes, every K2/K5 on its main route (``routes``: a child's), the
    path's kernels and no other."""
    check_routes(path, counts, routes)
    for name, c in counts.items():
        need(c["launches"] == c["entries"],
             f"{path}: {name}: {c['entries']} op entries but {c['launches']} launches")
        need((c["launches"] > 0) == (name in PATHS[path][2]),
             f"{path}: {name} launched {c['launches']} times")
    want, want_modes = mesh_census(path, cfg, st, replicas, k2_layer)
    got = {k: c["entries"] for k, c in counts.items()}
    need(got == want, f"{path}: op entries {got}, census {want}")
    need(modes == want_modes, f"{path}: K1 launches per mode {modes}, census {want_modes}")


def tp_kernels(eng, detail):
    """K2 over each TP column block of A's records at 8 and 2048 rows (the
    2x2 mesh's shards: QKV 6144 -> 2 x 3072, wo 2048 -> 2 x 1024, gate/up
    11264 -> 2 x 5632, w_down 2048 -> 2 x 1024; per-128-column clamps cut
    to the shard's blocks): the wgmma route from the shifted base, within
    plain's bound and equal to the unsplit launch's columns bit for bit;
    then the fallback over one shard's columns of QKV and w_down, taken and
    not (``fallback_row``'s checks).  Rows tagged "X"."""
    import torch
    from repro_torch.kernels import fp_dequant as fd
    from repro_torch.kernels import w8a8_matmul as mm
    T = X_MESH["X22"][1]
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(4321)
    dev = eng.device
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    record = recorder({}, detail, path="X")
    p0 = eng.params["blocks"][0]
    recs = (("qkv", p0["attn"]["wq"]["group"], "d", True), ("wo", p0["attn"]["wo"], "d", False),
            ("gate/up", p0["ffn"]["w_gate"]["group"], "d", True),
            ("w_down", p0["ffn"]["w_down"], "ff", False))
    kw = dict(out_dtype=torch.bfloat16)
    for M in E_ROWS:
        xs = {"d": torch.randn((M, eng.cfg.d_model), generator=gen, device=dev),
              "ff": torch.randn((M, eng.cfg.d_ff), generator=gen, device=dev)}
        for label, rec, width, per_block in recs:
            x = rows_for(xs[width].to(torch.bfloat16), rec, gen)
            (x_q, w_q, s_x, _, s_w, _), (lo, hi) = epi_operands(rec, x, per_block)
            N, E = w_q.shape[1], lo.shape[1]
            full = mm.w8a8_matmul_cuda(x_q, w_q, s_x, None, s_w, None, None, None, lo, hi, **kw)
            n, b = N // T, (E // T if per_block else E)
            for j in range(T):
                c = slice(j * n, (j + 1) * n)
                g = slice(j * b, (j + 1) * b) if per_block else slice(None)
                args = (x_q, w_q[:, c], s_x, None, s_w[:, c].contiguous(), None, None, None,
                        lo[:, g].contiguous(), hi[:, g].contiguous())
                need(mm.route_for(x_q, args[1]) == "wgmma",
                     f"K2 {label} shard {j}: the generic route")
                yk = mm.w8a8_matmul_cuda(*args, **kw)
                yp = mm.w8a8_matmul_plain(*args, **kw)
                err = max_abs(yk, yp)
                need(err <= 1e-6 * float(yp.float().abs().max()) + 1e-6,
                     f"K2 {label} shard {j} ({M} rows) differs from plain by {err}")
                need(torch.equal(yk, full[:, c]),
                     f"K2 {label} shard {j} ({M} rows): not the unsplit launch's columns")
                ea = args[8].shape[1]
                b_ms, b_by = bound_ms(M * x_q.shape[1] + x_q.shape[1] * n + M * n * 2 + n * 4
                                      + M * (4 + 8 * ea), 2 * M * x_q.shape[1] * n, INT8_OPS)
                lib_ms, _, note = library_int_mm(x_q, args[1], flush)
                record("w8a8_matmul", f"TP shard {j} of {T}, {label}: x ({M}, {x_q.shape[1]}) "
                       f"@ w[:, {c.start}:{c.stop}] (base + {c.start * x_q.shape[1]} B), "
                       f"epilogue ({M}, {ea}); plan "
                       f"{mm.wgmma_plan(M, x_q.shape[1], n, False, mm._sms(dev))}"
                       f"{'; ' + note if note else ''}", err,
                       median_ms(lambda: mm.w8a8_matmul_cuda(*args, **kw), flush=flush),
                       median_ms(lambda: mm.w8a8_matmul_plain(*args, **kw), flush=flush),
                       b_ms, b_by, lib_ms, False)
    # the fallback over shard 1's columns (a shifted K-major base), decode rows
    flag = fd.flag_buffer(dev)
    for label, rec, width, _ in (recs[0], recs[3]):
        x = rows_for(torch.randn((8, eng.cfg.d_model if width == "d" else eng.cfg.d_ff),
                                 generator=gen, device=dev).to(torch.bfloat16), rec, gen)
        (M, K), N = x.shape, rec["q"].shape[1]
        c = slice(N // T, N)
        fallback_row(record, flush, gen, f"TP shard 1 of {T}, {label}", x, rec["q"][:, c],
                     rec["scale"][c].contiguous(), flag, False,
                     shape=f"x ({M}, {K}) bf16 @ q[:, {c.start}:{N}] int8")


def mesh_serve(eng, path, ref_run):
    """Phase 3 on a mesh path's engine: A's requests, the counts zeroed just
    before and read just after, ``check_mesh_counts`` over every replica,
    each replica's graph replayed once a decode dispatch, every request
    complete; streams against A's (``check_twin`` within A's LOGIT_TOL:
    the replicas' batches of 4 rows and, under TP, the unfused MLP may move
    a token whose top-2 margin is inside it)."""
    import torch
    from repro_torch.kernels import ops
    reqs = make_requests(eng.cfg)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    results = run_batch(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, modes, st = ops.counts(), ops.prologue_modes(), eng.stats
    log(f"serve {path}: {len(reqs)} requests in {wall:.2f} s; counts {counts}; K1 modes "
        f"{modes}; stats {json.dumps(st)}")
    D, T = X_MESH[path]
    k2_layer = tp_k2_per_layer(eng, T)
    check_mesh_counts(path, eng.cfg, st, counts, modes, D, k2_layer)
    need(st["replica_graph_replays"] == [st["decode_steps"]] * D,
         f"{path}: graph replays a replica {st['replica_graph_replays']}, "
         f"{st['decode_steps']} decode dispatches")
    need(st["completed"] == len(reqs) and st["failed"] == 0, f"{path}: {st}")
    need(min(st["replica_admits"]) >= 1 and st["replica_occupancy"] == [0] * D,
         f"{path}: replica admits {st['replica_admits']}, occupancy "
         f"{st['replica_occupancy']}")
    for i, r in enumerate(reqs):
        toks, fin, err = results[i]
        need(fin == "complete" and err is None and len(toks) == r.max_new
             and all(0 <= t < eng.cfg.vocab for t in toks),
             f"{path}: request {i}: {len(toks)} tokens, finish {fin}, error {err}")
    health = pdq_health(st)
    need(st["pdq_clip_total"] > 0 and st["pdq_fallbacks"] == 0, f"{path}: health {health}")
    dec = [dt for dt, _ in eng.straggler.history]
    pre = [dt for dt, _ in eng.prefill_straggler.history]
    tps = st["decode_tokens"] / sum(dec)
    run = dict(wall_s=wall, prefill_s=sum(pre), prefill_s_per_round=pre, k2_per_layer=k2_layer,
               prologue_modes=modes, decode_step_median_ms=sorted(dec)[len(dec) // 2] * 1e3,
               decode_tokens_per_s=tps, decode_ms_per_token=1e3 / tps, stats=st, pdq=health,
               graph_capture_s=[rep.graph.capture_s for rep in eng.replicas],
               streams={i: res[0] for i, res in results.items()})
    run["divergences"] = check_twin(path, eng, run, ref_run, "A", reqs, LOGIT_TOL["A"])
    log(f"serve {path}: prefill {sum(pre):.3f} s in {len(pre)} rounds {pre}; decode "
        f"dispatch median {run['decode_step_median_ms']:.2f} ms, {tps:.1f} tokens/s; pdq "
        f"{json.dumps(health)}; {len(run['divergences'])} streams part from A's inside "
        f"the margin")
    return counts, run


def mesh_step(a_eng, x_eng, pos=STEP_POS):
    """X22's decode step against A's: one replayed step of the full pool
    at position ``pos`` - A's graph over its 8 rows, X22's two replicas'
    graphs over 4 rows each - in STEP_PAIRS alternated pairs of
    STEP_RUNS-step windows (A first, then X22 first, ...): wall ms a step
    (each replay ends in its output's copy to the host); then
    torch.profiler over one window of each: device busy ms and kernels a
    step, and the idle share 1 - busy / wall."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    B = a_eng.slots
    rows = (np.zeros(B, np.int32), np.full(B, pos, np.int32), np.arange(B, dtype=np.int32),
            np.zeros(B, np.int32), np.ones(B, np.int32))

    def a_step():
        a_eng._graph.packed(*rows)

    def x_step():
        for rep in x_eng.replicas:
            rep.graph.packed(*(a[rep.rows] for a in rows))

    steps = {"A": a_step, "X22": x_step}
    walls = {k: [] for k in steps}
    for pair in range(STEP_PAIRS):
        order = ("A", "X22") if pair % 2 == 0 else ("X22", "A")
        for k in order:
            steps[k]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEP_RUNS):
                steps[k]()
            walls[k].append((time.perf_counter() - t0) / STEP_RUNS * 1e3)
    out = {}
    for k, fn in steps.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_RUNS):
                fn()
            torch.cuda.synchronize()
        rows_ = device_rows(prof, STEP_RUNS)
        busy = sum(r[0] for r in rows_) if rows_ else None
        wall = sorted(walls[k])[len(walls[k]) // 2]
        out[k] = dict(wall_ms=walls[k], wall_ms_median=wall, busy_ms=busy,
                      kernels=sum(r[2] for r in rows_) if rows_ else None,
                      idle_share=None if busy is None else 1 - busy / wall)
        log(f"step {k} (mesh comparison, position {pos}): replayed wall ms per pair "
            f"{[round(w, 3) for w in walls[k]]}, median {wall:.3f}; device busy "
            f"{'null' if busy is None else f'{busy:.3f}'} ms, "
            f"{out[k]['kernels']} kernels a step")
    return out


def mh_child(rank: int, coordinator: str, out: str) -> int:
    """One process of MH (``--mesh-child``): join the gloo group, build X22's
    engine over the 2-process mesh (this process hosts replica ``rank``),
    and serve A's requests from process 0 (``serve_worker`` on process 1),
    with the kernels' counts zeroed just before; write streams, stats,
    host stats, counts and the protocol's host time to ``out``.<rank>."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models import build_model
    from repro_torch.serve import build_engine
    init_distributed(coordinator, 2, rank, timeout=MH_TIMEOUT)
    cfg = get_config(T_ARCH)
    params = build_model(cfg, "cuda").init(0)
    t0 = time.perf_counter()
    eng = build_engine(x_config("MH", processes=2, multihost=True,
                                launch_timeout=MH_LAUNCH_TIMEOUT), cfg=cfg, params=params)
    build_s = time.perf_counter() - t0
    layout = mesh_layout(eng)
    # the host's seconds in the protocol's collectives: the command header
    # and payloads (_broadcast), the token gather (_collect, which also
    # waits for the peer's launch on the shared card)
    proto = {"_broadcast": 0.0, "_collect": 0.0}
    for name in proto:
        fn = getattr(eng, name)

        def timed_call(*a, _fn=fn, _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                proto[_name] += time.perf_counter() - t
        setattr(eng, name, timed_call)
    torch.cuda.synchronize()
    ops.reset_counts()
    res = dict(rank=rank, build_s=build_s, layout=layout)
    t0 = time.perf_counter()
    if rank == 0:
        reqs = make_requests(cfg)
        eng.run(reqs)
        eng.stop_workers()
        res.update(streams={i: list(r.generated) for i, r in enumerate(reqs)},
                   done=[r.done and r.error is None for r in reqs],
                   host_stats=eng.host_stats(), commands=eng._seq - 1,
                   decode_s=sum(dt for dt, _ in eng.straggler.history),
                   prefill_s_per_round=[dt for dt, _ in eng.prefill_straggler.history])
    else:
        eng.serve_worker()
        res["commands"] = eng._done_seq
    torch.cuda.synchronize()
    res.update(wall_s=time.perf_counter() - t0, stats=eng.stats, counts=ops.counts(),
               routes=ops.route_counts(), modes=ops.prologue_modes(),
               broadcast_s=proto["_broadcast"], gather_s=proto["_collect"])
    Path(f"{out}.{rank}").write_text(json.dumps(res, default=str))
    dist.destroy_process_group()
    return 0


# stats of a serving run that do not depend on the dispatch's N (MH decodes
# 4 steps a dispatch, X22 one): a block runs a row past its budget frozen,
# so the dispatches, the health counters (every row counts every step) and
# the wall-clock straggler flags are N's own
MH_SAME_STATS = ("prefill_batches", "chunk_batches", "prefill_requests", "chunked_requests",
                 "prefill_tokens", "prefill_padded_tokens", "decode_tokens", "completed",
                 "failed", "cancelled", "deadline_expired", "shed", "replica_admits",
                 "replica_occupancy")


def phase_mh(cfg, x22_run):
    """MH: X22's mesh served by two child processes on the card (its
    compute mode must be Default: printed first); each child's stderr goes
    to this process's, a child that fails or outlives MH_TIMEOUT fails the
    phase.  Tokens identical to X22's, the N-independent stats too
    (MH_SAME_STATS), both processes admitting and drained, each child's
    census for its one replica, every dispatch a replay of its graph."""
    import os
    from repro_torch.launch.mesh import pick_coordinator
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    log(f"MH: compute mode {mode}")
    need(mode.strip() == "Default", f"MH: two processes cannot share the card in compute "
         f"mode {mode}")
    out = OUT_DIR / "chip_smoke_mh.json"
    for r in (0, 1):
        Path(f"{out}.{r}").unlink(missing_ok=True)
    coord = pick_coordinator(None)
    sys.stdout.flush()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-child",
                               str(r), coord, str(out)], env=dict(os.environ))
             for r in (0, 1)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            need(all(p.poll() in (None, 0) for p in procs),
                 f"MH: a child exited {[p.poll() for p in procs]}")
            need(time.perf_counter() - t0 < MH_TIMEOUT,
                 f"MH: the children outlived {MH_TIMEOUT} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    need([p.returncode for p in procs] == [0, 0],
         f"MH: the children exited {[p.returncode for p in procs]}")
    res = [json.loads(Path(f"{out}.{r}").read_text()) for r in (0, 1)]
    c0 = res[0]
    st = c0["stats"]
    need(all(c0["done"]), f"MH: requests not done: {c0['done']}")
    got = {int(k): v for k, v in c0["streams"].items()}
    need(got == x22_run["streams"], f"MH: streams {got} differ from X22's "
         f"{x22_run['streams']}")
    for k in MH_SAME_STATS:
        need(st[k] == x22_run["stats"][k], f"MH: stat {k} {st[k]}, X22's "
             f"{x22_run['stats'][k]}")
    hs = c0["host_stats"]
    need(sorted(hs) == ["0", "1"] and all(h["admits"] >= 1 and h["occupied"] == 0
                                          for h in hs.values()), f"MH: host stats {hs}")
    for r, c in enumerate(res):
        need(c["stats"]["replica_graph_replays"][r] == st["decode_steps"],
             f"MH: process {r}: replays {c['stats']['replica_graph_replays']}, "
             f"{st['decode_steps']} dispatches")
        check_mesh_counts("MH", cfg, st, c["counts"], c["modes"], 1, x22_run["k2_per_layer"],
                          c["routes"])
    for c in res:
        log(f"model MH: process {c['rank']}: {c['layout']}")
    tps = st["decode_tokens"] / c0["decode_s"]
    run = dict(streams=got, stats=st, host_stats=hs, wall_s=c0["wall_s"],
               decode_tokens_per_s=tps, prefill_s_per_round=c0["prefill_s_per_round"],
               commands=c0["commands"], broadcast_s=c0["broadcast_s"], gather_s=c0["gather_s"],
               rendezvous_us_per_command=c0["broadcast_s"] / c0["commands"] * 1e6,
               child_build_s=[c["build_s"] for c in res])
    log(f"serve MH: streams and {len(MH_SAME_STATS)} stats equal X22's; host stats {hs}; "
        f"{c0['commands']} commands: rendezvous wait in the header and payload collectives "
        f"{c0['broadcast_s']:.4f} s ({run['rendezvous_us_per_command']:.1f} us a command; "
        f"the header waits for the peer's previous launch, so this is not protocol cost), "
        f"token gathers "
        f"{c0['gather_s']:.4f} s (the peer's launch included); decode {tps:.1f} tokens/s; "
        f"wall {c0['wall_s']:.2f} s; children built their engines in {run['child_build_s']} s")
    return {f"MH.{r}": c["counts"] for r, c in enumerate(res)}, run


def phase_mesh(cfg, params, a_run, detail):
    """Paths X21, X22, X22D and MH (see the module note, phase 9).  Returns
    (counts by path, runs by path, X22's parity, X22's step)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, build_engine
    counts, runs = {}, {}
    for path in ("X21", "X22", "X22D"):
        t0 = time.perf_counter()
        eng = build_engine(x_config(path), cfg=cfg, params=params)
        torch.cuda.synchronize()
        log(f"model {path}: {cfg.name} on a {X_MESH[path][0]}x{X_MESH[path][1]} mesh of "
            f"cuda:0, {X_SPR} slots a replica, "
            f"{'paged' if eng.paged else 'slot rows'}, built in "
            f"{time.perf_counter() - t0:.1f} s, decode graphs captured in "
            f"{[round(rep.graph.capture_s, 2) for rep in eng.replicas]} s")
        log(f"model {path}: {mesh_layout(eng)}")
        if path == "X22":
            with timed("kernels X"):
                tp_kernels(eng, detail)
        with timed(f"serve {path}"):
            counts[path], runs[path] = mesh_serve(eng, path, a_run)
        if path == "X22":
            with timed("parity X22"), ops.tp_shard(eng.replicas[0].row):
                parity, runs[path]["parity_pdq"] = phase_parity(eng, "X22")
            log(f"serve X22: PDQ health {runs[path]['pdq']} against A's {a_run['pdq']}")
            a_eng = build_engine(ServeConfig(arch=T_ARCH, reduced=False, slots=8,
                                             max_len=512, int8_kv=True,
                                             quantize_weights=True, device="cuda"),
                                 cfg=cfg, params=params)
            with timed("step X22"):
                runs[path]["step"] = mesh_step(a_eng, eng)
            del a_eng
        if path == "X22D":
            check_streams(path, runs[path], runs["X22"], "X22")
        del eng
        torch.cuda.empty_cache()
    with timed("serve MH"):
        mh_counts, runs["MH"] = phase_mh(cfg, runs["X22"])
    counts.update(mh_counts)
    return counts, runs, parity


def phase_legacy(cfg, ref_run):
    """Path AL: A's weights, slots, max_len and requests through the
    per-request prefill baseline (``batch_prefill=False``): each request
    prefills alone at its exact length and lands with one K6 launch.
    ``phase_serve`` holds its exact census (K1-K3 per request as one of A's
    rounds, one K6 a request, decode as A's), every dispatch a replay and
    the wgmma route at every ragged prompt length; then its streams
    against A's first run (``check_twin`` within A's LOGIT_TOL) and
    prefill_padded_tokens == prefill_tokens.  Each ``_submit_one`` call is
    timed on the host clock (it ends in the token's device-to-host copy)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, build_engine
    params = build_model(cfg, "cuda").init(0)
    eng = build_engine(ServeConfig(arch=T_ARCH, slots=8, max_len=512, int8_kv=True,
                                   quantize_weights=True, device="cuda",
                                   batch_prefill=False), cfg=cfg, params=params)
    eng.legacy_prefill_s = []
    submit = eng._submit_one

    def timed_submit(req, extras):
        t0 = time.perf_counter()
        try:
            return submit(req, extras)
        finally:
            eng.legacy_prefill_s.append(time.perf_counter() - t0)
    eng._submit_one = timed_submit
    counts, run = phase_serve(eng, "AL")
    st = run["stats"]
    need(st["prefill_padded_tokens"] == st["prefill_tokens"]
         and st["prefill_batches"] == st["prefill_requests"] == 8,
         f"AL: prefill stats {st}")
    run["divergences"] = check_twin("AL", eng, run, ref_run, "A", make_requests(cfg),
                                    LOGIT_TOL["A"])
    del eng, params
    torch.cuda.empty_cache()
    return counts, run


def _tree_close(a, b, rtol, atol):
    """(worst |a - b| / (atol + rtol |b|), its leaf) over two trees."""
    from repro_torch import tree as ttree
    worst, where = 0.0, None
    for (path, x), y in zip(ttree.leaves_with_path(a), ttree.leaves(b)):
        x, y = x.detach().double().cpu(), y.detach().double().cpu()
        r = float(((x - y).abs() / (atol + rtol * y.abs())).max()) if x.numel() else 0.0
        if r > worst:
            worst, where = r, ttree.path_str(path)
    return worst, where


def _step_gap(new_a, new_b, bound, g_a, g_b):
    """(worst |new_a - new_b| / bound, its leaf, the readings at that
    element: both grads, the grad and param differences, the bound)."""
    from repro_torch import tree as ttree
    worst, at = 0.0, None
    for (path, x), y, bd, ga, gb in zip(ttree.leaves_with_path(new_a), ttree.leaves(new_b),
                                        ttree.leaves(bound), ttree.leaves(g_a),
                                        ttree.leaves(g_b)):
        if not x.numel():
            continue
        d = (x.detach().double().cpu() - y.detach().double().cpu()).abs()
        r = d / bd
        i = int(r.argmax())
        if float(r.reshape(-1)[i]) > worst:
            ga_i = float(ga.detach().double().cpu().reshape(-1)[i])
            gb_i = float(gb.detach().double().cpu().reshape(-1)[i])
            worst = float(r.reshape(-1)[i])
            at = dict(leaf=ttree.path_str(path), g_a=ga_i, g_b=gb_i, dg=abs(ga_i - gb_i),
                      dp=float(d.reshape(-1)[i]), bound=float(bd.reshape(-1)[i]))
    return worst, at


def _code_diff(a, b):
    """(codes apart, of how many, largest distance) of two int8 trees."""
    from repro_torch import tree as ttree
    n = tot = far = 0
    for x, y in zip(ttree.leaves(a), ttree.leaves(b)):
        d = (x.cpu().int() - y.cpu().int()).abs()
        n += int((d > 0).sum())
        tot += d.numel()
        far = max(far, int(d.max()) if d.numel() else 0)
    return n, tot, far


@contextlib.contextmanager
def router_log(out):
    """Every MoE router decision (``models.moe.route``'s ids) into ``out``."""
    from repro_torch.models import moe
    orig = moe.route

    def traced(x, wr, cfg, token_mask=None):
        gates, ids, aux = orig(x, wr, cfg, token_mask)
        out.append(ids.detach().cpu())
        return gates, ids, aux
    moe.route = traced
    try:
        yield
    finally:
        moe.route = orig


def tr_batch(cfg):
    """TR's numpy batch: ``SyntheticLM`` step 0, with seeded stub patches
    or frames where the config needs them."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    d = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TR_SEQ, batch=TR_BATCH)).batch_at(0)
    rng = np.random.default_rng(1)
    if cfg.frontend == "vision":
        d["patches"] = (0.02 * rng.standard_normal(
            (TR_BATCH, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        d["frames"] = (0.02 * rng.standard_normal((TR_BATCH, 8, cfg.d_model))
                       ).astype(np.float32)
    return d


def phase_train_parity():
    """Path TR: for every registered config at its reduced size, one
    ``train_loss`` + backward and one ``build_train_step`` step (f32
    moments, then int8; lr scale 1) on the card against the CPU, from the
    same seeded weights and batch; the step's params are held to
    ``adamw.first_step_bound`` of the two devices' grads.  A router decision that differs between
    the two runs is reported and that config's numbers are not bound (as
    phase 5 does after an expert flip).  The card's grads are also taken
    twice with the deterministic algorithms off (the leaves that differ are
    reported) and twice under the trainer's ``deterministic()`` (bit-equal,
    gated)."""
    import torch
    from repro_torch import tree as ttree
    from repro_torch.configs import ALL_ARCHS, reduced_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw, schedule
    from repro_torch.train.train_step import build_train_step, loss_and_grads, to_device
    from repro_torch.train.trainer import deterministic
    out = {}
    for arch in ALL_ARCHS:
        cfg = reduced_config(arch)
        bc, bg = build_model(cfg, "cpu"), build_model(cfg, "cuda")
        batch = tr_batch(cfg)
        pc = bc.init(0)
        pg = ttree.tree_map(lambda t: t.to("cuda"), pc)
        rc, rg = [], []
        with router_log(rc):
            lc, _, gc = loss_and_grads(bc, pc, to_device(batch, "cpu"))
        with router_log(rg):
            lg, _, gg = loss_and_grads(bg, pg, to_device(batch, "cuda"))
        flips = sum(int((a != b).any()) for a, b in zip(rc, rg))
        rel = abs(float(lg) - float(lc)) / abs(float(lc))
        g_worst, g_leaf = _tree_close(gg, gc, TR_TOL, TR_TOL)
        row = dict(loss_cpu=float(lc), loss_card=float(lg), loss_rel=rel,
                   grad_worst=g_worst, grad_leaf=g_leaf, router_calls=len(rc),
                   expert_flips=flips)
        # determinism: two more card runs each way
        runs = {}
        for det in (False, True):
            with deterministic("cuda") if det else contextlib.nullcontext():
                runs[det] = [loss_and_grads(bg, pg, to_device(batch, "cuda"))[2]
                             for _ in range(2)]
        row["nondeterministic_leaves"] = [
            ttree.path_str(p) for (p, a), b in zip(ttree.leaves_with_path(runs[False][0]),
                                                   ttree.leaves(runs[False][1]))
            if not torch.equal(a, b)]
        row["deterministic_equal"] = all(torch.equal(a, b) for a, b in zip(
            ttree.leaves(runs[True][0]), ttree.leaves(runs[True][1])))
        need(row["deterministic_equal"], f"TR {arch}: deterministic grads differ")
        gg_cpu = ttree.tree_map(lambda t: t.cpu(), gg)
        # the grads each device's step takes: under deterministic() a
        # second run repeats them bit for bit
        gdet = {"cuda": runs[True][0]}
        with deterministic("cpu"):
            gdet["cpu"] = loss_and_grads(bc, pc, to_device(batch, "cpu"))[2]
        for quant in (False, True):
            opt = AdamWConfig(lr=1e-3, quant_state=quant)
            key = "int8" if quant else "f32"
            # the integrated step on each device: bit-equal to AdamW of the
            # device's own grads, and the two devices' params within
            # first_step_bound of those grads
            new, wired = {}, {}
            for dev, b, p in (("cpu", bc, pc), ("cuda", bg, pg)):
                step = build_train_step(b, opt, lr_schedule=schedule.constant)
                with deterministic(dev):
                    new[dev] = step({"params": p, "opt": adamw.init(p, opt)}, batch)
                ref_p, _ = adamw.apply_updates(p, gdet[dev], adamw.init(p, opt), opt,
                                               new[dev][1]["lr_scale"])
                wired[dev] = all(torch.equal(x, y) for x, y in zip(
                    ttree.leaves(new[dev][0]["params"]), ttree.leaves(ref_p)))
            row[f"step_{key}_wired"] = wired
            row[f"step_{key}_loss_rel"] = abs(float(new["cuda"][1]["loss"])
                                              - float(new["cpu"][1]["loss"])) / abs(float(lc))
            row[f"step_{key}_param_worst"], row[f"step_{key}_param_leaf"] = _tree_close(
                new["cuda"][0]["params"], new["cpu"][0]["params"], TR_TOL, TR_TOL)
            bound = adamw.first_step_bound(pc, gdet["cuda"], gdet["cpu"], opt,
                                           new["cuda"][1]["lr_scale"])
            row[f"step_{key}_bound_worst"], row[f"step_{key}_bound_at"] = _step_gap(
                new["cuda"][0]["params"], new["cpu"][0]["params"], bound,
                gdet["cuda"], gdet["cpu"])
            need(all(wired.values()), f"TR {arch}: the {key} step's params are not AdamW "
                 f"of its own grads: {wired}")
            need(row[f"step_{key}_bound_worst"] <= 1.0,
                 f"TR {arch}: the {key} step's params part past first_step_bound: "
                 f"{row[f'step_{key}_bound_at']}")
            # the optimizer alone, gated: AdamW on the card and on the CPU
            # from the same (the card's) grads
            upd = {"cuda": adamw.apply_updates(pg, gg, adamw.init(pg, opt), opt, 1.0),
                   "cpu": adamw.apply_updates(pc, gg_cpu, adamw.init(pc, opt), opt, 1.0)}
            (ng, og), (nc, oc) = upd["cuda"], upd["cpu"]
            row[f"adamw_{key}_param_worst"] = _tree_close(ng, nc, TR_TOL, TR_TOL)[0]
            if quant:
                row["adamw_int8_codes_apart"] = [_code_diff(og.m, oc.m), _code_diff(og.v, oc.v)]
                row["adamw_int8_scale_worst"] = max(
                    _tree_close(og.m_scale, oc.m_scale, TR_TOL, 0.0)[0],
                    _tree_close(og.v_scale, oc.v_scale, TR_TOL, 0.0)[0])
            else:
                row["adamw_f32_moment_worst"] = max(_tree_close(og.m, oc.m, TR_TOL, TR_TOL)[0],
                                                    _tree_close(og.v, oc.v, TR_TOL, TR_TOL)[0])
        log(f"TR {arch}: {json.dumps(row)}")
        if flips:
            log(f"TR {arch}: {flips} of {len(rc)} router calls took another expert on the "
                f"card; its numbers are reported, not bound")
        else:
            need(rel <= TR_LOSS_RTOL, f"TR {arch}: loss {float(lg)} card, {float(lc)} CPU")
            need(g_worst <= 1.0, f"TR {arch}: grad {g_leaf} outside rtol = atol = {TR_TOL}")
            need(row["step_f32_loss_rel"] <= TR_LOSS_RTOL
                 and row["step_int8_loss_rel"] <= TR_LOSS_RTOL,
                 f"TR {arch}: the train step's loss apart: {row}")
            need(row["adamw_f32_param_worst"] <= 1.0 and row["adamw_int8_param_worst"] <= 1.0
                 and row["adamw_f32_moment_worst"] <= 1.0,
                 f"TR {arch}: AdamW's params / moments outside {TR_TOL}: {row}")
            need(all(far <= 1 for _, _, far in row["adamw_int8_codes_apart"])
                 and row["adamw_int8_scale_worst"] <= 1.0,
                 f"TR {arch}: int8 moment codes / scales apart: {row}")
        out[arch] = row
        del bc, bg, pc, pg, gc, gg, runs, new, gdet, bound
        torch.cuda.empty_cache()
    return out


def phase_determinism_probe():
    """Path TD: stablelm-1.6b at full width cut to TD_LAYERS layers, bf16,
    T's batch: the grads of one batch twice with the deterministic
    algorithms off (the leaves whose bits differ are where atomics
    accumulate) and twice under ``deterministic()`` (gated bit-equal)."""
    import dataclasses
    import torch
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.train_step import loss_and_grads, to_device
    from repro_torch.train.trainer import deterministic
    cfg = dataclasses.replace(get_config(T_ARCH), n_layers=TD_LAYERS)
    b = build_model(cfg, "cuda")
    p = b.init(0)
    batch = to_device(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=T_SEQ, batch=T_BATCH))
                      .batch_at(0), "cuda")
    out = {}
    for det in (False, True):
        with deterministic("cuda") if det else contextlib.nullcontext():
            g = [loss_and_grads(b, p, batch)[2] for _ in range(2)]
        diff = {}
        for (path, x), y in zip(ttree.leaves_with_path(g[0]), ttree.leaves(g[1])):
            if not torch.equal(x, y):
                diff[ttree.path_str(path)] = float((x.float() - y.float()).abs().max())
        out["deterministic" if det else "default"] = diff
        del g
    log(f"TD: grad leaves whose bits differ between two runs: {json.dumps(out)}")
    need(not out["deterministic"], f"TD: deterministic grads differ: {out['deterministic']}")
    return out


def _dir_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _opt_bytes(opt) -> int:
    from repro_torch import tree as ttree
    return sum(t.numel() * t.element_size()
               for side in (opt.m, opt.v, opt.m_scale, opt.v_scale) if side is not None
               for t in ttree.leaves(side))


def _timed_saves(trainer, record):
    """Wrap ``trainer.ckpt.save`` to log each save's host seconds (a
    blocking save includes the write; a background one the device-to-host
    fetch)."""
    save = trainer.ckpt.save

    def timed(step, tree, extra_meta=None, block=False):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(step, tree, extra_meta, block)
        record.append(dict(step=step, block=block, s=time.perf_counter() - t0))
    trainer.ckpt.save = timed


def profile_train_step(trainer, state, data, top=12, path="T"):
    """One more train step of ``trainer`` (anything with T's ``step_fn``)
    from ``state`` (batch T_STEPS, discarded) under torch.profiler: wall
    and device busy ms, the idle share, kernels launched, and the ``top``
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import make_source
    from repro_torch.train.trainer import deterministic
    batch = make_source(data).batch_at(T_STEPS)
    with deterministic("cuda"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            new, _ = trainer.step_fn(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    del new
    rows = device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    out = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
               kernels=sum(r[3] for r in rows),
               top=[dict(ms=r[0], kernel=r[1][:120], launches=r[3]) for r in rows[:top]])
    log(f"{path}: a profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
        f"{out['kernels']} kernels; top {json.dumps(out['top'])}")
    return out


def train_heavy(cfg, data, t, t_params):
    """Path TH: T's T_STEPS steps (its state from init(0), its batches, its
    f32 AdamW, the same step function under the deterministic algorithms)
    with remat "save_heavy", each step timed as the Trainer times T's.
    Every loss and the final params must equal T's (``t``, ``t_params`` on
    the host) bit for bit - the same ops recomputed in another grouping -
    or, if not, within TR_LOSS_RTOL / TR_TOL with the leaves apart named."""
    import dataclasses
    import statistics
    from types import SimpleNamespace
    import torch
    from repro_torch import tree as ttree
    from repro_torch.data import make_source
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import build_train_step, make_state
    from repro_torch.train.trainer import deterministic
    bundle = build_model(dataclasses.replace(cfg, remat="save_heavy"), "cuda")
    step_fn = build_train_step(bundle, AdamWConfig(lr=T_LR))
    source = make_source(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    losses, secs = [], []
    with deterministic("cuda"):
        state = make_state(bundle, AdamWConfig(lr=T_LR))
        for step in range(T_STEPS):
            batch = source.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s_step = statistics.median(secs[2:])
    got = ttree.leaves(state["params"])
    equal = len(got) == len(t_params) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(got, t_params))
    out = dict(losses=losses, s_per_step_median=s_step, s_per_step=secs[2:],
               tokens_per_s=T_BATCH * T_SEQ / s_step, peak_gib=peak,
               allocated_before_gib=before, losses_equal_T=losses == t["losses"],
               params_equal_T=equal, T_s_per_step_median=t["s_per_step_median"],
               T_peak_gib=t["peak_gib"])
    if not (equal and out["losses_equal_T"]):
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, t["losses"])]
        apart = [ttree.path_str(p) for (p, a), b in
                 zip(ttree.leaves_with_path(state["params"]), t_params)
                 if not torch.equal(a.cpu(), b)]
        worst, where = _tree_close(state["params"], ttree.unflatten_like(
            state["params"], t_params), TR_TOL, TR_TOL)
        out.update(loss_rel_gaps=gaps, leaves_apart=apart, worst=worst, worst_leaf=where)
        log(f"TH: not bit-equal to T: loss gaps {gaps}, {len(apart)} leaves apart "
            f"({apart[:8]}), worst {worst:.3g} of TR_TOL at {where}")
        need(max(gaps) <= TR_LOSS_RTOL and worst <= 1.0,
             f"TH: losses or params outside TR's tolerances of T's")
    out["profile"] = profile_train_step(SimpleNamespace(step_fn=step_fn), state, data,
                                        path="TH")
    log(f"TH: {json.dumps({k: v for k, v in out.items() if k != 's_per_step'})}")
    del state, got
    torch.cuda.empty_cache()
    return out


def phase_train_full(root):
    """Paths T, TH and TQ (see the module docstring), checkpoints under
    ``root``; T's directory is removed before TQ starts."""
    import math
    import shutil
    import statistics
    import torch
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.model_flops import model_flops
    from repro_torch.models import build_model
    from repro_torch.models.api import ShapeSpec
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_config(T_ARCH)
    need(cfg.remat == "full" and cfg.loss_chunk == 512 and cfg.dtype == "bfloat16",
         f"T: {cfg}")
    bundle = build_model(cfg, "cuda")
    data = DataConfig(vocab=cfg.vocab, seq_len=T_SEQ, batch=T_BATCH, seed=0)
    flops = model_flops(cfg, ShapeSpec("T", "train", T_SEQ, T_BATCH))["total"]
    res = {}

    def summary(path, out, saves):
        hist = out["history"]
        last = {}
        for r in hist:
            last[r["step"]] = r
        losses = [last[s]["loss"] for s in range(1, T_STEPS + 1)]
        need(all(math.isfinite(x) for x in losses), f"{path}: losses {losses}")
        secs = [last[s]["sec_per_step"] for s in range(3, T_STEPS + 1)]
        s_step = statistics.median(secs)
        return dict(losses=losses, s_per_step_median=s_step, s_per_step=secs,
                    tokens_per_s=T_BATCH * T_SEQ / s_step,
                    model_tflops_per_s=flops / s_step / 1e12,
                    model_flops_per_step=flops, share_of_989=flops / s_step / 989e12,
                    saves=saves, restarts=out["restarts"],
                    straggler_steps=out["straggler_steps"],
                    lr_scale=[last[s]["lr_scale"] for s in range(1, T_STEPS + 1)],
                    grad_norm=[last[s]["grad_norm"] for s in range(1, T_STEPS + 1)])

    # ---- T: fp32 moments, one blocking save at the end
    tdir = root / "T"
    tr = Trainer(bundle, AdamWConfig(lr=T_LR), data,
                 TrainerConfig(total_steps=T_STEPS, ckpt_every=10 ** 9, ckpt_dir=str(tdir),
                               log_every=1))
    saves = []
    _timed_saves(tr, saves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t = summary("T", out, saves)
    t.update(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             opt_state_bytes=_opt_bytes(out["state"]["opt"]),
             ckpt_bytes=_dir_bytes(tdir / f"step_{T_STEPS}"))
    need(out["restarts"] == 0, f"T: {out['restarts']} restarts")
    first5, last5 = t["losses"][:5], t["losses"][-5:]
    need(sum(last5) / 5 < sum(first5) / 5,
         f"T: mean loss of the last five steps {last5} not below the first five's {first5}")
    # a second trainer on the same directory restores the final checkpoint
    t2 = Trainer(bundle, AdamWConfig(lr=T_LR), data,
                 TrainerConfig(total_steps=T_STEPS, ckpt_dir=str(tdir)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state2, step2 = t2.restore_or_init()
    torch.cuda.synchronize()
    t["restore_s"] = time.perf_counter() - t0
    live = ttree.leaves(out["state"])
    back = ttree.leaves(state2)
    need(step2 == T_STEPS and len(live) == len(back)
         and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(live, back)),
         "T: the restored state differs from T's live state")
    t["restored_bit_equal"] = True
    del state2, back
    t["profile"] = profile_train_step(tr, out["state"], data)
    log(f"T: {json.dumps({k: v for k, v in t.items() if k != 's_per_step'})}")
    res["T"] = t
    t_params = [p.cpu() for p in ttree.leaves(out["state"]["params"])]
    del out, live, tr, t2
    torch.cuda.empty_cache()
    shutil.rmtree(tdir, ignore_errors=True)

    # ---- TH: T under remat="save_heavy"
    res["TH"] = train_heavy(cfg, data, t, t_params)
    del t_params

    # ---- TQ: int8 moments, a checkpoint every 10 steps, one injected failure
    boom = {"armed": True}

    def failure_hook(step):
        if step == TQ_FAIL_AT and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError(f"injected failure at step {step}")

    qdir = root / "TQ"
    tq = Trainer(bundle, AdamWConfig(lr=T_LR, quant_state=True), data,
                 TrainerConfig(total_steps=T_STEPS, ckpt_every=TQ_CKPT_EVERY,
                               ckpt_dir=str(qdir), log_every=1),
                 failure_hook=failure_hook)
    saves = []
    _timed_saves(tq, saves)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tq.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need(out["restarts"] == 1, f"TQ: {out['restarts']} restarts")
    by_step = {}
    for r in out["history"]:
        by_step.setdefault(r["step"], []).append(r["loss"])
    replayed = {s: v for s, v in by_step.items() if len(v) > 1}
    need(sorted(replayed) == list(range(TQ_CKPT_EVERY + 1, TQ_FAIL_AT + 1))
         and all(v[0] == v[1] for v in replayed.values()),
         f"TQ: replayed steps {replayed}")
    q = summary("TQ", out, saves)
    q.update(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             opt_state_bytes=_opt_bytes(out["state"]["opt"]),
             ckpt_bytes=_dir_bytes(qdir / f"step_{T_STEPS}"), replayed=replayed,
             loss_minus_T=[a - b for a, b in zip(q["losses"], t["losses"])])
    log(f"TQ: {json.dumps({k: v for k, v in q.items() if k != 's_per_step'})}")
    log(f"T/TQ: optimizer state {t['opt_state_bytes'] / 1e9:.3f} GB (f32 m + v) against "
        f"{q['opt_state_bytes'] / 1e9:.3f} GB (int8 codes + scales); checkpoints "
        f"{t['ckpt_bytes'] / 1e9:.3f} / {q['ckpt_bytes'] / 1e9:.3f} GB")
    res["TQ"] = q
    del out, tq
    torch.cuda.empty_cache()
    return res


def train_child() -> int:
    """The training paths, run by ``phase_train`` in a child process whose
    environment sets CUBLAS_WORKSPACE_CONFIG before its first cuBLAS handle
    (the parent made its own long before, serving): TR, TD, T, TH and TQ, their
    results written to chiprun_out/chip_smoke_train.json."""
    import os
    import shutil
    import tempfile
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    need(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == CUBLAS_CONFIG,
         "the training child needs CUBLAS_WORKSPACE_CONFIG from its parent")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    with timed("train TR"):
        res["TR"] = phase_train_parity()
    with timed("train TD"):
        res["TD"] = phase_determinism_probe()
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="train_ckpt_"))
    try:
        du = shutil.disk_usage(root)
        log(f"train: checkpoints under {root}, {du.free / 1e9:.1f} GB free of "
            f"{du.total / 1e9:.1f} GB")
        with timed("train T, TH, TQ"):
            res.update(phase_train_full(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["phase_s"] = PHASE_S
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_train.json").write_text(json.dumps(res, indent=1, default=str))
    return 0


def phase_train():
    """Run ``train_child`` in a child process (``--train-child``) with the
    deterministic cuBLAS workspace, and read its results; the child's
    output goes to this process's."""
    import os
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_CONFIG)
    out = OUT_DIR / "chip_smoke_train.json"
    out.unlink(missing_ok=True)
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--train-child"],
                        env=env, timeout=TRAIN_CHILD_TIMEOUT).returncode
    need(rc == 0 and out.exists(), f"the training child exited {rc}")
    return json.loads(out.read_text())


# ----------------------------------------------------- sharded training: TM, TMF
class _CollTimer:
    """Times every collective of ``distributed/collectives`` between two
    synchronizations of the card, and counts the host bytes it stages under
    gloo (a CUDA input copied to the host, the result copied back)."""

    def __init__(self):
        self.s = 0.0
        self.calls = 0
        self.host_bytes = 0
        self.on = False

    def install(self):
        import torch
        import torch.distributed as dist
        from repro_torch.distributed import collectives as coll
        timer = self

        def nbytes(t):
            if isinstance(t, (list, tuple)):
                return sum(nbytes(x) for x in t)
            return t.numel() * t.element_size() if torch.is_tensor(t) else 0

        def on_card(x):
            if isinstance(x, (list, tuple)):
                return any(on_card(t) for t in x)
            return torch.is_tensor(x) and x.is_cuda

        for name in ("all_gather", "all_reduce", "all_to_all", "all_reduce_",
                     "all_gather_blocks"):
            fn = getattr(coll, name)

            def wrapped(x, group, *a, _fn=fn, **k):
                if not timer.on or coll.size(group) == 1:
                    return _fn(x, group, *a, **k)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(x, group, *a, **k)
                torch.cuda.synchronize()
                timer.s += time.perf_counter() - t
                timer.calls += 1
                if on_card(x) and dist.get_backend(group) == "gloo":
                    # staged: the inputs out, the result (in place: the
                    # inputs) back
                    timer.host_bytes += nbytes(x) + nbytes(x if out is None else out)
                return out
            setattr(coll, name, wrapped)


def tm_batch(cfg, step, batch=TM_BATCH, seq=TM_SEQ):
    """A SyntheticLM batch with seeded stub patches / frames where needed."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    d = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch)).batch_at(step)
    rng = np.random.default_rng(step + 1)
    if cfg.frontend == "vision":
        d["patches"] = (0.02 * rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        d["frames"] = (0.02 * rng.standard_normal((batch, 8, cfg.d_model))).astype(np.float32)
    return d


def _mesh_gap(whole, ref, lr):
    """(worst |a - b| / (TR_TOL (1 + |b|)), share of elements past 1, worst
    |a - b| / (2 lr TM_STEPS)) of the gathered state's params against the
    one-process run's."""
    from repro_torch import tree as ttree
    worst = over = n = far = 0.0
    for a, b in zip(ttree.leaves(whole), ttree.leaves(ref)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d = (a - b).abs()
        r = d / (TR_TOL * (1 + b.abs()))
        worst = max(worst, float(r.max()))
        over += float((r > 1).sum())
        n += r.numel()
        far = max(far, float(d.max()) / (2 * lr * TM_STEPS))
    return worst, over / n, far


def tm_phase(rank, mesh):
    """TM on this rank (see the module docstring); rank 0 returns the rows."""
    import torch
    from repro_torch.configs import ALL_ARCHS, reduced_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.fault import gather_state, reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models import context as mctx
    from repro_torch.optim import AdamWConfig, adamw, schedule
    from repro_torch.train.train_step import build_train_step, dist_context_for
    from repro_torch.train.trainer import deterministic
    ctx = dist_context_for(mesh)
    world = ctx.groups.world
    opt = AdamWConfig(lr=T_LR)
    rows = {}

    def run(m, b, st, steps, first=0):
        step = build_train_step(b, opt, m, lr_schedule=schedule.constant)
        ms = []
        with deterministic("cuda"):
            for i in range(first, first + steps):
                st, met = step(st, tm_batch(b.cfg, i))
                ms.append({k: float(v) for k, v in met.items()})
        return st, ms, step

    mesh_cpu = make_host_mesh(*TM_MESH, ["cpu"] * (TM_MESH[0] * TM_MESH[1]))
    ctx_cpu = dist_context_for(mesh_cpu)
    for arch in ALL_ARCHS:
        cfg = reduced_config(arch)
        ep = cfg.moe is not None
        b = build_model(cfg, "cuda")
        p = b.init(0)
        t0 = time.perf_counter()
        mctx.set_context(ctx)
        step = build_train_step(b, opt, mesh, lr_schedule=schedule.constant)
        st = reshard_state({"params": p, "opt": adamw.init(p, opt)}, mesh, step.specs)
        rg, rc = [], []
        with router_log(rg):
            st, ms, step = run(mesh, b, st, TM_STEPS)
        whole = gather_state(st, mesh, step.specs)
        mesh_s = time.perf_counter() - t0
        if ep:
            # the same mesh step on CPU tensors: expert parallelism routes
            # each rank's block of tokens and averages the blocks' aux, so
            # one process is no reference
            bc = build_model(cfg, "cpu")
            pc = ttree_to(p, "cpu")
            mctx.set_context(ctx_cpu)
            sc = build_train_step(bc, opt, mesh_cpu, lr_schedule=schedule.constant)
            with router_log(rc):
                ref_st, rms, sc = run(mesh_cpu, bc, reshard_state(
                    {"params": pc, "opt": adamw.init(pc, opt)}, mesh_cpu, sc.specs), TM_STEPS)
            ref = gather_state(ref_st, mesh_cpu, sc.specs)
        mctx.set_context(None)
        flips = [None] * (TM_MESH[0] * TM_MESH[1])
        import torch.distributed as dist
        dist.all_gather_object(flips, sum(int((a != c).any()) for a, c in zip(rg, rc)),
                               group=world)
        if rank == 0:
            if not ep:
                ref, rms, _ = run(None, b, {"params": p, "opt": adamw.init(p, opt)}, TM_STEPS)
            worst, share, far = _mesh_gap(whole["params"], ref["params"], opt.lr)
            rows[arch] = dict(
                reference="the 2x2 mesh on CPU tensors" if ep else "one process on the card",
                loss_mesh=[x["loss"] for x in ms], loss_ref=[x["loss"] for x in rms],
                loss_rel=[abs(a["loss"] - c["loss"]) / abs(c["loss"]) for a, c in zip(ms, rms)],
                grad_norm_rel=[abs(a["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
                               for a, c in zip(ms, rms)],
                aux=[x["aux"] for x in ms], param_worst=worst, param_share_past=share,
                param_far=far, ep=ep, router_calls=len(rg), expert_flips=flips,
                mesh_s=mesh_s)
            log(f"TM {arch}: {json.dumps(rows[arch])}")
        if arch == TM_CKPT_ARCH:
            rows["ckpt"] = tm_checkpoint(rank, mesh, ctx, b, opt, st, whole, run)
        del b, p, st, whole
        torch.cuda.empty_cache()
    # compressed_psum over the four ranks, CUDA tensors against CPU ones
    gen = torch.Generator().manual_seed(100 + rank)
    g = 0.01 * torch.randn(3 * 1024 + 17, generator=gen)
    e = 0.001 * torch.randn(g.shape, generator=gen)
    out_g, err_g = coll.compressed_psum(g.cuda(), world, e.cuda())
    out_c, err_c = coll.compressed_psum(g, world, e)
    codes_g = coll.quantize_grad(g.cuda() + e.cuda())[0].cpu()
    codes_c = coll.quantize_grad(g + e)[0]
    psum = dict(out_max_abs=float((out_g.cpu() - out_c).abs().max()),
                err_max_abs=float((err_g.cpu() - err_c).abs().max()),
                codes_apart=int((codes_g != codes_c).sum()), codes=codes_c.numel(),
                want_rel=float((out_c - _psum_plain(g + e, world)).norm()
                               / _psum_plain(g + e, world).norm()))
    allp = [None] * 4
    import torch.distributed as dist
    dist.all_gather_object(allp, psum, group=world)
    if rank == 0:
        rows["compressed_psum"] = allp
        log(f"TM compressed_psum: {json.dumps(allp)}")
    return rows


def _psum_plain(x, group):
    from repro_torch.distributed import collectives as coll
    return coll.all_reduce(x.float(), group)


def tm_checkpoint(rank, mesh, ctx, b, opt, st, whole, run):
    """stablelm's TM state checkpointed whole, restored over 2x1 (ranks
    0-1) and on one process (rank 0); each takes step TM_STEPS + 1, as the
    2x2 run does."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.fault import gather_state, reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import context as mctx
    from repro_torch.optim import schedule
    from repro_torch.train.train_step import abstract_state, build_train_step, dist_context_for
    world = ctx.groups.world
    (ROOT / "build").mkdir(exist_ok=True)
    holder = [tempfile.mkdtemp(dir=ROOT / "build", prefix="tm_ckpt_") if rank == 0 else None]
    import torch.distributed as dist
    dist.broadcast_object_list(holder, src=0, group=world)
    ck = holder[0]
    try:
        if rank == 0:
            CheckpointManager(ck).save(TM_STEPS, whole, {"mesh": "2x2"}, block=True)
        coll.barrier(world)
        mctx.set_context(ctx)
        st22, m22, step = run(mesh, b, st, 1, first=TM_STEPS)
        w22 = gather_state(st22, mesh, step.specs)
        mctx.set_context(None)
        m21 = make_host_mesh(2, 1, ["cuda:0"] * 2)
        c21 = dist_context_for(m21)             # collective: every rank
        out = None
        if rank < 2:
            tree, meta = CheckpointManager(ck).restore(abstract_state(b, opt))
            s21 = build_train_step(b, opt, m21, lr_schedule=schedule.constant)
            mctx.set_context(c21)
            st21, mm, s21 = run(m21, b, reshard_state(tree, m21, s21.specs), 1, first=TM_STEPS)
            w21 = gather_state(st21, m21, s21.specs)
            mctx.set_context(None)
            if rank == 0:
                st1, m1, _ = run(None, b, ttree_to(tree, "cuda"), 1, first=TM_STEPS)
                out = dict(step=meta["step"], loss={"2x2": m22[0]["loss"], "2x1": mm[0]["loss"],
                                                    "1": m1[0]["loss"]})
                for name, w in (("2x1", w21["params"]), ("1", st1["params"])):
                    worst, share, far = _mesh_gap(w, w22["params"], opt.lr)
                    out[f"param_{name}"] = dict(worst=worst, share_past=share, far=far)
                log(f"TM checkpoint: {json.dumps(out)}")
        coll.barrier(world)
        return out
    finally:
        if rank == 0:
            shutil.rmtree(ck, ignore_errors=True)


def ttree_to(tree, device):
    from repro_torch import tree as ttree
    return ttree.tree_map(lambda t: t.to(device), tree)


def tmf_phase(rank, mesh, timer):
    """TMF on this rank (see the module docstring); rank 0 returns the row."""
    import math
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import hlo_analysis
    from repro_torch.models import build_model
    from repro_torch.models import context as mctx
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import build_train_step, dist_context_for, make_state
    from repro_torch.train.trainer import deterministic
    cfg = get_config(T_ARCH)
    need(cfg.remat == "full" and cfg.dtype == "bfloat16", f"TMF: {cfg}")
    b = build_model(cfg, "cuda")
    opt = AdamWConfig(lr=T_LR)
    ctx = dist_context_for(mesh)
    world = ctx.groups.world
    batches = [tm_batch(cfg, i, TMF_BATCH, TMF_SEQ) for i in range(TMF_STEPS)]
    one = None
    if rank == 0:                   # the one-process run first, alone on the card
        st = make_state(b, opt, 0)
        step = build_train_step(b, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one = dict(loss=[], s=[])
        with deterministic("cuda"):
            for x in batches:
                t0 = time.perf_counter()
                st, m = step(st, x)
                torch.cuda.synchronize()
                one["s"].append(time.perf_counter() - t0)
                one["loss"].append(float(m["loss"]))
        one["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del st, step
        torch.cuda.empty_cache()
    coll.barrier(world)
    mctx.set_context(ctx)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = make_state(b, opt, 0, mesh)
    step = build_train_step(b, opt, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    res = dict(loss=[], s=[], coll_s=[], coll_calls=[], host_bytes=[], coll_bytes=[],
               coll_groups=[])
    with deterministic("cuda"):
        for x in batches:
            coll.barrier(world)
            timer.s, timer.calls, timer.host_bytes, timer.on = 0.0, 0, 0, True
            t0 = time.perf_counter()
            with hlo_analysis.collective_counter(ctx.groups) as moved:
                st, m = step(st, x)
                torch.cuda.synchronize()
            res["s"].append(time.perf_counter() - t0)
            res["coll_bytes"].append(moved.collective_bytes)
            res["coll_groups"].append(moved.group_bytes)
            timer.on = False
            res["loss"].append(float(m["loss"]))
            res["coll_s"].append(timer.s)
            res["coll_calls"].append(timer.calls)
            res["host_bytes"].append(timer.host_bytes)
    mctx.set_context(None)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["init_s"] = init_s
    import torch.distributed as dist
    allr = [None] * 4
    dist.all_gather_object(allr, res, group=world)
    del st, step, b
    torch.cuda.empty_cache()
    if rank != 0:
        return None
    losses = allr[0]["loss"]
    need(all(math.isfinite(v) for v in losses), f"TMF: losses {losses}")
    need(all(r["loss"] == losses for r in allr), "TMF: the ranks' losses differ")
    gaps = [abs(a - c) / abs(c) for a, c in zip(losses, one["loss"])]
    s_med = [statistics.median(r["s"][1:]) for r in allr]
    c_med = [statistics.median(r["coll_s"][1:]) for r in allr]
    row = dict(loss_mesh=losses, loss_one=one["loss"], loss_rel=gaps,
               s_per_step=[r["s"] for r in allr], s_per_step_median=s_med,
               coll_s_median=c_med, coll_share=[c / s for c, s in zip(c_med, s_med)],
               coll_calls=allr[0]["coll_calls"],
               host_bytes_per_step=[r["host_bytes"][-1] for r in allr],
               coll_bytes_per_step=allr[0]["coll_bytes"],
               coll_groups_per_step=allr[0]["coll_groups"],
               peak_gib=[r["peak_gib"] for r in allr], init_s=[r["init_s"] for r in allr],
               one_s_per_step=one["s"], one_peak_gib=one["peak_gib"],
               tokens_per_s=TMF_BATCH * TMF_SEQ / max(s_med))
    log(f"TMF: {json.dumps(row)}")
    need(gaps[0] <= TMF_LOSS_RTOL, f"TMF: step 1's loss {losses[0]} against one process's "
         f"{one['loss'][0]}")
    return row


def sp_phase(rank, timer):
    """SP on this rank (see the module docstring); rank 0 returns the row,
    the SP run's full counts under ``counts_full``."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.linops import quantize_param_tree
    from repro_torch.serve.seq_parallel import SeqPrefill
    cfg = dataclasses.replace(get_config(T_ARCH), quant_kv="dynamic")
    b = build_model(cfg, "cuda")
    n = SP_MESH[0] * SP_MESH[1]
    mesh = make_host_mesh(*SP_MESH, ["cuda:0"] * n)
    prog = SeqPrefill(b, mesh, SP_ROWS, SP_SEQ)          # collective: the mesh's groups
    world = prog.groups.world
    rng = np.random.default_rng(SP_SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (SP_ROWS, SP_SEQ), dtype=np.int32))
    one = None
    if rank == 0:                   # the one-process prefill first, alone on the card
        whole = quantize_param_tree(b.init(0))
        caches = b.init_caches(SP_ROWS, SP_SEQ)
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        logits, caches = b.prefill(whole, {"tokens": tokens.cuda()}, caches)
        torch.cuda.synchronize()
        one = dict(s=time.perf_counter() - t0, logits=logits.float().cpu(),
                   counts={k: v["launches"] for k, v in ops.counts().items()},
                   caches=dict(ttree.leaves_with_path(ttree.tree_map(lambda t: t.cpu(),
                                                                     caches))))
        del caches, logits
    coll.barrier(world)
    if rank != 0:
        whole = quantize_param_tree(b.init(0))
    params = prog.place_params(whole)
    del whole
    batch = prog.place_batch({"tokens": tokens})
    caches = prog.init_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    coll.barrier(world)
    torch.cuda.reset_peak_memory_stats()
    timer.s, timer.calls, timer.host_bytes, timer.on = 0.0, 0, 0, True
    ops.reset_counts()
    t0 = time.perf_counter()
    with hlo_analysis.collective_counter(prog.groups) as moved:
        logits = prog(params, batch, caches)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    timer.on = False
    full = ops.counts()
    mine = dict(s=secs, coll_s=timer.s, coll_calls=timer.calls, host_bytes=timer.host_bytes,
                peak_bytes=torch.cuda.max_memory_allocated(),
                counts={k: v["launches"] for k, v in full.items()},
                coll_bytes=moved.collective_bytes, coll_groups=moved.group_bytes,
                logits=logits.float().cpu())
    every = [None] * n
    dist.all_gather_object(every, mine, group=world)
    # every cache block to rank 0, leaf by leaf, against the one process's
    apart = []
    for (path, blk), spec, leaf in zip(ttree.leaves_with_path(caches),
                                       ttree.leaves(prog.cache_specs),
                                       ttree.leaves(prog.template)):
        parts = coll.gather_to(blk, world)
        if rank == 0:
            want = one["caches"][path]
            for r, part in enumerate(parts):
                coords = {"data": r // SP_MESH[1], "model": r % SP_MESH[1]}
                if not torch.equal(part, want[shd.block(spec, leaf.shape, mesh, coords)]):
                    apart.append((ttree.path_str(path), r))
    del params, batch, caches, b
    torch.cuda.empty_cache()
    if rank != 0:
        return None
    ref = one["logits"]
    diff = max(float((e["logits"] - ref).abs().max()) for e in every)
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) >= LOGIT_TOL["A"]
    same = (every[0]["logits"].argmax(-1) == ref.argmax(-1)) | ~sure
    row = dict(mesh=f"{SP_MESH[0]}x{SP_MESH[1]}", rows=SP_ROWS, seq=SP_SEQ,
               one_s=one["s"], s=[e["s"] for e in every], coll_s=[e["coll_s"] for e in every],
               coll_calls=[e["coll_calls"] for e in every],
               host_bytes=[e["host_bytes"] for e in every],
               peak_bytes=[e["peak_bytes"] for e in every],
               coll_bytes=every[0]["coll_bytes"], coll_groups=every[0]["coll_groups"],
               logits_max_abs_diff=diff, greedy_sure=int(sure.sum()),
               greedy_equal=bool(same.all()), caches_apart=apart,
               census_one={k: v for k, v in one["counts"].items() if v},
               census=[{k: v for k, v in e["counts"].items() if v} for e in every],
               ranks_alike=all(torch.equal(e["logits"], every[0]["logits"]) for e in every),
               counts_full=full)
    log(f"SP: {json.dumps({k: v for k, v in row.items() if k != 'counts_full'})}")
    need(not apart, f"SP: cache blocks apart from one process's: {apart[:8]}")
    need(row["ranks_alike"], "SP: the ranks' logits differ")
    need(diff <= LOGIT_TOL["A"], f"SP: logits {diff} from one process's")
    need(row["greedy_equal"], "SP: a greedy next token differs where the margin is sure")
    for k in ("pdq_prologue", "w8a8_matmul", "w8a8_swiglu_matmul"):
        need(one["counts"][k] > 0, f"SP: one process launched no {k}")
    need(all(e["counts"] == one["counts"] for e in every),
         f"SP: census {row['census']} against one process's {row['census_one']}")
    return row


def tm_child(rank: int, coordinator: str, out: str) -> int:
    """One rank of TM / TMF / SP (``--train-mesh-child``): join the gloo
    group of four, run TM, TMF then SP with every kernel count zeroed just
    before and read just after; rank 0 writes the rows to ``out``."""
    import os
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    need(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == CUBLAS_CONFIG,
         "the sharded training children need CUBLAS_WORKSPACE_CONFIG from their parent")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, make_host_mesh, train_backend
    n = TM_MESH[0] * TM_MESH[1]
    mesh = make_host_mesh(*TM_MESH, ["cuda:0"] * n)
    need(train_backend(mesh) == "gloo", "TM: four ranks on one card need gloo")
    init_distributed(coordinator, n, rank, timeout=TM_TIMEOUT, backend="gloo")
    timer = _CollTimer()
    timer.install()
    res = {}
    ops.reset_counts()
    with timed("train TM"):
        res["TM"] = tm_phase(rank, mesh)
    res["TM_counts"] = ops.counts()
    ops.reset_counts()
    with timed("train TMF"):
        res["TMF"] = tmf_phase(rank, mesh, timer)
    res["TMF_counts"] = ops.counts()
    with timed("prefill SP"):
        res["SP"] = sp_phase(rank, timer)
    res["SP_counts"] = res["SP"].pop("counts_full") if res["SP"] else None
    res["phase_s"] = PHASE_S
    if rank == 0:
        Path(out).write_text(json.dumps(res, indent=1, default=str))
    dist.destroy_process_group()
    return 0


def phase_train_mesh():
    """TM and TMF in four child processes (``--train-mesh-child``), each
    with the deterministic cuBLAS workspace; a child that fails or
    outlives TM_TIMEOUT fails the phase.  Gates: each path launched no
    hand kernel, TM's losses and params against the one-process step, the
    checkpoint restored over 2x1 and on one process, compressed_psum's
    codes on the card equal to its CPU run's; TMF's own gates run in rank
    0."""
    import os
    from repro_torch.launch.mesh import pick_coordinator
    out = OUT_DIR / "chip_smoke_tm.json"
    out.unlink(missing_ok=True)
    OUT_DIR.mkdir(exist_ok=True)
    coord = pick_coordinator(None)
    # four ranks share the card: segments that grow in place leave less of
    # it reserved and unused in each rank's cache
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_CONFIG,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    sys.stdout.flush()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--train-mesh-child", str(r), coord, str(out)], env=env)
             for r in range(TM_MESH[0] * TM_MESH[1])]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            need(all(p.poll() in (None, 0) for p in procs),
                 f"TM: a child exited {[p.poll() for p in procs]}")
            need(time.perf_counter() - t0 < TM_TIMEOUT,
                 f"TM: the children outlived {TM_TIMEOUT} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    need([p.returncode for p in procs] == [0] * len(procs),
         f"TM: the children exited {[p.returncode for p in procs]}")
    res = json.loads(out.read_text())
    need(res["SP"] is not None and res["SP_counts"], "SP: no row from rank 0")
    for path in ("TM", "TMF"):
        c = res[f"{path}_counts"]
        need(all(v["launches"] == 0 for v in c.values()),
             f"{path}: hand kernels launched: {c}")
    tm = res["TM"]
    for arch, row in tm.items():
        if arch in ("ckpt", "compressed_psum"):
            continue
        if any(row["expert_flips"]):
            log(f"TM {arch}: router decisions differ between the card and the CPU on some "
                f"rank ({row['expert_flips']}); its numbers are reported, not bound")
            continue
        need(all(r <= TR_LOSS_RTOL for r in row["loss_rel"]),
             f"TM {arch}: losses {row['loss_mesh']} on the card, {row['loss_ref']} in "
             f"{row['reference']}")
        need(row["param_share_past"] <= TM_OUTLIERS and row["param_far"] <= 1.0,
             f"TM {arch}: params apart: {row}")
    ck = tm["ckpt"]
    need(ck["step"] == TM_STEPS and all(
        abs(v - ck["loss"]["2x2"]) <= TR_LOSS_RTOL * abs(ck["loss"]["2x2"])
        for v in ck["loss"].values()), f"TM checkpoint: {ck}")
    need(all(ck[f"param_{n}"]["share_past"] <= TM_OUTLIERS and ck[f"param_{n}"]["far"] <= 1.0
             for n in ("2x1", "1")), f"TM checkpoint params: {ck}")
    for r, row in enumerate(tm["compressed_psum"]):
        need(row["codes_apart"] == 0, f"TM compressed_psum rank {r}: {row}")
    log(f"TM/TMF/SP: {json.dumps({k: v for k, v in res.items() if k != 'TM'})}")
    return res


# ------------------------------------------------------------------ path DR
def dr_child(out: str, names) -> int:
    """Trace the DR cells ``names`` (``--dryrun-child``) and write their
    records to ``out``; no card is visible to it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.models.api import ShapeSpec
    res = {}
    import dataclasses
    from repro_torch.configs import get_config
    for name in names:
        arch, shape, variant, mesh, *extra = DR_CELLS[name]
        extra = dict(extra[0]) if extra else {}
        pdq = extra.pop("pdq", False)
        cfg = dataclasses.replace(get_config(arch), **extra)
        sp = ShapeSpec(*shape) if isinstance(shape, tuple) else shape
        res[name] = dryrun.run_cell(arch, sp, variant=variant, mesh=mesh, cfg=cfg, pdq=pdq)
    Path(out).write_text(json.dumps(res, indent=1))
    return 0


def start_dryrun():
    """Start DR's children, niced and with no card visible; each writes
    chiprun_out/chip_smoke_dr<i>.json and its log beside it."""
    import atexit
    import os
    OUT_DIR.mkdir(exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, names in enumerate(DR_GROUPS):
        out = OUT_DIR / f"chip_smoke_dr{i}.json"
        out.unlink(missing_ok=True)
        logf = open(OUT_DIR / f"chip_smoke_dr{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-child", str(out), *names],
            env=env, stdout=logf, stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10)),
            out, logf))

    def stop():                 # a run that fails first leaves none behind
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return time.perf_counter(), procs


def phase_dryrun(started, serve, training):
    """DR's gates (see the module docstring) on its children's records."""
    import torch
    t0, procs = started
    try:
        for p, _, _ in procs:
            left = DR_TIMEOUT - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                raise SmokeError(f"DR: the children outlived {DR_TIMEOUT} s") from None
    finally:
        for p, _, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    recs = {}
    for p, out, _ in procs:
        need(p.returncode == 0 and out.exists(), f"DR: a child exited {p.returncode}: "
             f"{out.with_suffix('.log').read_text()[-3000:]}")
        recs.update(json.loads(out.read_text()))
    need(sorted(recs) == sorted(DR_CELLS) and all(r["status"] == "ok" for r in recs.values()),
         f"DR: {[(k, r['status'], r.get('error')) for k, r in recs.items()]}")
    card = torch.cuda.get_device_properties(0).total_memory
    # A: the traced step's census against one eager step of A's engine
    want = serve["A"][0]["step"]["eager_entries"]
    need(recs["A"]["kernels"] == want,
         f"DR: A's traced census {recs['A']['kernels']} against its eager step's {want}")
    # TMF: the traced bytes against every real step's on rank 0
    tmf = training["mesh"]["TMF"]
    for k, (by_kind, by_group) in enumerate(zip(tmf["coll_bytes_per_step"],
                                                tmf["coll_groups_per_step"])):
        need(recs["TMF"]["scaled_collectives"] == {n: float(v) for n, v in by_kind.items()}
             and recs["TMF"]["collectives_by_group"] == by_group,
             f"DR: TMF's traced collective bytes {recs['TMF']['collectives_by_group']} "
             f"against rank 0's step {k + 1}: {by_group}")
    # SP: the traced bytes and census against rank 0's real prefill
    sp = training["mesh"]["SP"]
    sp_entries = {k: v["entries"] for k, v in training["mesh"]["SP_counts"].items()
                  if v["entries"]}
    need(recs["SP"]["scaled_collectives"] == {n: float(v) for n, v in sp["coll_bytes"].items()}
         and recs["SP"]["collectives_by_group"] == sp["coll_groups"],
         f"DR: SP's traced collective bytes {recs['SP']['collectives_by_group']} against "
         f"rank 0's prefill: {sp['coll_groups']}")
    need(recs["SP"]["kernels"] == sp_entries,
         f"DR: SP's traced census {recs['SP']['kernels']} against rank 0's {sp_entries}")
    t_measured = training["T"]["peak_gib"] * 2**30
    row = dict(
        T=dict(predicted_peak_bytes=recs["T"]["peak_bytes"],
               measured_peak_bytes=t_measured,
               predicted_over_measured=recs["T"]["peak_bytes"] / t_measured,
               argument_bytes=recs["T"]["memory"]["argument_bytes"],
               measured_opt_state_bytes=training["T"]["opt_state_bytes"]),
        A=dict(census=recs["A"]["kernels"], eager_entries=want),
        TMF=dict(collectives=recs["TMF"]["collectives"],
                 by_group=recs["TMF"]["collectives_by_group"],
                 host_bytes_per_step=tmf["host_bytes_per_step"]),
        SP=dict(collectives=recs["SP"]["collectives"],
                by_group=recs["SP"]["collectives_by_group"], census=recs["SP"]["kernels"],
                predicted_peak_bytes=recs["SP"]["peak_bytes"],
                measured_peak_bytes=sp["peak_bytes"][0],
                predicted_over_measured=recs["SP"]["peak_bytes"] / sp["peak_bytes"][0],
                measured_peak_bytes_by_rank=sp["peak_bytes"]),
        cells={k: dict(trace_s=r["trace_s"], flops=r["flops"], peak_bytes=r["peak_bytes"],
                       fits=r["peak_bytes"] <= card, card_bytes=card,
                       collectives=r["collectives"], memory=r["memory"], kernels=r["kernels"])
               for k, r in recs.items()},
        wall_s=time.perf_counter() - t0)
    log(f"DR: {json.dumps(row)}")
    return row


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--train-mesh-child", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-child", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_child:
        return dr_child(args.dryrun_child[0], args.dryrun_child[1:])
    if args.train_child:
        return train_child()
    if args.train_mesh_child:
        rank, coordinator, out = args.train_mesh_child
        return tm_child(int(rank), coordinator, out)
    if args.mesh_child:
        rank, coordinator, out = args.mesh_child
        return mh_child(int(rank), coordinator, out)

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
    # path DR: CPU work in child processes, beside every later phase
    dr_started = start_dryrun()

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
    # paths X21, X22, X22D, MH: A over a mesh of cuda:0 entries, one
    # controller and two processes
    x_counts, x_serve, parity["X22"] = phase_mesh(cfg, params, serve["A"][0], detail)
    counts.update(x_counts)
    serve.update({k: [v] for k, v in x_serve.items()})
    log(f"serve mesh: decode tokens/s A {[round(r['decode_tokens_per_s'], 1) for r in serve['A']]}"
        f", X21 {x_serve['X21']['decode_tokens_per_s']:.1f}, X22 "
        f"{x_serve['X22']['decode_tokens_per_s']:.1f}, X22D "
        f"{x_serve['X22D']['decode_tokens_per_s']:.1f}, MH "
        f"{x_serve['MH']['decode_tokens_per_s']:.1f}; prefill s per round A "
        f"{serve['A'][0]['prefill_s_per_round']}, X22 {x_serve['X22']['prefill_s_per_round']}")
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
    # width and depth, served with their prefill extras; then G2, G2D, Y,
    # YD: gemma2-2b and yi-6b at full width and depth
    for models in (EXTRAS_MODELS, FAMILY_MODELS):
        x_counts, x_serve, x_parity = phase_dense(detail, models)
        counts.update(x_counts)
        serve.update(x_serve)
        parity.update(x_parity)
    # path G: the CNN track, trained, calibrated and evaluated on the card
    with timed("cnn G"):
        cnn_track = phase_cnn()
    # path AL: A through the per-request prefill baseline
    with timed("serve AL"):
        counts["AL"], al = phase_legacy(cfg, serve["A"][0])
    serve["AL"] = [al]
    log(f"serve AL (per-request prefill) against A (bucketed): prefill "
        f"{al['prefill_s']:.3f} s in {al['prefill_launches']} launches against A's "
        f"{[round(r['prefill_s'], 3) for r in serve['A']]} s in "
        f"{[r['prefill_launches'] for r in serve['A']]}; decode dispatch median "
        f"{al['decode_step_median_ms']:.3f} ms against "
        f"{[round(r['decode_step_median_ms'], 3) for r in serve['A']]}")
    torch.cuda.empty_cache()
    # paths TR, TD, T, TQ: training, in a child process (deterministic cuBLAS)
    with timed("train"):
        training = phase_train()
    # paths TM, TMF: the sharded train step over a 2x2 mesh of four processes
    with timed("train mesh"):
        training["mesh"] = phase_train_mesh()
    counts["SP"] = training["mesh"]["SP_counts"]
    # path DR: the dry run's cells against T's, A's, TMF's and SP's measurements
    with timed("dryrun"):
        dryrun = phase_dryrun(dr_started, serve, training)

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
                               + EXTRAS_PATHS + FAMILY_PATHS + ("X",)},
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
             train=training, dryrun=dryrun, phase_s=PHASE_S), indent=1,
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
