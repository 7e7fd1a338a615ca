"""Single-device serving engine (port of ``repro/serve/engine.py``).

The scheduler - bucketed batched prefill, continuous batching over a fixed
slot pool, request isolation, N-step decode budgets, ``stats`` - is
``serve/core.py``, copied from the reference unchanged.  This class binds
its plans to the port's model bundle on one device:

  * ``_exec_prefill``: one ``prefill_many`` over a fresh prefill pool, then
    ``_land_sub`` lands the rows into the serving pool in place (one
    ``cache_scatter`` launch for every cache leaf);
  * ``_exec_chunked`` (``chunked_prefill=True``, prompts longer than the
    largest bucket): the first chunk through ``prefill_many`` on a fresh
    pool, the later ones through ``prefill_chunk`` on the same pool, then
    one landing;
  * ``_exec_decode``: one block of ``decode_steps`` (N) model steps over the
    whole pool, in place (``decode_scan``), sampling on the device inside
    each step.  On the card the block is a CUDA graph captured once per
    engine (``serve/decode_graph.py``), so a dispatch is one copy of the
    plan's rows in, one replay and one copy of the (B, N) tokens out; every
    decode dispatch replays it, N = 1 included.  On the CPU the block runs
    eagerly.

With ``paged=True`` the pool is a physical page pool (``bundle.paged_cache``
ops; the allocator, prefix sharing, preemption and spill bookkeeping are
the copied core's): prefill lands page-wise through the plan's land maps;
a decode dispatch gathers the live rows' pages into the engine's
persistent logical scratch, runs the block on it and writes each row's
window of written pages back (``writeback(..., n_steps, max_steps=N)``);
the COW copy, spill capture and restore move pages.  Each such movement is
one launch of the page scatter (K7) over every leaf, outside the graph.

The prefill extras (``run(requests, extras=...)``): a vision config's
``patches`` and an encoder-decoder's ``frames``, shared by every request
of the run; each admission round broadcasts their first row to every slot
row as device tensors in the model dtype (``_extras_batch``).  A vision
config reserves ``frontend_tokens`` positions of every slot (the copied
core's ``patch_tokens``, which also turns prefix sharing off); an
encoder-decoder's pool holds ``mem_len = 8`` rows of cross-attention K/V
a layer, flat slot rows in a paged pool.  Chunked prefill is text-only.

With ``quantize_weights=True`` every layer's projections run PDQ int8
(``models.linops.quantize_param_tree``), which is what the reference's
engine documents; the reference itself leaves its stacked blocks in fp
(ROADMAP.md Queue 3).

PDQ health and the guard (``kernels/ops.py``): every launch returns the
reference's [fallbacks, clip_hits, clip_total] vector.  The kernels add
into one int64 (3,) device tensor - the decode graph's own, zeroed at the
block's start, or a fresh one for an eager prefill - and it leaves in the
same device-to-host copy as the launch's tokens, so no other host read
happens inside a launch; ``_observe_pdq`` folds it into ``stats`` and the
metrics.  ``pdq_fallback=True`` builds every block under ``ops.pdq_guard``
(the decode graph is captured under it).  With telemetry off the kernels
get no counter pointer and the vector is zeros, as in the reference.

Temperature sampling is Gumbel-max over a counter-based hash of (seed,
uid, step, vocab index) (``sample``), so a request's stream depends only
on (seed, uid, prompt, step) - not on the batch, N or the dispatch.  It
does not reproduce JAX's threefry streams; greedy decoding is the contract
between the two packages.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.distributed.fault import FaultInjector
from repro_torch.kernels import ops
from repro_torch.kernels.ref import true_div
from repro_torch.models import build_model, frontend
from repro_torch.models.linops import quantize_param_tree
from repro_torch.models.transformer import model_dtype

from . import telemetry as tmod
from .core import (DEFAULT_BUCKETS, ChunkedPlan, DecodePlan, PrefillPlan, Request,
                   SchedulerCore)
from .decode_graph import DecodeGraph
from .pages import SpillRecord

__all__ = ["DECODE_PAD", "DEFAULT_BUCKETS", "Request", "ServeEngine", "decode_scan",
           "sample"]

# token-block entry of a step a row did not consume (its budget ran out
# before the block did, or a free slot); token ids are non-negative
DECODE_PAD = -1

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply, lowbias32's shape with
    multipliers below 2**31) of 32-bit values held in int64, or of a
    Python int: no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def sample(logits, uids, steps, *, temperature: float, seed: int):
    """Per-row next token (int32) and all-finite flag of ``logits`` (B, V),
    from (B,) ``uids`` and ``steps``; plain tensor ops, so a captured graph
    holds it.  Greedy (``temperature <= 0``) is ``argmax``, the first index
    on ties.  Otherwise Gumbel-max: ``argmax(logits / T + g)`` with ``g =
    -log(-log(u))`` and ``u`` a uniform in (0, 1) from a counter-based hash
    of (seed, uid, step, vocab index), so a draw depends on those alone:
    not on the row, the batch, N or the dispatch."""
    ok = torch.isfinite(logits).all(-1)
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32), ok
    key = _mix32((uids.long() & _M32) ^ _mix32(int(seed) & _M32))
    key = _mix32(key ^ (steps.long() & _M32))
    vocab = torch.arange(logits.shape[-1], dtype=torch.int64, device=logits.device)
    bits = _mix32(key[:, None] ^ vocab)
    u = ((bits >> 8).float() + 0.5) * 2.0 ** -24
    g = -torch.log(-torch.log(u))
    return (true_div(logits.float(), float(temperature)) + g).argmax(-1).to(torch.int32), ok


def decode_scan(step_fn, sample_fn, n_block: int):
    """The N-step decode block (the reference's ``lax.scan`` body, as a
    loop): ``n_block`` calls of ``step_fn(caches, tok, pos)`` carrying
    (caches, token, position) on the device, ``sample_fn(logits, uids,
    steps + t)`` inside each step.

    Per-row budgets ride in ``n_steps``: a row past its budget FREEZES - it
    re-feeds its last token at its last position (rewriting one cache
    position with identical content, a bit-exact no-op) and emits
    ``DECODE_PAD`` with ok=True, so every row runs every step.

    PDQ telemetry is collected around each step into ``tel`` (int64 (3,)),
    so it holds the block's sum; ``tel=None`` collects nothing.
    ``pdq_guard`` wraps the whole block at the call site.

    Returns ``run(caches, tokens (B, 1), positions (B, 1), uids, steps,
    n_steps, tel=None) -> (toks (B, N) int32, ok (B, N) bool)``;
    ``caches`` are updated in place.
    """
    def run(caches, tokens, positions, uids, steps, n_steps, tel=None):
        tok, pos, toks, oks = tokens, positions, [], []
        for t in range(n_block):
            with ops.pdq_telemetry(tel is not None, counters=tel):
                logits, caches = step_fn(caches, tok, pos)
            nxt, okt = sample_fn(logits, uids, steps + t)
            act = t < n_steps
            toks.append(torch.where(act, nxt, DECODE_PAD))
            oks.append(okt | ~act)
            tok = torch.where(act, nxt, tok[:, 0]).to(tokens.dtype)[:, None]
            pos = torch.where(act, pos[:, 0] + 1, pos[:, 0])[:, None]
        return _columns(toks).to(torch.int32), _columns(oks)

    return run


def _columns(ts):
    """(B,) tensors as the columns of a (B, N) one.  One column is a view:
    stacking a single tensor is a ``copy_``, which a captured graph holds as
    a memcpy node (PERF.md §6, PR 21)."""
    return ts[0][:, None] if len(ts) == 1 else torch.stack(ts, 1)


def _graphed(device: torch.device) -> bool:
    """Whether the engine decodes through a captured graph: on the card
    always, on the CPU never."""
    return device.type == "cuda"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, item {item})")


class ServeEngine(SchedulerCore):
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 quantize_weights: bool = False, temperature: float = 0.0,
                 seed: int | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 batch_prefill: bool = True,
                 chunked_prefill: bool = False,
                 decode_steps: int = 1,
                 fault: FaultInjector | None = None,
                 pdq_fallback: bool = False,
                 paged: bool = False,
                 page_size: int = 64,
                 pool_pages: int | None = None,
                 prefix_sharing: bool = True,
                 spill: bool = False,
                 telemetry: bool = True,
                 trace: bool = False,
                 tel: "tmod.Telemetry | None" = None,
                 device="cuda"):
        if not batch_prefill:
            raise not_ported("the per-request prefill baseline", "9")
        self.cfg = cfg
        self.bundle = build_model(cfg, device)
        self.device = self.bundle.device
        self.params = (quantize_param_tree(params) if quantize_weights
                       else params)
        self.temperature = float(temperature)
        self.seed = 0 if seed is None else int(seed)
        self.pdq_fallback = bool(pdq_fallback)
        self.mem_len = frontend.N_FRAMES if cfg.family == "encdec" else 0
        if tel is None:
            tel = tmod.Telemetry(enabled=telemetry, trace=trace)
        self._init_scheduler(
            slots=slots, n_replicas=1, max_len=max_len,
            patch_tokens=cfg.frontend_tokens if cfg.frontend == "vision" else 0,
            buckets=buckets, batch_prefill=True, chunked_prefill=chunked_prefill,
            decode_steps=decode_steps, fault=fault, tel=tel)
        if paged:
            self._paged_ops = self.bundle.paged_cache(slots, max_len, page_size,
                                                      mem_len=self.mem_len)
            n_pp = self._paged_ops.n_pp
            if pool_pages is None:
                # headroom parity with the slot-row pool (+1 dump page):
                # every slot can hold a full sequence at once
                pool_pages = self.slots * n_pp + 1
            self._init_paging(page_size=page_size, pool_pages=pool_pages,
                              n_pp=n_pp, prefix_sharing=prefix_sharing,
                              spill=spill)
            # physical page pool: (n_blocks, pool_pages, ..., page, ...) per
            # paged leaf, (n_blocks, slots) rows for the flat ones
            self.caches = self._paged_ops.init(self.pool_pages)
            # the logical scratch every decode dispatch gathers into (paged
            # leaves; its flat leaves are the pool's own tensors)
            no_pages = np.full((self.slots, n_pp), -1, np.int32)
            self._logical, _ = self._paged_ops.gather_moves(
                self.caches, no_pages, np.zeros((self.slots,), np.int32))
        else:
            self.caches = self.bundle.init_caches(self.slots, self.max_len, self.mem_len)
        self._sample_fn = functools.partial(sample, temperature=self.temperature,
                                            seed=self.seed)
        self._scan = decode_scan(functools.partial(self.bundle.decode_step, self.params),
                                 self._sample_fn, self.decode_steps)
        self._graph = None
        if _graphed(self.device):
            self._graph = DecodeGraph(
                self._block, self._logical if self.paged else self.caches,
                self.bundle.init_caches(self.slots, self.max_len, self.mem_len),
                self.slots, self.device)
            self.stats["graph_replays"] = 0

    def _block(self, caches, tokens, positions, uids, steps, n_steps, tel):
        """The decode block as the engine runs it: under the guard when
        ``pdq_fallback``, collecting into ``tel`` when telemetry is on."""
        with ops.pdq_guard(self.pdq_fallback):
            return self._scan(caches, tokens, positions, uids, steps, n_steps,
                              tel if self.tel.enabled else None)

    def bind_thread(self) -> None:
        """Make the engine's card the current device of the calling thread
        (``ServeService`` calls it first in its loop thread; a CUDA graph
        replays on the current device's stream)."""
        if self.device.type == "cuda":
            # the caches' device carries the index a bare "cuda" leaves out
            leaf = next(iter(self.caches["blocks"][0].values()))
            torch.cuda.set_device(leaf.device)

    def _tel_buffer(self):
        """A zeroed int64 (3,) PDQ health vector on the engine's device."""
        return torch.zeros((ops.PDQ_TEL_WIDTH,), dtype=torch.int64, device=self.device)

    # -------------------------------------------------------------- sampling
    def _sample_rows(self, kind: str, plan, logits, tel):
        """Sample every batch row of a prefill launch: numpy (toks (B,), ok
        (B,)) and the launch's PDQ health vector ``tel``, in ONE
        device-to-host copy; the fault injector's logits poisoning applies
        first (a no-op outside fault tests)."""
        rows = self.fault.poison_rows(kind, plan)
        if rows:
            logits = logits.clone()
            logits[torch.as_tensor(rows, device=logits.device)] = float("nan")
        dev = logits.device
        toks, ok = self._sample_fn(logits, torch.as_tensor(plan.row_uids, device=dev),
                                   torch.as_tensor(plan.row_steps, device=dev))
        out = torch.cat((toks, ok.to(torch.int32), tel.view(torch.int32))).cpu().numpy()
        B = toks.shape[0]
        return out[:B], out[B:2 * B].astype(bool), out[2 * B:].view(np.int64)

    # ------------------------------------------------------------ exec hooks
    def _exec_prefill(self, plan: PrefillPlan, extras):
        return self._run_prefill("prefill", plan, (plan.tokens, plan.seq_lens), (), extras)

    def _exec_chunked(self, plan: ChunkedPlan, extras):
        """The first chunk through ``prefill_many`` on a fresh pool, each
        later chunk through ``prefill_chunk`` on the same pool, then one
        landing of the finished rows (the reference's ``_exec_chunked``)."""
        return self._run_prefill("chunked", plan, plan.first[1:], plan.chunks, extras)

    def _run_prefill(self, kind: str, plan, first, chunks, extras):
        """One prefill launch set: ``first`` = (tokens, seq_lens) through
        ``prefill_many`` over a fresh pool (prefill writes it in place),
        ``chunks`` = (bucket, tokens, seq_lens, start_lens) continuations
        through ``prefill_chunk`` on the same pool, then the rows land in
        the serving pool.  Every launch adds its PDQ health into one device
        vector, which rides the one token copy."""
        if extras and chunks:
            raise NotImplementedError(
                "chunked prefill is text-only (no vision/encdec extras)")
        dev = self.device
        sub = self.bundle.init_caches(self.slots, self.max_len, self.mem_len)
        tel = self._tel_buffer()

        def t(a):
            return torch.as_tensor(a, device=dev)

        with ops.pdq_guard(self.pdq_fallback), \
                ops.pdq_telemetry(self.tel.enabled, counters=tel):
            logits, sub = self.bundle.prefill_many(
                self.params, self._extras_batch({"tokens": t(first[0])}, extras), sub,
                t(first[1]))
            for _, tokens, seq_lens, start_lens in chunks:
                logits, sub = self.bundle.prefill_chunk(
                    self.params, {"tokens": t(tokens)}, sub, t(seq_lens), t(start_lens))
        self._land_sub(plan, sub)
        toks, ok, health = self._sample_rows(kind, plan, logits, tel)
        self._observe_pdq(health)       # rode the token copy
        return toks, ok

    def _extras_batch(self, batch: dict, extras) -> dict:
        """``batch`` with the run's extras: each one's first row broadcast
        to every slot row (extras are shared by a run's requests, as in the
        reference), on the engine's device in the model dtype."""
        dtype = model_dtype(self.cfg)
        for k, a in dict(extras or {}).items():
            a = torch.as_tensor(a)[:1].to(self.device, dtype)
            batch[k] = a.expand(self.slots, *a.shape[1:]).contiguous()
        return batch

    def _land_sub(self, plan, sub) -> None:
        """Land a finished prefill batch in the pool, in place (the
        reference donates the pool for the same effect): page-wise through
        the plan's land maps (paged), or whole slot rows."""
        if self.paged:
            self._paged_ops.land(self.caches, sub, plan.src_map,
                                 plan.land_rows, plan.land_js)
        else:
            self.bundle.cache_scatter(self.caches, sub, plan.src_map)

    def _exec_decode(self, plan: DecodePlan):
        """One N-step block: (toks (B, N), ok (B, N)) as numpy.  A paged
        pool gathers into the logical scratch first and writes each row's
        window of pages back after."""
        rows = (plan.tokens[:, 0], plan.positions[:, 0], plan.row_uids,
                plan.row_steps, plan.n_steps)
        if self.paged:
            po = self._paged_ops
            po.gather(self.caches, plan.page_tables, plan.positions[:, 0],
                      out=self._logical)
        if self._graph is not None:
            toks, ok, health = self._graph(*rows)
            self.stats["graph_replays"] += 1
        else:
            t = [torch.as_tensor(np.asarray(a, np.int32), device=self.device)
                 for a in rows]
            tel = self._tel_buffer()
            toks, ok = self._block(self._logical if self.paged else self.caches,
                                   t[0][:, None], t[1][:, None], *t[2:], tel)
            toks, ok, health = DecodeGraph.unpack(
                DecodeGraph.pack(toks, ok, tel).cpu().numpy(), toks.shape)
        if self.paged:
            po.writeback(self.caches, self._logical, plan.page_tables, plan.positions,
                         n_steps=plan.n_steps, max_steps=self.decode_steps)
        self._observe_pdq(health)       # rode the token copy
        return toks, self._poison_ok("decode", plan, ok)

    # ------------------------------------------------------ paged-pool hooks
    def _exec_page_copy(self, replica: int, pairs) -> None:
        cmap = np.full((self.pool_pages,), -1, np.int32)   # one replica
        for src, dst in pairs:
            cmap[dst] = src
        self._paged_ops.copy(self.caches, cmap)

    def _exec_spill(self, slot: int, uid: int, page_ids) -> SpillRecord:
        return SpillRecord(uid=uid, n_pages=len(page_ids),
                           length=int(self.lengths[slot]),
                           last_token=int(self.last_tokens[slot]),
                           data=self._paged_ops.capture(self.caches, slot,
                                                        page_ids))

    def _exec_restore(self, slot: int, rec: SpillRecord, page_ids) -> None:
        pmap = np.full((self.pool_pages,), -1, np.int32)
        for i, p in enumerate(page_ids):
            pmap[p] = i                       # pool page p <- record page i
        smap = np.full((self.slots,), -1, np.int32)
        smap[slot] = 0                        # flat leaves: record row 0
        self._paged_ops.restore(self.caches, rec.data, pmap, smap)
