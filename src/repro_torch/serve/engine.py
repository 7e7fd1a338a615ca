"""Single-device serving engine (port of ``repro/serve/engine.py``).

The scheduler - bucketed batched prefill, continuous batching over a fixed
slot pool, request isolation, ``stats`` - is ``serve/core.py``, copied
from the reference unchanged.  This class binds its plans to the port's
model bundle on one device:

  * ``_exec_prefill``: one ``prefill_many`` over a fresh prefill pool, then
    ``_land_sub`` lands the rows into the serving pool in place (one
    ``cache_scatter`` launch for every cache leaf);
  * ``_exec_decode``: one ``decode_step`` over the whole pool, in place;
  * ``_sample_rows``: greedy argmax over float32 logits (first index on
    ties, as JAX), or temperature sampling.

With ``paged=True`` the pool is a physical page pool (``bundle.paged_cache``
ops; the allocator, prefix sharing, preemption and spill bookkeeping are
the copied core's): prefill lands page-wise through the plan's land maps,
each decode step gathers the live rows' pages into a fresh logical scratch,
runs the same ``decode_step`` on it and writes each row's frontier page
back, and the COW copy, spill capture and restore move pages; each such
movement is one launch of the page scatter (K7) over every leaf.

With ``quantize_weights=True`` every layer's projections run PDQ int8
(``models.linops.quantize_param_tree``), which is what the reference's
engine documents; the reference itself leaves its stacked blocks in fp
(ROADMAP.md Queue 3).

Temperature sampling draws from a ``torch.Generator`` seeded per (seed,
uid, step), so a request's stream does not depend on which launch sampled
it.  It does not reproduce JAX's threefry streams; greedy decoding is the
contract between the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.fault import FaultInjector
from repro_torch.models import build_model
from repro_torch.models.linops import quantize_param_tree

from . import telemetry as tmod
from .core import DEFAULT_BUCKETS, DecodePlan, PrefillPlan, Request, SchedulerCore
from .pages import SpillRecord

__all__ = ["DECODE_PAD", "DEFAULT_BUCKETS", "Request", "ServeEngine"]

# token-block entry of a row that consumed no decode step (a free slot)
DECODE_PAD = -1


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
        for on, what, item in (
                (not batch_prefill, "the per-request prefill baseline", "9"),
                (chunked_prefill, "chunked prefill", "6"),
                (decode_steps != 1, "decode_steps > 1", "4"),
                (pdq_fallback, "the guarded PDQ fallback", "5")):
            if on:
                raise not_ported(what, item)
        self.cfg = cfg
        self.bundle = build_model(cfg, device)
        self.device = self.bundle.device
        self.params = (quantize_param_tree(params) if quantize_weights
                       else params)
        self.temperature = float(temperature)
        self.seed = 0 if seed is None else int(seed)
        if tel is None:
            tel = tmod.Telemetry(enabled=telemetry, trace=trace)
        self._init_scheduler(
            slots=slots, n_replicas=1, max_len=max_len, patch_tokens=0,
            buckets=buckets, batch_prefill=True, chunked_prefill=False,
            decode_steps=1, fault=fault, tel=tel)
        if paged:
            self._paged_ops = self.bundle.paged_cache(slots, max_len, page_size)
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
        else:
            self.caches = self.bundle.init_caches(self.slots, self.max_len)
        # the PDQ health vector [fallbacks, clip_hits, clip_total]: zeros
        # until the telemetry slice ports the device-side counters
        self._pdq_health = np.zeros((3,), np.float32)

    # -------------------------------------------------------------- sampling
    def _row_generator(self, uid: int, step: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, uid, step]).generate_state(1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0]))
        return gen

    def _sample(self, logits, uids, steps) -> tuple[np.ndarray, np.ndarray]:
        """Per-row next token and all-finite flag, as numpy (B,)."""
        ok = torch.isfinite(logits).all(-1)
        if self.temperature <= 0.0:
            return logits.argmax(-1).cpu().numpy(), ok.cpu().numpy()
        ok_np = ok.cpu().numpy()
        toks = np.zeros((logits.shape[0],), np.int64)
        for i, (uid, step) in enumerate(zip(uids, steps)):
            if uid < 0 or not ok_np[i]:
                continue
            p = torch.softmax(logits[i] / self.temperature, -1)
            toks[i] = int(torch.multinomial(
                p, 1, generator=self._row_generator(int(uid), int(step))))
        return toks, ok_np

    def _sample_rows(self, kind: str, plan, logits):
        """Sample every batch row of a launch; the fault injector's logits
        poisoning applies first (a no-op outside fault tests)."""
        rows = self.fault.poison_rows(kind, plan)
        if rows:
            logits = logits.clone()
            logits[torch.as_tensor(rows, device=logits.device)] = float("nan")
        return self._sample(logits, plan.row_uids, plan.row_steps)

    # ------------------------------------------------------------ exec hooks
    def _exec_prefill(self, plan: PrefillPlan, extras):
        if extras:
            raise not_ported("prefill extras (patches, encoder frames)", "6")
        dev = self.device
        # prefill writes its pool in place, so every launch gets a fresh one
        sub = self.bundle.init_caches(self.slots, self.max_len)
        logits, sub = self.bundle.prefill_many(
            self.params, {"tokens": torch.as_tensor(plan.tokens, device=dev)},
            sub, torch.as_tensor(plan.seq_lens, device=dev))
        self._land_sub(plan, sub)
        out = self._sample_rows("prefill", plan, logits)
        self._observe_pdq(self._pdq_health)
        return out

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
        dev = self.device
        tokens = torch.as_tensor(plan.tokens, device=dev)
        positions = torch.as_tensor(plan.positions, device=dev)
        if self.paged:
            po = self._paged_ops
            logical = po.gather(self.caches, plan.page_tables, plan.positions[:, 0])
            logits, logical = self.bundle.decode_step(self.params, logical, tokens,
                                                      positions)
            po.writeback(self.caches, logical, plan.page_tables, plan.positions)
        else:
            logits, self.caches = self.bundle.decode_step(self.params, self.caches,
                                                          tokens, positions)
        nxt, ok = self._sample(logits, plan.row_uids, plan.row_steps)
        self._observe_pdq(self._pdq_health)
        act = plan.n_steps > 0
        toks = np.where(act, nxt, DECODE_PAD)[:, None]
        ok = np.where(act, ok, True)[:, None]
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
