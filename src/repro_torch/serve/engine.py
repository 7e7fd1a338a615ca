"""Single-device serving engine (port of ``repro/serve/engine.py``).

The scheduler - bucketed batched prefill, continuous batching over a fixed
slot pool, request isolation, ``stats`` - is ``serve/core.py``, copied
from the reference unchanged.  This class binds its plans to the port's
model bundle on one device:

  * ``_exec_prefill``: one ``prefill_many`` over a fresh prefill pool, then
    ``_land_sub`` lands the rows into the serving pool in place (one
    ``cache_scatter`` launch per cache leaf);
  * ``_exec_decode``: one ``decode_step`` over the whole pool, in place;
  * ``_sample_rows``: greedy argmax over float32 logits (first index on
    ties, as JAX), or temperature sampling.

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
                 spill: bool = False,
                 telemetry: bool = True,
                 trace: bool = False,
                 tel: "tmod.Telemetry | None" = None,
                 device="cuda"):
        for on, what, item in (
                (not batch_prefill, "the per-request prefill baseline", "9"),
                (chunked_prefill, "chunked prefill", "6"),
                (decode_steps != 1, "decode_steps > 1", "4"),
                (pdq_fallback, "the guarded PDQ fallback", "5"),
                (paged, "the paged KV pool", "3"),
                (spill, "host spill", "3")):
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
        """Land a finished prefill batch in the pool: whole slot rows, in
        place (the reference donates the pool for the same effect)."""
        self.bundle.cache_scatter(self.caches, sub, plan.src_map)

    def _exec_decode(self, plan: DecodePlan):
        dev = self.device
        logits, self.caches = self.bundle.decode_step(
            self.params, self.caches,
            torch.as_tensor(plan.tokens, device=dev),
            torch.as_tensor(plan.positions, device=dev))
        nxt, ok = self._sample(logits, plan.row_uids, plan.row_steps)
        self._observe_pdq(self._pdq_health)
        act = plan.n_steps > 0
        toks = np.where(act, nxt, DECODE_PAD)[:, None]
        ok = np.where(act, ok, True)[:, None]
        return toks, self._poison_ok("decode", plan, ok)
