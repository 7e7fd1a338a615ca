"""Mesh serving: the data- and tensor-parallel ``ShardedServeEngine`` (port
of ``repro/serve/sharded.py``).

The engine extends the single-device ``ServeEngine`` to a ``launch.mesh``
``Mesh`` with axes ``('data', 'model')``, as one controller:

  * **data axis - replicas.**  Replica r owns the slot block ``[r * spr,
    (r + 1) * spr)`` of the scheduler's ``slots_per_replica * data`` slots
    and keeps its OWN pool tree on its first device (``init_caches(spr,
    ...)``, or its own page pool of ``pool_pages`` pages), not a view into
    one global pool: K4-K7 and the decode graph need whole, fixed leaves.
    Every exec hook runs replica by replica on that replica's rows of the
    plan, so each replica computes what the single-device engine computes
    on that block; the copied scheduler core's plans already carry
    replica-local ``src_map`` rows, land maps and page ids.  Each replica
    samples its own rows in its launch, and the (slots, N) token block is
    the replicas' blocks in replica order.  One qualifier, the reference's:
    MoE expert capacity is sized from the LOCAL token count (spr rows, not
    the pool), so under a capacity_factor tight enough to drop tokens the
    drops can differ from a pool-wide batch - the same caveat class as
    batch-size-dependent capacity on one device; parity is exact while
    capacity absorbs the routing, which the default factors guarantee.
  * **model axis - tensor parallelism.**  Replica r's mesh row is shard
    j on entry (r, j)'s device, entry (r, 0) the replica's home, which holds
    its pool, its non-split params and its program.  ``linops.tp_place``
    gives every shard its own block of columns of every weight the row
    splits, on the shard's device, once, when the engine is built (a copy
    on another card than the home; a view where the entries repeat one
    device, as on the CPU); the home keeps no whole copy of a split weight
    unless every shard shares its card.  The replica's programs run inside
    ``ops.tp_shard`` over its ``ops.TPRow``: each split projection runs K2
    on every shard's device over that shard's block and gathers the blocks
    on the home (``kernels/ops.py``); the MLP takes the unfused composition
    (no K3), as in the reference.  Prefill runs eagerly this way.
  * **decode.**  One ``DecodeGraph`` a replica, captured on its home: the
    shards' streams fork from the home's and join back inside the one
    capture, so the graph spans the row's cards; a capture that fails
    raises.
  * **health.**  Every launch's [fallbacks, clip_hits, clip_total] is
    summed over the replicas and their shards.
  * **refusals**, before anything is built: a row that mixes device types,
    and a row over cards where the home and a shard cannot reach each other
    by peer access (nothing is staged through the host); and the
    reference's: host spill (the capture / restore hooks address one
    pool), the per-request prefill baseline (``batch_prefill=True`` is
    forced, ``_submit_one = None``).

Replicas whose rows are the same devices share one placement, so a mesh
whose entries all repeat one card holds one copy of the weights.

``serve/multihost.py`` extends this engine to several OS processes, each
hosting a block of replicas: the per-launch bodies below (``_start``,
``_more``, ``_land_and_sample``, ``_decode``, ``_page_copy``) take host
arrays, not plans, so that a worker can run them from the command stream,
and ``_collect`` is where the replicas' outputs meet.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.linops import tp_place

from . import engine as _engine
from .core import DEFAULT_BUCKETS, ChunkedPlan, DecodePlan, PrefillPlan
from .decode_graph import DecodeGraph
from .engine import ServeEngine, copy_map, decode_scan, logical_scratch


class _Replica:
    """One data-parallel replica: its mesh row (``ops.TPRow``), params,
    pool and decode block (graph on the card)."""

    def __init__(self, eng, r: int, bundle, params, blocks):
        self.index = r
        self.row = ops.TPRow(list(eng.mesh.devices[r]), blocks)
        self.device = self.row.home
        self.shards = self.row.shards
        self.bundle = bundle
        self.params = params
        self.rows = slice(r * eng.slots_per_replica, (r + 1) * eng.slots_per_replica)
        spr = eng.slots_per_replica
        if eng.paged:
            self.paged_ops = (eng._paged_ops if bundle is eng.bundle else
                              bundle.paged_cache(spr, eng.max_len, eng.page_size,
                                                 mem_len=eng.mem_len))
            self.caches = self.paged_ops.init(eng.pool_pages)
            self.logical = logical_scratch(self.paged_ops, self.caches, spr)
        else:
            self.caches = bundle.init_caches(spr, eng.max_len, eng.mem_len)
        self.pages = slice(r * eng.pool_pages, (r + 1) * eng.pool_pages) if eng.paged else None
        scan = decode_scan(lambda c, t, p: bundle.decode_step(params, c, t, p),
                           eng._sample_fn, eng.decode_steps)
        enabled, guard = eng.tel.enabled, eng.pdq_fallback

        def block(caches, tokens, positions, uids, steps, n_steps, tel):
            with ops.tp_shard(self.row), ops.pdq_guard(guard):
                return scan(caches, tokens, positions, uids, steps, n_steps,
                            tel if enabled else None)

        self.block = block
        self.graph = None
        if _engine._graphed(self.device):
            with self.device_ctx():
                self.graph = DecodeGraph(block, self.logical if eng.paged else self.caches,
                                         bundle.init_caches(spr, eng.max_len, eng.mem_len),
                                         spr, self.device, row=self.row)
        self.sub = self.logits = self.tel = None     # a prefill in flight

    def on(self, a):
        """Host array ``a`` as a tensor on the replica's device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def device_ctx(self):
        """The replica's card as the current device (a graph replays on the
        current device's stream); nothing on the CPU."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())


def check_rows(mesh) -> None:
    """Refuse, before anything is built, a mesh row that mixes device types
    or whose home and a shard card cannot reach each other by peer access;
    a row naming CUDA devices this process lacks raises with the count."""
    for r, row in enumerate(mesh.devices):
        kinds = {d.type for d in row}
        if len(kinds) > 1:
            raise ValueError(f"mesh row {r} mixes device types {sorted(kinds)} "
                             f"({[str(d) for d in row]}): a row's shards are all CPU "
                             f"entries or all CUDA cards")
        if kinds != {"cuda"} or len(set(row)) == 1:
            continue
        have = torch.cuda.device_count()
        need = max(torch.device(d).index or 0 for d in row) + 1
        if have < need:
            raise RuntimeError(f"mesh row {r} ({[str(d) for d in row]}) needs {need} "
                               f"CUDA devices, found {have}")
        home = row[0]
        for d in dict.fromkeys(row[1:]):
            if d == home:
                continue
            for a, b in ((home, d), (d, home)):
                if not torch.cuda.can_device_access_peer(a, b):
                    raise RuntimeError(f"mesh row {r}: {a} cannot reach {b} by peer "
                                       f"access; a row's cards must be peers (nothing is "
                                       f"staged through the host)")


class ShardedServeEngine(ServeEngine):
    """ServeEngine over a ('data', 'model') ``Mesh``: ``slots_per_replica``
    rows a data-parallel replica (``data * slots_per_replica`` slots in
    all), each replica's projections column-split over its mesh row."""

    _submit_one = None       # the per-request baseline is single-replica only

    def __init__(self, cfg, params, *, mesh, slots_per_replica: int = 4,
                 max_len: int = 256, quantize_weights: bool = False,
                 temperature: float = 0.0, seed: int | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 chunked_prefill: bool = False, decode_steps: int = 1,
                 fault=None, pdq_fallback: bool = False, paged: bool = False,
                 page_size: int = 64, pool_pages: int | None = None,
                 prefix_sharing: bool = True, spill: bool = False,
                 telemetry: bool = True, trace: bool = False, tel=None):
        check_rows(mesh)
        if spill:
            raise ValueError("host spill is single-device only: the capture/restore "
                             "hooks address one pool, not the replicas' pools")
        self.mesh = mesh
        self.data_size = int(mesh.shape["data"])
        self.page_size = page_size
        first = mesh.devices[self._hosted()[0], 0]
        super().__init__(cfg, params, slots=self.data_size * slots_per_replica,
                         max_len=max_len, quantize_weights=quantize_weights,
                         temperature=temperature, seed=seed, buckets=buckets,
                         batch_prefill=True, chunked_prefill=chunked_prefill,
                         decode_steps=decode_steps, fault=fault,
                         pdq_fallback=pdq_fallback, paged=paged, page_size=page_size,
                         pool_pages=pool_pages, prefix_sharing=prefix_sharing,
                         telemetry=telemetry, trace=trace, tel=tel, device=first,
                         n_replicas=self.data_size)

    def _hosted(self) -> list[int]:
        """The replicas this process runs: every one (one controller)."""
        return list(range(self.data_size))

    def _init_pools(self) -> None:
        bundles, placed = {}, {}
        self.replicas = []
        for r in self._hosted():
            row = tuple(self.mesh.devices[r])
            dev = row[0]
            if dev not in bundles:
                bundles[dev] = (self.bundle if dev == self.device
                                else build_model(self.cfg, dev))
            if row not in placed:
                placed[row] = tp_place(self.params, row)
            self.replicas.append(_Replica(self, r, bundles[dev], *placed[row]))
        # the engine's whole tree goes: a split weight lives in its row's
        # blocks (and whole on a home only where every shard shares it)
        self.params = self.replicas[0].params
        if self.replicas[0].graph is not None:
            # per replica: every decode dispatch replays each hosted one's graph
            self.stats["replica_graph_replays"] = [0] * self.data_size

    def bind_thread(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # --------------------------------------------------- per-launch bodies
    # Each runs every hosted replica on its rows of host arrays shaped like
    # the plan's (global slot rows) and returns nothing or the launch's
    # outputs over ALL replicas, through ``_collect``.
    def _start(self, tokens, seq_lens, extras=None) -> None:
        """First prefill launch of a round: ``prefill_many`` over a fresh
        pool a replica, kept with its logits until the round lands."""
        spr = self.slots_per_replica
        for rep in self.replicas:
            with rep.device_ctx():
                rep.sub = rep.bundle.init_caches(spr, self.max_len, self.mem_len)
                rep.tel = self._tel_buffer(rep.device)
                batch = self._extras_batch({"tokens": rep.on(tokens[rep.rows])}, extras,
                                           rows=spr, device=rep.device)
            with self._launch(rep):
                rep.logits, rep.sub = rep.bundle.prefill_many(
                    rep.params, batch, rep.sub, rep.on(seq_lens[rep.rows]))

    def _more(self, tokens, seq_lens, start_lens) -> None:
        """A chunk continuation: ``prefill_chunk`` on each replica's pool."""
        for rep in self.replicas:
            with self._launch(rep):
                rep.logits, rep.sub = rep.bundle.prefill_chunk(
                    rep.params, {"tokens": rep.on(tokens[rep.rows])}, rep.sub,
                    rep.on(seq_lens[rep.rows]), rep.on(start_lens[rep.rows]))

    def _land_and_sample(self, src_map, land_rows, land_js, uids, steps):
        """Land each replica's finished rows in its pool (one K6 or K7
        launch over its tree, through its replica-local maps) and sample
        them: (toks (slots,), ok (slots,), health (3,)) over all replicas."""
        parts = []
        for rep in self.replicas:
            with rep.device_ctx():
                if self.paged:
                    rep.paged_ops.land(rep.caches, rep.sub, src_map[rep.rows],
                                       land_rows[rep.pages], land_js[rep.pages])
                else:
                    rep.bundle.cache_scatter(rep.caches, rep.sub, src_map[rep.rows])
                toks, ok = self._sample_fn(rep.logits, rep.on(uids[rep.rows]),
                                           rep.on(steps[rep.rows]))
                parts.append(DecodeGraph.pack(toks[:, None], ok[:, None],
                                              rep.tel).cpu().numpy())
            rep.sub = rep.logits = rep.tel = None
        toks, ok, health = self._collect(parts, 1)
        return toks[:, 0], ok[:, 0], health

    def _decode(self, tokens, positions, uids, steps, n_steps, page_tables=None):
        """One N-step block a replica (its graph's replay on the card):
        (toks (slots, N), ok (slots, N), health (3,))."""
        parts = []
        for rep in self.replicas:
            rows = rep.rows
            args = (tokens[rows, 0], positions[rows, 0], uids[rows], steps[rows],
                    n_steps[rows])
            pool = rep.logical if self.paged else rep.caches
            with rep.device_ctx():
                if self.paged:
                    rep.paged_ops.gather(rep.caches, page_tables[rows], positions[rows, 0],
                                         out=rep.logical)
                if rep.graph is not None:
                    out = rep.graph.packed(*args)
                    self.stats["replica_graph_replays"][rep.index] += 1
                else:
                    t = [rep.on(np.asarray(a, np.int32)) for a in args]
                    tel = self._tel_buffer(rep.device)
                    toks, ok = rep.block(pool, t[0][:, None], t[1][:, None], *t[2:], tel)
                    out = DecodeGraph.pack(toks, ok, tel).cpu().numpy()
                if self.paged:
                    rep.paged_ops.writeback(rep.caches, rep.logical, page_tables[rows],
                                            positions[rows], n_steps=n_steps[rows],
                                            max_steps=self.decode_steps)
            parts.append(out)
        return self._collect(parts, self.decode_steps)

    def _page_copy(self, replica: int, cmap) -> None:
        """A COW copy on replica ``replica``'s pool (where it is hosted)."""
        for rep in self.replicas:
            if rep.index == replica:
                with rep.device_ctx():
                    rep.paged_ops.copy(rep.caches, cmap)

    @contextlib.contextmanager
    def _launch(self, rep):
        """A prefill launch's context on replica ``rep``: its home the
        current device (the hand kernels launch on the current device's
        streams), its shards, the guard, and its PDQ health counters."""
        with rep.device_ctx(), ops.tp_shard(rep.row), ops.pdq_guard(self.pdq_fallback), \
                ops.pdq_telemetry(self.tel.enabled, counters=rep.tel):
            yield

    def _collect(self, parts, n: int):
        """Every replica's packed (toks (spr, n), ok (spr, n), health)
        output, hosted ones given in ``parts``, unpacked into (toks
        (slots, n), ok (slots, n), health summed over replicas)."""
        return _unpack(parts, (self.slots_per_replica, n))

    # ------------------------------------------------------------ exec hooks
    def _exec_prefill(self, plan: PrefillPlan, extras):
        self._start(plan.tokens, plan.seq_lens, extras)
        return self._finish("prefill", plan)

    def _exec_chunked(self, plan: ChunkedPlan, extras):
        if extras:
            raise NotImplementedError(
                "chunked prefill is text-only (no vision/encdec extras)")
        self._start(*plan.first[1:])
        for _, tokens, seq_lens, start_lens in plan.chunks:
            self._more(tokens, seq_lens, start_lens)
        return self._finish("chunked", plan)

    def _finish(self, kind: str, plan):
        toks, ok, health = self._land_and_sample(plan.src_map, plan.land_rows,
                                                 plan.land_js, plan.row_uids,
                                                 plan.row_steps)
        self._observe_pdq(health)       # rode the token copies
        return toks, self._poison_ok(kind, plan, ok)

    def _exec_decode(self, plan: DecodePlan):
        toks, ok, health = self._decode(plan.tokens, plan.positions, plan.row_uids,
                                        plan.row_steps, plan.n_steps, plan.page_tables)
        self._observe_pdq(health)
        return toks, self._poison_ok("decode", plan, ok)

    def _exec_page_copy(self, replica: int, pairs) -> None:
        self._page_copy(replica, copy_map(self.pool_pages, pairs))


def _unpack(parts, shape):
    """Replicas' ``DecodeGraph.pack`` outputs (numpy int32) in replica order
    -> (toks (R * rows, n), ok (R * rows, n), summed health (3,) int64)."""
    outs = [DecodeGraph.unpack(p, shape) for p in parts]
    return (np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs]),
            np.sum([o[2] for o in outs], axis=0, dtype=np.int64))


__all__ = ["ShardedServeEngine"]
