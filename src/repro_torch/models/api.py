"""Public model API (port of ``repro/models/api.py``).

``build_model(cfg, device)`` returns a bundle of step functions on one
device.  Unlike the reference's pure functions the serving ones update the
caches they are given IN PLACE and return them: the serving pool is landed
into and decoded over without copies.  ``bundle.paged_cache`` builds the
device half of the paged KV pool.  ``bundle.train_loss`` is the one
differentiable step (every serving step runs under ``torch.no_grad``).
``SHAPES`` are the reference's assignment shapes, and ``bundle.input_specs``
gives the dry run's stand-ins for a step's inputs at one of them (tensors
on the ``meta`` device, allocating nothing; ``launch/dryrun.py``).

The prefill extras ride in the batch dict beside ``tokens``: a vision
config's ``patches`` (B, P, d), prepended to the text (positions run over
P + S, and a right-padded row's valid prefix counts its patches), and an
encoder-decoder's ``frames`` (B, Sm, d), the encoder's input, whose K/V
every decoder layer keeps in ``cross_k`` / ``cross_v`` leaves of
``mem_len`` rows.  Chunked prefill is text-only, as in the reference.

``bundle.prefill_split`` is one rank's part of a sequence-parallel
prefill (``serve/seq_parallel.py``, which sets the ``DistContext`` whose
``seq`` it reads and hands it its block of the sequence).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.kv_cache import Move

from .config import ArchConfig
from .context import seq_split
from .layers import chunked_xent_loss
from .transformer import lm_apply, lm_init, lm_init_caches, lm_logits, model_dtype


def resolve_device(device) -> torch.device:
    """The entry points' device policy: CUDA unless the caller asks for the
    CPU, and an error - not a silent CPU run - when CUDA is absent.  While
    a ``FakeTensorMode`` is active (the dry run's trace) a ``meta`` device
    is a fake card (``launch/mesh.fake_mesh``)."""
    dev = torch.device(device)
    if (dev.type == "meta" and torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None):
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


# the reference's assignment shapes (MODEL_FLOPS reads them)
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    train_loss: Callable[..., Any]
    init_caches: Callable[..., Any]
    prefill: Callable[..., Any]
    prefill_split: Callable[..., Any]
    prefill_many: Callable[..., Any]
    prefill_chunk: Callable[..., Any]
    decode_step: Callable[..., Any]
    cache_scatter: Callable[..., Any]
    paged_cache: Callable[..., Any]
    input_specs: Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class _PageMeta:
    """Per-leaf paging classification (a leaf of the meta tree)."""
    kind: str            # 'seq' (pageable) | 'flat' (stays per-slot rows)
    seq_axis: int = -1
    n_leaf: int = 0      # this leaf's pages per sequence (>= pool n_pp)
    shape: tuple = ()
    dtype: Any = None
    fill: Any = None     # 'seq': the element its init repeats (0-dim, CPU)


@dataclasses.dataclass(frozen=True)
class PagedCacheOps:
    """Device half of the paged KV-cache pool (serve/pages.py holds the
    allocator): closures that move data between the physical page pool and
    the logical (B, ...) cache layout the step functions consume.  Every
    movement is ONE launch of the movement kernel over all its leaves
    (``ops.cache_move``, counted as K7): the paged leaves move as pages,
    the flat ones as slot rows; the maps are built in numpy from the plan's
    arrays and sent to the device once per movement.

    Unlike the reference's functions they update ``pool`` in place.  Leaves
    whose shape does not grow with ``max_len`` (the flat ``len`` leaf, a
    mamba layer's conv window and f32 SSD state, and int8 K/V leaves whose
    128-rounded extent is the same at ``max_len`` and ``2 * max_len``)
    classify 'flat' and keep per-slot rows in the pool: they land, spill
    and restore as whole slot rows in the same launch as the pages, start
    at zero, and the decode step updates them in the pool itself.
    """
    page: int
    n_pp: int            # page-table width: max_len // page
    meta: Any            # cache-shaped tree of _PageMeta
    init: Callable[..., Any]       # (n_pages, device=None) -> physical pool tree
    gather: Callable[..., Any]     # (pool, pt, lengths, out=None) -> logical caches
    writeback: Callable[..., Any]  # (pool, logical, pt, positions, n_steps, max_steps) -> pool
    land: Callable[..., Any]       # (pool, sub, src_map, rows, js) -> pool
    copy: Callable[..., Any]       # (pool, copy_map) -> pool (COW)
    capture: Callable[..., Any]    # (pool, slot, page_ids) -> host record
    restore: Callable[..., Any]    # (pool, rec, pmap, src_map) -> pool
    gather_moves: Callable[..., Any]     # (pool, pt, lengths, out=None) -> (logical, moves)
    writeback_moves: Callable[..., Any]  # (pool, logical, pt, positions, ...) -> moves
    land_moves: Callable[..., Any]       # (pool, sub, src_map, rows, js) -> moves


_SECTIONS = (("head", 0), ("tail", 0), ("blocks", 1))


def _tree_map(fn, *trees):
    """Map over a cache-shaped tree ({'head', 'tail', 'blocks'} of tuples of
    leaf dicts); ``fn(*leaves, ba=batch axis)``."""
    return {sec: tuple({k: fn(*(t[sec][i][k] for t in trees), ba=ba)
                        for k in trees[0][sec][i]}
                       for i in range(len(trees[0][sec])))
            for sec, ba in _SECTIONS}


def _leaves(tree):
    """(batch axis, leaf key, leaf) over a cache-shaped tree."""
    for sec, ba in _SECTIONS:
        for i, d in enumerate(tree[sec]):
            yield from ((ba, (sec, i, k), v) for k, v in d.items())


def _init_fill(x: torch.Tensor) -> torch.Tensor:
    """The one element a paged leaf's init repeats, as a 0-dim CPU tensor
    (the gather writes it into every page row it does not fill from the
    pool); raises if the init is anything else."""
    flat = x.reshape(-1)
    u = flat.view(torch.uint8).reshape(flat.numel(), -1)
    if not flat.numel() or not bool((u == u[:1]).all()):
        raise ValueError(f"a paged cache leaf's init must repeat one element; the "
                         f"{tuple(x.shape)} {x.dtype} leaf's does not")
    return flat[0].cpu().clone()


def _patch_count(cfg: ArchConfig) -> int:
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def _src_len(cfg: ArchConfig, seq: int) -> int:
    """An encoder-decoder's encoder-side length at a dry-run shape (audio
    frames downsample ~4x), as the reference's."""
    return max(seq // 4, 8)


def build_model(cfg: ArchConfig, device="cuda") -> ModelBundle:
    cfg = cfg.validate()
    dev = resolve_device(device)

    def init(seed: int = 0):
        """Random params from a seeded ``torch.Generator`` on the device."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return lm_init(gen, cfg)

    P = _patch_count(cfg)

    def train_loss(params, batch):
        """(loss, {"xent", "aux"}) of one batch, differentiable: ``tokens``
        and ``labels`` (B, S) on the device, and a vision config's
        ``patches`` / an encoder-decoder's ``frames``.  Positions run over
        P + S; the cross-entropy reads the text positions ``h[:, P:]``
        (``chunked_xent_loss``: ``cfg.loss_chunk`` positions a chunk) and
        the loss is xent + 0.01 * the MoE layers' load-balance loss."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h, _, aux = lm_apply(params, cfg, tokens=tokens, positions=_positions(B, P + S),
                             mode="train", **_extras(batch))
        xent = chunked_xent_loss(params["embed"]["embedding"], h[:, P:], batch["labels"],
                                 chunk=cfg.loss_chunk, logit_softcap=cfg.logit_softcap)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}

    def init_caches(batch: int, max_len: int, mem_len: int = 0):
        return lm_init_caches(cfg, batch, max_len, dev, mem_len)

    def _positions(B, L):
        return torch.arange(L, dtype=torch.int32, device=dev)[None].expand(B, L)

    def _extras(batch):
        """The batch's prefill extras, as ``lm_apply`` keywords."""
        return {k: batch[k] for k in ("frames", "patches") if k in batch}

    @torch.no_grad()
    def prefill(params, batch, caches):
        """Unpadded prefill: logits (B, vocab) of each row's last token."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        h, caches, _ = lm_apply(params, cfg, tokens=tokens, positions=_positions(B, P + S),
                                mode="prefill", caches=caches, **_extras(batch))
        return lm_logits(params, cfg, h[:, -1]), caches

    @torch.no_grad()
    def prefill_split(params, batch, caches):
        """One rank's block of a sequence-parallel prefill, under a
        ``DistContext`` whose ``seq`` (``context.SeqSplit``) says which:
        ``batch`` holds the block's ``tokens`` (B, t) and, for a vision
        config, its ``patches`` (B, size - t, d) (patches come first in the
        sequence), and an encoder-decoder's whole ``frames``; ``caches``
        are the rank's blocks of the pool.  Returns (logits (B, vocab) of
        each row's last token of the whole sequence - the last block's,
        every rank of the model group alike -, caches)."""
        split = seq_split()
        if split is None:
            raise ValueError("prefill_split runs under a DistContext with a SeqSplit")
        tokens = batch["tokens"]
        B = tokens.shape[0]
        pos = (split.start + _positions(B, split.size)).to(torch.int32)
        h, caches, _ = lm_apply(params, cfg, tokens=tokens, positions=pos, mode="prefill",
                                caches=caches, **_extras(batch))
        if h.shape[1] != split.size:
            raise ValueError(f"a block of {h.shape[1]} positions, the split's is {split.size}")
        last = coll.all_gather(h[:, -1], split.group).view(split.parts, B, -1)[-1]
        return lm_logits(params, cfg, last), caches

    @torch.no_grad()
    def prefill_many(params, batch, caches, seq_lens):
        """Batched bucketed prefill over right-padded prompts: row b holds
        seq_lens[b] real tokens then padding to the bucket length L
        (seq_lens == 0 marks a dummy row, whose patches are masked too).
        Pad entries never reach the cache (attention._clamp_padded).
        ``caches`` must be a fresh pool (``init_caches``); returns (logits
        (B, vocab) of each row's LAST REAL token, caches) - land the rows
        with ``cache_scatter``."""
        tokens = batch["tokens"]
        B, L = tokens.shape
        sl = seq_lens.to(device=dev, dtype=torch.int32)
        # the valid prefix in full-sequence positions, patches included
        tot = torch.where(sl > 0, sl + P, 0).to(torch.int32)
        h, caches, _ = lm_apply(params, cfg, tokens=tokens, positions=_positions(B, P + L),
                                mode="prefill", caches=caches, seq_lens=tot,
                                **_extras(batch))
        last = torch.clamp_min(tot - 1, 0).long()
        h_last = h[torch.arange(B, device=dev), last]
        return lm_logits(params, cfg, h_last), caches

    @torch.no_grad()
    def prefill_chunk(params, batch, caches, seq_lens, start_lens):
        """Continue a chunked prefill: row b of ``caches`` already holds
        ``start_lens[b]`` landed tokens; this call appends the next chunk
        (``seq_lens[b]`` real tokens, right-padded to the chunk's bucket)
        at absolute positions and attends the whole cache buffer, so
        queries see both the landed prefix and the chunk.  Returns (logits
        (B, vocab) of each row's last real token, caches); the last
        chunk's logits seed decoding as ``prefill_many``'s do.  Text-only
        families: the patch prepend and the encoder pass assume one
        whole-prompt prefill."""
        if cfg.frontend == "vision" or cfg.family == "encdec":
            raise NotImplementedError(
                f"chunked prefill supports text-only families, not "
                f"frontend={cfg.frontend!r} / family={cfg.family!r}")
        tokens = batch["tokens"]
        B, L = tokens.shape
        start = start_lens.to(device=dev, dtype=torch.int32)
        pos = start[:, None] + _positions(B, L)
        sl = seq_lens.to(device=dev, dtype=torch.int32)
        h, caches, _ = lm_apply(params, cfg, tokens=tokens, positions=pos,
                                mode="prefill", caches=caches, seq_lens=sl, chunked=True)
        last = torch.clamp_min(sl - 1, 0).long()
        h_last = h[torch.arange(B, device=dev), last]
        return lm_logits(params, cfg, h_last), caches

    @torch.no_grad()
    def decode_step(params, caches, tokens, positions):
        """tokens, positions: (B, 1) int32.  Returns (logits (B, vocab),
        caches)."""
        h, caches, _ = lm_apply(params, cfg, tokens=tokens, positions=positions,
                                mode="decode", caches=caches)
        return lm_logits(params, cfg, h[:, -1]), caches

    def cache_scatter(caches, sub, src_map):
        """Pool slot s takes sub batch row src_map[s]; -1 keeps the slot.
        One kernel launch for every cache leaf of every section (K6): the
        head and tail layers' (batch axis 0) and the stacked blocks' (batch
        axis 1), in place on ``caches``."""
        m = np.asarray(src_map, np.int32)
        kernel_ops.cache_move([Move(c, s, batch_axis=ba, host_map=m)
                               for (ba, _, c), (_, _, s) in zip(_leaves(caches),
                                                                _leaves(sub))],
                              "cache_scatter")
        return caches

    def paged_cache(batch: int, max_len: int, page: int = 64, *,
                    mem_len: int = 0) -> PagedCacheOps:
        """Build the device ops of a paged cache pool (see PagedCacheOps).

        Pageable leaves are found as the reference finds them: a leaf whose
        shape differs between ``init_caches(max_len)`` and ``init_caches(2 *
        max_len)`` grows with the sequence along the differing axis (both
        shape trees are built on the ``meta`` device, allocating nothing);
        an encoder-decoder's ``cross_k`` / ``cross_v`` (``mem_len`` rows)
        do not, and stay flat slot rows.
        The physical pool replaces (batch, seq) with one page axis: stacked
        block leaves become (n_blocks, n_pages, ..., page, ...).
        """
        if max_len % page:
            raise ValueError(f"page size {page} must divide max_len {max_len}")
        n_pp = max_len // page
        a = lm_init_caches(cfg, batch, max_len, "meta", mem_len)
        b = lm_init_caches(cfg, batch, 2 * max_len, "meta", mem_len)

        def classify(sa, sb, *, ba):
            diffs = [i for i, (x, y) in enumerate(zip(sa.shape, sb.shape)) if x != y]
            if not diffs:
                return _PageMeta("flat", shape=tuple(sa.shape), dtype=sa.dtype)
            if len(diffs) != 1:
                raise ValueError(f"cache leaf {tuple(sa.shape)} grows along "
                                 f"{len(diffs)} axes")
            ax = diffs[0]
            S = sa.shape[ax]
            if S % page or S // page < n_pp:
                raise ValueError(f"page size {page} does not divide seq extent "
                                 f"{S} of cache leaf {tuple(sa.shape)}; pick a "
                                 f"power-of-two page <= 128 that divides max_len")
            return _PageMeta("seq", seq_axis=ax, n_leaf=S // page,
                             shape=tuple(sa.shape), dtype=sa.dtype)

        # batch-1 pristine init: each paged leaf's INIT element (``pos`` -1,
        # int8 scales 1), which the gather writes into every page row it
        # does not fill from the pool, so that unallocated page regions read
        # bit-exactly like the never-written region of a slot-row cache
        base1 = init_caches(1, max_len, mem_len)
        meta = _tree_map(lambda m, b1, *, ba: dataclasses.replace(m, fill=_init_fill(b1))
                         if m.kind == "seq" else m, _tree_map(classify, a, b), base1)
        del base1

        def paged(m):
            return m.kind == "seq"

        # the distinct pages-per-sequence of the paged leaves: one map each
        n_leaves = sorted({m.n_leaf for _, _, m in _leaves(meta) if paged(m)})

        def init(n_pages: int, device=None):
            def one(m, *, ba):
                shape = list(m.shape)
                if paged(m):
                    shape[ba], shape[m.seq_axis] = n_pages, page
                # flat pool leaves fill with zeros, scales included, as the
                # reference's pool does
                return torch.zeros(tuple(shape), dtype=m.dtype, device=device or dev)
            return _tree_map(one, meta)

        def gather_moves(pool, pt, lengths, out=None):
            """The gather's movement: a logical tree on the pool's device
            and its moves, one a paged leaf, each with its init fill.  The
            paged leaves are ``out``'s (a logical tree this gather made
            before, which the caller keeps: a captured decode graph reads
            fixed pointers) or fresh ``torch.empty`` ones; flat leaves are
            the pool's own tensors."""
            pt = np.asarray(pt, np.int32)
            B = pt.shape[0]
            keep = np.arange(n_pp)[None, :] * page < np.asarray(lengths)[:, None]
            pt = np.where(keep, pt, -1)
            maps = {}
            for nl in n_leaves:
                g = np.full((B, nl), -1, np.int32)
                g[:, :n_pp] = pt
                maps[nl] = g.reshape(B * nl)
            moves = []

            def one(m, pool_leaf, lg, *, ba):
                if not paged(m):
                    return pool_leaf
                shape = list(m.shape)
                shape[ba] = B
                if lg is None:
                    lg = torch.empty(shape, dtype=m.dtype, device=pool_leaf.device)
                elif tuple(lg.shape) != tuple(shape) or lg.dtype != m.dtype:
                    raise ValueError(f"gather out leaf {tuple(lg.shape)} {lg.dtype}, "
                                     f"expected {tuple(shape)} {m.dtype}")
                moves.append(Move(lg, pool_leaf, None, m.seq_axis, page, ba,
                                  fill=m.fill, host_map=maps[m.n_leaf]))
                return lg
            if out is None:
                return _tree_map(lambda m, p, *, ba: one(m, p, None, ba=ba),
                                 meta, pool), moves
            return _tree_map(one, meta, pool, out), moves

        def gather(pool, pt, lengths, out=None):
            """Physical pages -> a (B, ...) logical tree the decode step
            runs on in place: ``out``'s paged leaves, or fresh ones.  pt (B,
            n_pp) page tables and lengths (B,) written tokens per row,
            numpy.  -1 entries, pages at or beyond the write frontier and a
            leaf's pages past n_pp gather nothing: the kernel writes them
            with the leaf's INIT element.  Flat leaves are the pool's own
            tensors, so the decode step's writes to them land in the
            pool."""
            logical, moves = gather_moves(pool, pt, lengths, out)
            kernel_ops.cache_move(moves)
            return logical

        def writeback_moves(pool, logical, pt, positions, n_steps=None,
                            max_steps: int = 1):
            """The write-back's moves, one a paged leaf: each row's
            decode-written pages back into the pool - the pages holding
            positions ``positions[b, 0]`` through ``positions[b, 0] +
            n_steps[b] - 1`` (an N-step block's; ``n_steps`` None: one
            step).  ``max_steps``, the block bound, fixes each row's window
            at ``W = (max_steps + page - 2) // page + 1`` candidate pages, as
            in the reference.  Whole pages are written, so a recycled page
            comes back fully cleaned (init fill past the last written
            token: the gather laundered it).  Free slots (-1 table entries)
            and candidates past a row's last page land on the write-only
            DUMP page 0; repeated targets there are last-write-wins in the
            numpy map (candidate by candidate, row by row), as in JAX, and
            page 0 is never read."""
            pt = np.asarray(pt, np.int32)
            B = pt.shape[0]
            rows = np.arange(B)
            p0 = np.asarray(positions)[:, 0]
            j0 = np.clip(p0 // page, 0, n_pp - 1)
            j1 = j0 if n_steps is None else np.clip(
                (p0 + np.maximum(np.asarray(n_steps), 1) - 1) // page, 0, n_pp - 1)
            W = (int(max_steps) + page - 2) // page + 1
            N = next(pool[sec][i][k].shape[ba] for ba, (sec, i, k), m in _leaves(meta)
                     if paged(m))
            maps = {}
            for nl in n_leaves:
                w = np.full((N,), -1, np.int32)
                for c in range(W):
                    jb = np.minimum(j0 + c, n_pp - 1)
                    valid = j0 + c <= j1
                    ent = pt[rows, jb]
                    w[np.where(valid & (ent > 0), ent, 0)] = np.where(
                        valid, rows * nl + jb, -1)
                maps[nl] = w
            moves = []

            def one(m, pool_leaf, lg, *, ba):
                if paged(m):
                    moves.append(Move(pool_leaf, lg, None, m.seq_axis, page, ba,
                                      host_map=maps[m.n_leaf]))
            _tree_map(one, meta, pool, logical)
            return moves

        def writeback(pool, logical, pt, positions, n_steps=None, max_steps: int = 1):
            """Scatter each row's decode-written pages back into the pool
            (``writeback_moves``), in one launch; flat leaves are the pool's
            own rows already."""
            kernel_ops.cache_move(writeback_moves(pool, logical, pt, positions,
                                                  n_steps, max_steps))

            def flat(m, pool_leaf, lg, *, ba):
                if not paged(m) and lg is not pool_leaf:   # flat state IS the new rows
                    pool_leaf.copy_(lg)
            _tree_map(flat, meta, pool, logical)
            return pool

        def land_moves(pool, sub, src_map, land_rows, land_js):
            """The landing's moves, one a leaf: flat leaves take whole slot
            rows through ``src_map``; paged leaves take pages - pool page p
            takes page ``land_js[p]`` of scratch row ``land_rows[p]`` (-1
            keeps; the planner leaves shared prefix pages out)."""
            rows = np.asarray(land_rows, np.int32)
            js = np.asarray(land_js, np.int32)
            maps = {nl: np.where(rows >= 0, rows * nl + js, -1).astype(np.int32)
                    for nl in n_leaves}
            slots = np.asarray(src_map, np.int32)
            moves = []

            def one(m, pool_leaf, s, *, ba):
                moves.append(Move(pool_leaf, s, None, m.seq_axis, page, ba,
                                  host_map=maps[m.n_leaf]) if paged(m) else
                             Move(pool_leaf, s, batch_axis=ba, host_map=slots))
            _tree_map(one, meta, pool, sub)
            return moves

        def land(pool, sub, src_map, land_rows, land_js):
            """Land a bucketed prefill batch in one launch (``land_moves``)."""
            kernel_ops.cache_move(land_moves(pool, sub, src_map, land_rows, land_js))
            return pool

        def copy(pool, copy_map):
            """Pool-internal page copy (the COW arm), in one launch: page p
            takes page ``copy_map[p]`` (-1 keeps); the map's targets are
            fresh pages, never sources, which the ops layer checks on the
            host."""
            cmap = np.asarray(copy_map, np.int32)
            moves = []

            def one(m, pool_leaf, *, ba):
                if paged(m):
                    moves.append(Move(pool_leaf, pool_leaf, batch_axis=ba, host_map=cmap))
            _tree_map(one, meta, pool)
            kernel_ops.cache_move(moves)
            return pool

        def capture(pool, slot: int, page_ids):
            """Host copy of one request's pages, padded with zero pages to
            n_pp, plus its flat per-slot rows: the spill record's payload, a
            tree of CPU tensors (bf16 leaves stay bf16)."""
            ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=dev)
            k = int(ids.shape[0])

            def one(m, pool_leaf, *, ba):
                if not paged(m):
                    sel = pool_leaf.narrow(ba, slot, 1)
                    return sel.to("cpu", copy=True)
                sel = pool_leaf.index_select(ba, ids).cpu()
                pad = list(sel.shape)
                pad[ba] = n_pp - k
                return torch.cat([sel, sel.new_zeros(pad)], dim=ba)
            return _tree_map(one, meta, pool)

        def restore(pool, rec, pmap, src_map):
            """Scatter a spill record back in one launch: paged leaves from
            its captured (n_pp-padded) pages through ``pmap`` (pool page ->
            record page, -1 keeps), flat leaves from its captured rows
            through ``src_map`` (slot -> record row 0, -1 keeps)."""
            pages = np.asarray(pmap, np.int32)
            slots = np.asarray(src_map, np.int32)
            moves = []

            def one(m, pool_leaf, rv, *, ba):
                moves.append(Move(pool_leaf, rv.to(dev), batch_axis=ba,
                                  host_map=pages if paged(m) else slots))
                return pool_leaf
            _tree_map(one, meta, pool, rec)
            kernel_ops.cache_move(moves)
            return pool

        return PagedCacheOps(page=page, n_pp=n_pp, meta=meta, init=init,
                             gather=gather, writeback=writeback, land=land,
                             copy=copy, capture=capture, restore=restore,
                             gather_moves=gather_moves,
                             writeback_moves=writeback_moves, land_moves=land_moves)

    def input_specs(shape) -> dict[str, Any]:
        """Stand-ins for every input of the step at ``shape`` (a ``SHAPES``
        name or a ``ShapeSpec``), on the ``meta`` device: the reference's
        shapes and dtypes, allocating nothing.  Train and prefill: the
        batch (``tokens``, train's ``labels``, a vision config's
        ``patches``, an encoder-decoder's ``frames``), the text ``seq``
        less the patches; decode: one token and its position a row against
        a ``seq``-long cache tree (``caches``, from ``init_caches``, with
        ``mem_len`` encoder rows for an encoder-decoder)."""
        sp = SHAPES[shape] if isinstance(shape, str) else shape
        i32, dt = torch.int32, model_dtype(cfg)

        def meta(*dims, dtype=i32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if sp.kind in ("train", "prefill"):
            S_text = sp.seq - P
            specs = {"tokens": meta(sp.batch, S_text)}
            if sp.kind == "train":
                specs["labels"] = meta(sp.batch, S_text)
            if cfg.frontend == "vision":
                specs["patches"] = meta(sp.batch, P, cfg.d_model, dtype=dt)
            if cfg.family == "encdec":
                specs["frames"] = meta(sp.batch, _src_len(cfg, sp.seq), cfg.d_model, dtype=dt)
            return specs
        mem_len = _src_len(cfg, sp.seq) if cfg.family == "encdec" else 0
        return {"tokens": meta(sp.batch, 1), "positions": meta(sp.batch, 1),
                "caches": lm_init_caches(cfg, sp.batch, sp.seq, "meta", mem_len)}

    return ModelBundle(cfg=cfg, device=dev, init=init, train_loss=train_loss,
                       init_caches=init_caches,
                       prefill=prefill, prefill_split=prefill_split,
                       prefill_many=prefill_many,
                       prefill_chunk=prefill_chunk, decode_step=decode_step,
                       cache_scatter=cache_scatter, paged_cache=paged_cache,
                       input_specs=input_specs)
