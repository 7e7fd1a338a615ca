"""One decode block captured as a CUDA graph (the port's counterpart of the
reference's jitted ``lax.scan`` block, ``repro/serve/engine.py``).

``DecodeGraph`` captures ``block(caches, tokens, positions, uids, steps,
n_steps, tel) -> (toks (B, N) int32, ok (B, N) bool)`` - the engine's
``decode_scan`` over its N, under its guard - once, over fixed buffers: the
five (B,) inputs in one int32 device tensor, the cache tree the engine
decodes in place (the slot-row pool, or the paged engine's persistent
logical scratch), the PDQ health counters ``tel`` (int64 (3,), zeroed at
the block's start by the graph's first node) and the output: toks and ok
as int32 and the counters' words, packed in one int32 tensor (``pack``).
A dispatch is then one host-to-device copy of the inputs from a pinned
staging buffer, one ``replay()`` and one device-to-host copy of the
output, which brings the tokens and the health vector together.

Before the capture the block runs once eagerly on a side stream over a
scratch tree of the same shapes (``warm_caches``): that builds and loads
the kernels, sets their launch attributes and allocates the kernels'
persistent buffers (``ops.persistent_buffers``) at the sizes the block
needs, all of which capture forbids.  The warm-up writes only the scratch,
and a capture runs nothing, so the engine's pool is left as it was.

The kernels' counts are host integers, which a replay does not touch.
Warm-up and capture leave them as they found them; the graph keeps what its
capture counted and adds it on every replay, so ``ops.counts()`` still says
what ran on the card.

A tensor-parallel replica's block (``serve/sharded.py``) runs each split
projection's shards on the row's own streams of their cards, forked from
the home's stream and joined back to it (``ops.TPRow``): the warm-up runs
that fork and join from its side stream of the home, and the capture from
its capturing stream, so the one graph, captured on the home, spans the
row's cards.  Every buffer a shard touches is the row's and made in the
warm-up; the graph keeps the row.

A capture that fails raises: there is no eager fallback.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from repro_torch.kernels import ops

INPUTS = ("tokens", "positions", "uids", "steps", "n_steps")


def _warm_up(body, caches, device) -> None:
    """Run ``body(caches)`` once on a side stream and wait for it (a TP
    row's shard streams join the side stream, so this waits for them too)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body(caches)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def _capture(body, caches, device):
    """(graph, output, seconds, pool bytes): ``body(caches)`` captured and
    instantiated, its output a tensor of the graph's private pool, the time
    of capture and instantiation, and the memory the pool reserved.

    Python's cycle collector is off during the capture (``torch.cuda.graph``
    collects once as it starts): an engine dropped earlier lives in
    reference cycles, and collecting it mid-capture destroys its graph and
    frees its pinned staging buffer, which invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    collecting = gc.isenabled()
    gc.disable()
    try:
        # a capturing stream of ``device``'s own: ``torch.cuda.graph``'s
        # default one is made once, on the card current at its first use
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
            reserved = torch.cuda.memory_reserved(device)
            out = body(caches)
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize(device)
    return (graph, out, time.perf_counter() - t0,
            torch.cuda.memory_reserved(device) - reserved)


class DecodeGraph:
    """One decode block over ``caches``, captured once; call it with the
    plan's five (B,) numpy rows to replay it (see the module note).
    ``row``: the ``ops.TPRow`` the block's projections run over, if any."""

    def __init__(self, block, caches, warm_caches, rows: int, device, row=None):
        dev = torch.device(device)
        self.inputs = torch.zeros((len(INPUTS), rows), dtype=torch.int32, device=dev)
        self.staging = torch.zeros((len(INPUTS), rows), dtype=torch.int32,
                                   pin_memory=dev.type == "cuda")
        self.tel = torch.zeros((ops.PDQ_TEL_WIDTH,), dtype=torch.int64, device=dev)
        self.shape = None

        def body(c):
            tok, pos, uids, steps, n_steps = self.inputs.unbind(0)
            self.tel.zero_()
            toks, ok = block(c, tok[:, None], pos[:, None], uids, steps, n_steps, self.tel)
            self.shape = tuple(toks.shape)
            return self.pack(toks, ok, self.tel)

        before = ops.count_state()
        _warm_up(body, warm_caches, dev)
        ops.set_counts(before)
        peer = 0 if row is None else row.peer_bytes
        self.graph, self.out, self.capture_s, self.pool_bytes = _capture(body, caches, dev)
        self.delta = [a - b for a, b in zip(ops.count_state(), before)]
        # bytes a replay copies between the row's devices
        self.peer_bytes = 0 if row is None else row.peer_bytes - peer
        ops.set_counts(before)
        # the buffers the capture launched on stay alive with the graph
        self.buffers = ops.persistent_buffers()
        self.row = row          # and the row's, which it keeps

    @staticmethod
    def pack(toks, ok, tel):
        """toks (B, N) int32, ok (B, N) bool and the int64 (3,) counters as
        ONE flat int32 tensor (the counters as their words), so one copy
        brings all three to the host."""
        return torch.cat((toks.flatten(), ok.to(torch.int32).flatten(),
                          tel.view(torch.int32)))

    @staticmethod
    def unpack(out, shape):
        """``pack``'s numpy copy -> (toks (B, N) int32, ok (B, N) bool,
        health (3,) int64)."""
        n = shape[0] * shape[1]
        return (out[:n].reshape(shape), out[n:2 * n].reshape(shape).astype(bool),
                out[2 * n:].view(np.int64))

    def packed(self, tokens, positions, uids, steps, n_steps):
        """Replay the block on the plan's rows; returns ``pack``'s numpy
        copy."""
        stage = self.staging.numpy()
        for i, a in enumerate((tokens, positions, uids, steps, n_steps)):
            stage[i] = a
        self.inputs.copy_(self.staging, non_blocking=True)
        self.graph.replay()
        ops.add_counts(self.delta)
        return self.out.cpu().numpy()

    def __call__(self, tokens, positions, uids, steps, n_steps):
        """Replay the block on the plan's rows; returns numpy (toks (B, N)
        int32, ok (B, N) bool, the block's PDQ health (3,) int64)."""
        return self.unpack(self.packed(tokens, positions, uids, steps, n_steps), self.shape)


__all__ = ["DecodeGraph", "INPUTS"]
