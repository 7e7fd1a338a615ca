"""Deterministic, shardable data pipeline (the port's copy of
``repro/data/pipeline.py``; pure numpy, so batches are bit-equal to the
reference's for the same (seed, step, shard)).

Sources:
  * SyntheticLM  - procedural token streams (zipf-ish unigram + markov
    structure so models actually have something to learn); fully
    deterministic in (seed, step, shard), which makes restarts exact.
  * FileTokens   - memory-mapped .bin token files (uint16/uint32) with the
    same deterministic sharded indexing.

Each host pulls only its shard (``shard_id``/``num_shards``), so a global
batch is assembled where it is consumed rather than shipped.  A background
prefetch thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int                   # per-shard batch
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    kind: str = "synthetic"      # 'synthetic' | 'file'
    path: str | None = None
    prefetch: int = 2


class SyntheticLM:
    """Markov-flavored synthetic LM data; learnable and deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # fixed random transition structure: each token prefers a small set
        self._next = rng.integers(0, v, size=(v, 4), dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.num_shards + cfg.shard_id)
        B, S = cfg.batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.choice(cfg.vocab, size=B, p=self._unigram)
        follow = rng.random((B, S)) < 0.75
        choice = rng.integers(0, 4, size=(B, S))
        fresh = rng.choice(cfg.vocab, size=(B, S), p=self._unigram)
        for t in range(S):
            nxt = self._next[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class FileTokens:
    """Flat binary token file, deterministic strided sharded windows."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        assert cfg.path is not None
        self.cfg = cfg
        self._data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + step)
        idx = rng.integers(0, self._n_windows,
                           size=(cfg.num_shards, cfg.batch))[cfg.shard_id]
        S = cfg.seq_len
        rows = np.stack([self._data[i * S: i * S + S + 1] for i in idx])
        rows = rows.astype(np.int32) % cfg.vocab
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.kind == "file" else SyntheticLM(cfg)


class Prefetcher:
    """Background thread that stays ``cfg.prefetch`` steps ahead; restart-
    exact because batches are a pure function of the step index."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.source = make_source(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
