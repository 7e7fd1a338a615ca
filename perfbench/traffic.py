"""The one traffic generator: reads a mix file (``mixes/<name>.json``) and
draws every request of a run from ``--seed``.

Every mix is a closed loop of ``clients`` clients (agents that each wait for
their reply), each with one request in flight and submitting its next
request when the last one finishes; decoding is greedy, since the check
compares greedy tokens.  Prompt and output lengths are log-normal
(``median``, ``sigma``), clipped to [``min``, ``max``].  Lengths are
stratified so that every seed serves the same work: the request sequence is
cut into blocks of ``block`` requests, and each block holds the ``block``
quantiles of the distribution once, in an order drawn from the seed (prompt
and output orders drawn apart).  Token ids are uniform over the vocabulary.

The first requests of the clients that find a row free (``running`` of
them) are cut to a residual output: their ``max_new`` are the ``running``
stratified quantiles of ceil(U L), U uniform in (0, 1] and L the output
length, in a seeded order, so that completions spread from the window's
start as in a steady stream and every seed starts from the same residuals.
The other clients' first requests wait in the queue whole.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np

MIX_KEYS = {"clients", "block", "prompt_tokens", "output_tokens"}


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    keys = set(mix) - {"why", "sources"}
    if keys != MIX_KEYS:
        raise ValueError(f"{path}: mix keys {sorted(keys)}, want {sorted(MIX_KEYS)}")
    return mix


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n stratified quantiles (i + 0.5) / n of a clipped log-normal
    length, as whole tokens."""
    nd = statistics.NormalDist()
    vals = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def residual_quantiles(spec: dict, n: int, grid: int = 256) -> np.ndarray:
    """The n stratified quantiles of ceil(U L), U uniform in (0, 1] and L the
    clipped log-normal ``spec``, from a grid of grid x grid stratified
    pairs."""
    u = (np.arange(grid) + 0.5) / grid
    prod = np.sort(np.ceil(np.outer(u, quantiles(spec, grid))).reshape(-1))
    idx = ((np.arange(n) + 0.5) / n * prod.size).astype(np.int64)
    return np.maximum(prod[idx], 1).astype(np.int64)


class Traffic:
    """Every request of one run, in submission order: ``initial()`` gives
    each client's first request, ``next()`` the following ones.  A request
    is (prompt int32 array, max_new)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
        self.block = int(mix["block"])
        self._q_prompt = quantiles(mix["prompt_tokens"], self.block)
        self._q_output = quantiles(mix["output_tokens"], self.block)
        self._lengths: list[tuple[int, int]] = []

    def _draw(self) -> tuple[np.ndarray, int]:
        if not self._lengths:
            self._lengths = list(zip(self.rng.permutation(self._q_prompt),
                                     self.rng.permutation(self._q_output)))
        s, n = self._lengths.pop(0)
        prompt = self.rng.integers(0, self.vocab, size=int(s), dtype=np.int64)
        return prompt.astype(np.int32), int(n)

    def initial(self, running: int) -> list[tuple[np.ndarray, int]]:
        """Each client's first request, in submission order: the first
        ``running`` (at most ``clients``) with residual outputs."""
        n = int(self.mix["clients"])
        running = min(int(running), n)
        first = [self._draw() for _ in range(n)]
        left = self.rng.permutation(residual_quantiles(self.mix["output_tokens"], running))
        return [(p, int(left[i]) if i < running else m) for i, (p, m) in enumerate(first)]

    def next(self) -> tuple[np.ndarray, int]:
        return self._draw()

    @property
    def longest_output(self) -> int:
        return int(self._q_output.max())
