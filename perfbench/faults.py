"""Faults planted under the timed path, each a ``patch(engine)`` for
``harness.run_cell``: the CPU tests run each at the test sizes and see
``correct`` come out false, and ``control.py --fault`` reads each on the
card at the cell's own size.  A one-card serving cell can have three: a
token altered where it is produced, a step that hands back its state
unchanged, and half of the batch left out."""
from __future__ import annotations

import numpy as np

# the position axis of the attention cache's leaves (layer, slot, ...);
# every other leaf is a row of state, whole
POSITION_AXIS = {"k": 3, "v": 3, "k_scale": 3, "v_scale": 3, "pos": 2}


def altered_token(eng):
    """A token altered where the decode launch produces it."""
    orig = eng._exec_decode

    def run(plan):
        toks, ok = orig(plan)
        return (np.asarray(toks) + 1) % eng.cfg.vocab, ok
    eng._exec_decode = run


def state_unchanged(eng):
    """Each decode step hands back its cache or state as it found it: what
    the step may write (each live row's entry at its position, and every
    other leaf's live rows) is saved before it and put back after it."""
    import torch
    orig = eng._exec_decode

    def run(plan):
        rows = torch.as_tensor(np.asarray(plan.live, dtype=np.int64))
        pos = torch.as_tensor(np.asarray(plan.positions, dtype=np.int64)[plan.live, 0])
        saved = []
        for c in eng.caches["blocks"]:
            for k, leaf in c.items():
                axis = POSITION_AXIS.get(k)
                if axis is None:
                    idx = (slice(None), rows.to(leaf.device))
                else:
                    idx = ((slice(None), rows.to(leaf.device))
                           + (slice(None),) * (axis - 2) + (pos.to(leaf.device),))
                saved.append((leaf, idx, leaf[idx].clone()))
        out = orig(plan)
        for leaf, idx, old in saved:
            leaf[idx] = old
        return out
    eng._exec_decode = run


def half_the_batch(eng):
    """Every other prefill row is left out of the landing into the pool."""
    orig = eng._land_sub

    def land(plan, sub):
        src = np.array(plan.src_map, copy=True)
        landed = np.flatnonzero(src >= 0)
        src[landed[::2]] = -1
        plan.src_map = src
        orig(plan, sub)
    eng._land_sub = land


FAULTS = {"altered_token": altered_token, "state_unchanged": state_unchanged,
          "half_the_batch": half_the_batch}
