"""Checkpoint manager: rotation, latest-resume, background writes (port of
``repro/checkpoint/manager.py``)."""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any

from repro_torch import tree as tr

from .io import load_pytree, save_pytree, to_numpy

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- queries
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    # --------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra_meta: dict | None = None,
             block: bool = False):
        """The leaves are fetched to host numpy synchronously (the next
        step may replace them); serialization and fsync run on a
        background thread unless ``block``."""
        self.wait()
        fetched = tr.tree_map(to_numpy, tree)
        meta = dict(extra_meta or {}, step=step)

        def work():
            save_pytree(fetched, self._dir(step), extra_meta=meta)
            self._gc()

        def guarded():
            try:
                work()
            except BaseException as e:      # raised again by wait()
                self._error = e

        if not block:
            self._pending = threading.Thread(target=guarded, daemon=True)
            self._pending.start()
        else:
            work()

    def wait(self):
        """Join the pending write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(self, template: Any, step: int | None = None, device=None):
        """Returns (tree, meta) from ``step`` or the latest checkpoint, or
        (None, None) when there is none."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(template, self._dir(step), device=device)
