"""Carried from olavm_tpu/utils/timing.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Hierarchical scope timer — the reference's TimingTree
(plonky2/plonky2/src/util/timing.rs:9-134) as a context-manager API."""

from __future__ import annotations

import contextlib
import time


class TimingTree:
    def __init__(self, name: str = "root"):
        self.name = name
        self.records: list[tuple[int, str, float]] = []  # (depth, name, secs)
        self._depth = 0

    @contextlib.contextmanager
    def scope(self, name: str):
        self._depth += 1
        start = time.time()
        try:
            yield
        finally:
            elapsed = time.time() - start
            self.records.append((self._depth, name, elapsed))
            self._depth -= 1

    def print(self, min_secs: float = 0.0, file=None):
        for depth, name, secs in self.records:
            if secs >= min_secs:
                print(f"{'  ' * depth}{secs:8.3f}s  {name}", file=file)

    def total(self, name: str) -> float:
        return sum(s for _, n, s in self.records if n == name)
