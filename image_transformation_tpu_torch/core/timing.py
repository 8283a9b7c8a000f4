"""Named step timing with torch.profiler annotations.

Port of image_transformation_tpu/core/timing.py. Same API and
``time_log.txt`` format as the reference StepTimer: durations accumulate
across repeated step names, each step echoes ``[TIME] name: X.XXXs``, and
``write_to_file`` persists one ``name: X.XXXs`` line per step. Each step
also opens a ``torch.profiler.record_function`` range, so a profiler trace
lines up with the named pipeline phases (it costs nothing when no profiler
is recording).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from torch.profiler import record_function


class StepTimer:
    """Collects named wall-clock durations in seconds."""

    def __init__(self) -> None:
        self._durations: Dict[str, float] = {}

    @contextmanager
    def time_step(self, name: str, echo: bool = True) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            duration = time.perf_counter() - start
            self._durations[name] = self._durations.get(name, 0.0) + duration
            if echo:
                print(f"[TIME] {name}: {duration:.3f}s")

    def get(self, name: str) -> Optional[float]:
        return self._durations.get(name)

    def summary(self) -> Dict[str, float]:
        return dict(self._durations)

    def to_lines(self) -> List[str]:
        return [f"{k}: {v:.3f}s" for k, v in self._durations.items()]

    def write_to_file(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for line in self.to_lines():
                f.write(line + "\n")

    def load_from_file(self, path) -> None:
        """Seed durations from a previous run's time_log.txt (resume path:
        the final write would otherwise replace the whole log with only
        post-resume steps). Unparseable lines are ignored."""
        try:
            text = open(path, "r", encoding="utf-8").read()
        except OSError:
            return
        for line in text.splitlines():
            name, sep, value = line.rpartition(": ")
            if sep and value.endswith("s"):
                try:
                    self._durations[name] = self._durations.get(
                        name, 0.0
                    ) + float(value[:-1])
                except ValueError:
                    pass
