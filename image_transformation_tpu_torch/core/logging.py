# Copy of image_transformation_tpu/core/logging.py (host-only; imports rewritten to this package).
"""Structured run logging: tagged console lines + JSONL event stream.

The reference logs with bare prints tagged [flex]/[refine]/[validate]/
[critic]/[micro] (SURVEY.md §5); this keeps those console lines (they are
part of the observable surface) and additionally appends one JSON object
per event to ``events.jsonl`` in the run directory, so runs are machine-
inspectable alongside the artifact tree.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Optional


class RunLogger:
    def __init__(self, events_path: Optional[Path] = None, echo: bool = True):
        self.events_path = Path(events_path) if events_path else None
        self.echo = echo
        if self.events_path:
            self.events_path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, tag: str, message: str, **fields: Any) -> None:
        if self.echo:
            print(f"[{tag}] {message}")
        if self.events_path:
            event = {"ts": time.time(), "tag": tag, "message": message}
            event.update(fields)
            try:
                with open(self.events_path, "a", encoding="utf-8") as f:
                    # default=str: numpy scalars/Paths in **fields must
                    # never crash the run the logger exists to observe
                    f.write(json.dumps(event, default=str) + "\n")
            except Exception:  # noqa: BLE001 - event persistence is best-effort
                pass

    def event(self, tag: str, **fields: Any) -> None:
        """Silent structured event (no console echo)."""
        if self.events_path:
            event = {"ts": time.time(), "tag": tag}
            event.update(fields)
            try:
                with open(self.events_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(event, default=str) + "\n")
            except Exception:  # noqa: BLE001 - best-effort
                pass


NULL_LOGGER = RunLogger(None, echo=True)
