# Copy of image_transformation_tpu/agentic/state.py (host-only), plus AgentState.device.
"""State carried through the agentic graph.

Parity anchors: the reference's agentic/state.py (ObjectMeta,
PlacementState with move_dx/move_dy, RunContext, LayoutState fields) —
the field inventory is the cross-node protocol, so it is preserved; the
langgraph ``Annotated[..., add_messages]`` machinery is replaced by a
plain message list (our graph engine appends directly).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

Pixels = int


@dataclass
class ObjectMeta:
    """One segmented cutout: identity plus its pixel footprint."""

    object_id: int
    name: str
    filename: str
    width: Pixels
    height: Pixels


@dataclass
class PlacementState:
    """Absolute placement (x, y, w, h) for one object; no scaling ever."""

    object_id: int
    name: str
    x: Pixels
    y: Pixels
    width: Pixels
    height: Pixels

    def move_dx(self, delta: int) -> None:
        self.x += delta

    def move_dy(self, delta: int) -> None:
        self.y += delta

    @property
    def box(self) -> List[int]:
        return [self.x, self.y, self.x + self.width, self.y + self.height]


@dataclass
class RunContext:
    """Immutable per-run facts: bundle paths, target canvas, budget."""

    image_name: str
    ratio: str
    canvas_size: Tuple[Pixels, Pixels]
    bundle_dir: Path
    background_path: Path
    objects_dir: Path
    results_json_path: Path
    original_image_path: Optional[Path]
    run_root: Path
    max_iterations: int


def _fresh(factory):
    return dataclasses.field(default_factory=factory)


@dataclass
class AgentState:
    """Mutable workflow state (the reference's LayoutState)."""

    # immutable context + connection
    run: RunContext
    objects: Dict[int, ObjectMeta]
    api_type: str
    api_key: Optional[str]
    temperature: float
    #: where the compositor runs: "cuda" (default; raises without a card),
    #: "cuda:N" or "cpu"
    device: str = "cuda"

    # conversation memory + planner output
    messages: List[Dict] = _fresh(list)
    flex_json: Optional[Dict] = None
    flex_text: Optional[str] = None
    placements: Dict[int, PlacementState] = _fresh(dict)

    # loop bookkeeping
    iteration: int = 0
    phase: str = "macro"
    max_iterations: int = 0

    # diagnostics / audit trail
    critic_notes: List[str] = _fresh(list)
    validation_errors: List[str] = _fresh(list)
    should_stop: bool = False
    current_composite_path: Optional[Path] = None
    last_macro_text: Optional[str] = None
    last_micro_text: Optional[str] = None
    last_critic_text: Optional[str] = None
    last_tool_calls: List[Dict] = _fresh(list)

    @property
    def canvas_size(self) -> Tuple[Pixels, Pixels]:
        return self.run.canvas_size

    @property
    def ratio(self) -> str:
        return self.run.ratio

    @property
    def iteration_dir(self) -> Path:
        return self.run.run_root / f"iteration_{self.iteration:02d}"

    def register_placement(self, placement: PlacementState) -> None:
        self.placements[placement.object_id] = placement

    def unplaced_object_ids(self) -> List[int]:
        return [oid for oid in self.objects if oid not in self.placements]
