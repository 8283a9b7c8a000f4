# Copy of image_transformation_tpu/agentic/graph.py (host-only).
"""Minimal state-machine engine with LangGraph-shaped semantics.

Provides exactly what the agentic pipeline needs from a graph runtime —
named nodes, linear edges, conditional edges, an entry point, and a
compiled ``invoke`` loop — without the heavyweight dependency. Parity
anchor: the reference wires langgraph.StateGraph the same way
(the reference's agentic/graph.py:19-47).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

END = "__end__"


class CompiledGraph:
    def __init__(self, graph: "StateGraph"):
        self.graph = graph

    def invoke(self, state: Any, max_steps: int = 1000) -> Any:
        current = self.graph.entry
        steps = 0
        while current != END:
            if steps >= max_steps:
                raise RuntimeError(f"graph exceeded {max_steps} steps at '{current}'")
            node_fn = self.graph.nodes[current]
            state = node_fn(state)
            current = self.graph.next_node(current, state)
            steps += 1
        return state


class StateGraph:
    """Named nodes + (conditional) edges + entry point."""

    def __init__(self, state_type: Optional[type] = None):
        self.state_type = state_type
        self.nodes: Dict[str, Callable] = {}
        self.edges: Dict[str, str] = {}
        self.conditional: Dict[str, Tuple[Callable, Dict[str, str]]] = {}
        self.entry: Optional[str] = None

    def add_node(self, name: str, fn: Callable) -> None:
        if name in self.nodes:
            raise ValueError(f"duplicate node '{name}'")
        self.nodes[name] = fn

    def add_edge(self, src: str, dst: str) -> None:
        self.edges[src] = dst

    def add_conditional_edges(
        self, src: str, router: Callable[[Any], str], mapping: Dict[str, str]
    ) -> None:
        self.conditional[src] = (router, mapping)

    def set_entry_point(self, name: str) -> None:
        self.entry = name

    def next_node(self, current: str, state: Any) -> str:
        if current in self.conditional:
            router, mapping = self.conditional[current]
            key = router(state)
            if key not in mapping:
                raise ValueError(f"router at '{current}' returned unmapped key '{key}'")
            return mapping[key]
        if current in self.edges:
            return self.edges[current]
        return END

    def compile(self) -> CompiledGraph:
        if self.entry is None:
            raise ValueError("entry point not set")
        if self.entry not in self.nodes:
            raise ValueError(f"entry point references unknown node: {self.entry!r}")
        missing = [
            d
            for d in list(self.edges.values())
            + [t for _, m in self.conditional.values() for t in m.values()]
            if d != END and d not in self.nodes
        ]
        if missing:
            raise ValueError(f"edges reference unknown nodes: {missing}")
        return CompiledGraph(self)
