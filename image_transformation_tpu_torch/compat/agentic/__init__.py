"""The reference ``agentic`` package on the port.

Counterpart of the root ``agentic/`` shims: the workflow names and the
reference's ``LayoutState`` from the port's ``agentic`` package, and one
module twin per reference module (``graph``, ``models``, ``nodes``,
``state``, ``tools``, ``workflow``). The compositor node renders on the
run's device (``run_workflow(..., device="cuda")`` by default).
"""

from ...agentic import (  # noqa: F401
    END,
    AgentState,
    ObjectMeta,
    PlacementState,
    RunContext,
    StateGraph,
    build_workflow,
    initialize_state,
    run_workflow,
)

LayoutState = AgentState  # reference name
