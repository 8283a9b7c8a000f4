# Copy of image_transformation_tpu/agentic/__init__.py (the compositor runs on the run's device).
"""Agentic (state-machine) variant of the macro-placement pipeline.

A dependency-free state machine with the reference's LangGraph node graph:

    macro -> validator -> compositor -> critic --(stop?)--> END
                                          \\--> micro -> validator -> ...

Differences from the reference (deliberate):
- no langgraph/langchain dependency — graph.py is a ~60-line engine with
  the same conditional-edge semantics;
- tool-calling WORKS: the vlm client forwards tools/tool_choice and
  surfaces tool_calls, so the micro agent's adjust_x/adjust_y execute;
- the compositor renders on the run's device (``run_workflow(...,
  device="cuda")`` by default) through ``ops.compose.composite_exact``:
  K1 on a card, its plain version on the CPU (identity-size pastes;
  scaling remains forbidden, as in the reference).
"""

from .graph import END, StateGraph
from .state import AgentState, ObjectMeta, PlacementState, RunContext
from .workflow import build_workflow, initialize_state, run_workflow
