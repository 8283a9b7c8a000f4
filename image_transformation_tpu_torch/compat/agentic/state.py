"""The reference ``agentic.state`` module on the port (``agentic/state.py``),
with the reference's ``LayoutState``."""

from ...agentic.state import *  # noqa: F401,F403
from ...agentic.state import AgentState as LayoutState  # noqa: F401
