"""The reference ``agentic.graph`` module on the port (``agentic/graph.py``)."""

from ...agentic.graph import *  # noqa: F401,F403
