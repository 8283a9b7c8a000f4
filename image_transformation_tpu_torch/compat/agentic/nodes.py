"""The reference ``agentic.nodes`` module on the port (``agentic/nodes.py``)."""

from ...agentic.nodes import *  # noqa: F401,F403
