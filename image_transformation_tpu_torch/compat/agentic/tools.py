"""The reference ``agentic.tools`` module on the port (``agentic/tools.py``)."""

from ...agentic.tools import *  # noqa: F401,F403
