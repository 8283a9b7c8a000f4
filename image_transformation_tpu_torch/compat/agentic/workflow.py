"""The reference ``agentic.workflow`` module on the port (``agentic/workflow.py``)."""

from ...agentic.workflow import *  # noqa: F401,F403
