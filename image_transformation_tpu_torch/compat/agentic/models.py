"""The reference ``agentic.models`` module on the port (``agentic/models.py``)."""

from ...agentic.models import *  # noqa: F401,F403
