"""The reference api_client surface on the port.

Counterpart of the root ``api_client.py``: the same names, signatures,
message protocol and response shape (``vlm.client``, host code), with the
tool-calling forward and the hermetic fakes of ``register_fake_client``.
"""

from ..vlm.client import (  # noqa: F401
    APIClient,
    FakeClient,
    NEBIUS_DEFAULT_TEXT,
    NEBIUS_DEFAULT_VLM,
    OLLAMA_DEFAULT_TEXT,
    OLLAMA_DEFAULT_VLM,
    OPENAI_AVAILABLE,
    OLLAMA_AVAILABLE,
    get_api_client,
    register_fake_client,
)
