# Copy of image_transformation_tpu/agentic/models.py (host-only; the port's vlm client).
"""Chat-model wrapper for agentic nodes (tool-calling that works).

The reference's NebiusChatModel forwards tools into an api_client that
silently drops them, so the micro agent's tool loop can never fire
(the reference's agentic/models.py:26-48 vs api_client.py:120-221 —
SURVEY.md §2.6.2). Here the vlm client actually sends ``tools`` and
normalizes ``tool_calls``, so ``invoke`` returns them for real.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

from ..vlm.client import get_api_client


class ChatModel:
    """Minimal Runnable-like interface: invoke({messages, tools, tool_choice})."""

    def __init__(
        self,
        api_type: str = "auto",
        api_key: Optional[str] = None,
        temperature: float = 0.7,
        model: Optional[str] = None,
    ):
        self.api_type = api_type
        self.api_key = api_key
        self.temperature = temperature
        self.model = model

    def invoke(self, payload: Dict) -> SimpleNamespace:
        client = get_api_client(self.api_type, api_key=self.api_key)
        response = client.chat_completion(
            messages=payload["messages"],
            model=self.model,
            temperature=self.temperature,
            tools=payload.get("tools"),
            tool_choice=payload.get("tool_choice"),
        )
        message = response.get("message", {})
        return SimpleNamespace(
            content=message.get("content", ""),
            tool_calls=message.get("tool_calls", []),
        )


def create_chat_model(
    api_type: str, api_key: Optional[str], temperature: float, model: Optional[str] = None
) -> ChatModel:
    return ChatModel(api_type, api_key, temperature, model)
