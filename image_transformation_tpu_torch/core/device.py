"""Explicit device selection for the port.

The entry point names the device (``--device cuda`` by default) and every
tensor-producing function takes it as an argument. Nothing falls back to
the CPU on its own: asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError when a CUDA device is asked for and none is
    available, and ValueError for any other device type."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain versions on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return device
