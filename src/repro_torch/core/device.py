"""Where the port's tensors live.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``torch.device("cuda")``, and with no CUDA device
that raises instead of carrying on somewhere else.  Tests pass
``device="cpu"`` (or ``devices=[torch.device("cpu")] * p``) explicitly.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes a device explicitly (device='cpu')")
    return torch.device("cuda")
