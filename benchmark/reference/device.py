"""The port's one device rule: every entry point, library function or CLI,
runs on the card unless the caller names the CPU, and a request for the card
on a machine without one raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """The requested device; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            f"(pass device=\"cpu\" / --device cpu to run on the CPU)")
    return dev
