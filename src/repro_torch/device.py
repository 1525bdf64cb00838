"""Where the port's entry points run: on the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" means the current card. Raises when
    the card is asked for and there is none: never a silent CPU run."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "passes device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
