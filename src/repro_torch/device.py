"""Device selection for every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (every entry point's default) raises when no card is
    present: the port never carries on quietly on the CPU.  Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
