"""Device resolution: the card unless the caller asks for the CPU.

Nothing in the port falls back to the CPU on its own. ``resolve_device``
is called by every entry point, so a missing card surfaces as an error at
construction time instead of as a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"`` or ``"cpu"`` as a torch.device.

    Raises RuntimeError for a CUDA device when no card is present, and
    ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device={str(device)!r}: want 'cuda' or 'cpu'")
