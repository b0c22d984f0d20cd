"""Device resolution for every entry point of the port.

The port runs on the card: ``device=None`` means ``cuda``. A caller who
wants the CPU (the parity tests, a laptop) says so with ``device="cpu"``.
Asking for ``cuda`` where there is none raises; nothing falls back to
the CPU behind the caller's back, because a CPU number reported as a
card number is worse than no number."""
from __future__ import annotations

import torch


def resolve_device(device: "torch.device | str | None" = None
                   ) -> torch.device:
    """``torch.device`` for ``device`` (``None`` -> ``cuda``); raises
    ``RuntimeError`` if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the port's default) but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU")
    return dev
