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


def serve_devices(n: "int | None" = None,
                  device: "torch.device | str | None" = None
                  ) -> "list[torch.device]":
    """The devices of ``n`` serving engines: round-robin over the visible
    devices of ``device``'s type (``cuda:0``, ``cuda:1``, ... back to
    ``cuda:0``; the CPU's one device for ``cpu``, or the one device an
    index names); ``n=None`` means one engine per visible device. The
    counterpart of the JAX package's ``parallel.mesh.serve_devices``,
    which gives one engine per data-axis device and refuses more
    engines than devices: here engines beyond the device count share a
    device, so N engines on one H100 share ``cuda:0``, each with its own
    stream, graphs, buffers and policy copy."""
    dev = resolve_device(device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" and dev.index is None else [dev])
    if n is None:
        n = len(visible)
    if n < 1:
        raise ValueError(f"n_engines={n} must be >= 1")
    return [visible[i % len(visible)] for i in range(n)]
