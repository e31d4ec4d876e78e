"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device.

    The entry points (``ServeEngine``, ``init_params``, ``weights.from_jax``)
    serve on the card by default and run on the CPU only when asked with
    ``device="cpu"``; without a card and without that request they raise
    rather than quietly running the plain versions on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the host")
    return dev
