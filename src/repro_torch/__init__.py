"""PyTorch / CUDA port of the SC accelerator system for one NVIDIA H100.

``repro`` (the JAX package beside this one) is the reference; this
package reimplements its serving main path in PyTorch and carries the
paged-attention and approximate-BSN Pallas kernels as hand-written CUDA
C++ kernels for ``sm_90a`` (``repro_torch.kernels``).  The layout mirrors
``repro``'s (``core/``, ``configs/``, ``kernels/``, ``models/``,
``serving/``) so each module's counterpart is easy to find.

The package imports ``torch``, numpy and the standard library only; it
never imports ``jax`` or ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (:func:`resolve_device`), and a tensor's
device decides whether a kernel or its plain PyTorch version runs
(``kernels/dispatch.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
