"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the device-decides dispatch (see ``dispatch.py`` and ``build.py``)."""
