"""Hand-written CUDA kernels of the port: one ``csrc/<name>.cu`` each,
built by ``build.py`` on first use, with a Python wrapper and a plain
PyTorch version in ``<name>.py``."""

SOURCES = ("warp", "norm_act")
