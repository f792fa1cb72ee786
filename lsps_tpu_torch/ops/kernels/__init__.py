"""Hand-written CUDA kernels of the port: one ``csrc/<name>.cu`` each,
built by ``build.py`` on first use, with a Python wrapper and a plain
PyTorch version in ``<name>.py`` (detection's in ``serve/detect.py``)."""

SOURCES = ("warp", "norm_act", "detect")
