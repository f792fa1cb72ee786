"""Layers and hand-written kernels of the port."""
