"""Kernels a step launched inside ``lsps.optim``: both updates' gradient
casts and Adam steps."""

from harness import spans


def read(out):
    return spans.kernels_per_unit(out, "optim")
