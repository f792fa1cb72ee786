"""Matmul and conv FLOPs of one batch (regress and decode, counted on the
meta device) over the window's host-clock time per batch and the TF32
dense peak, in %."""

from harness import readers


def read(out):
    return readers.mfu_pct(out)
