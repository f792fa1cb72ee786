"""Matmul and conv FLOPs of one call (regress and decode, counted on the
meta device) over the median frame latency on the host clock and the
TF32 dense peak, in %."""

from harness import readers


def read(out):
    return readers.mfu_pct(out)
