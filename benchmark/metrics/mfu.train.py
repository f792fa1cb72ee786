"""Matmul and conv FLOPs of one pretrain iteration (the reference counted
on the meta device) over the window's host-clock time per iteration and
the H100's TF32 dense peak, in %."""

from harness import readers


def read(out):
    return readers.mfu_pct(out)
