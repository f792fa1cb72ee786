"""The IN + LeakyReLU kernels' (``csrc/norm_act.cu``) roofline bound over
their device time, summed over the profiled launches, in %."""

from harness import readers


def read(out):
    return readers.norm_roofline_pct(out)
