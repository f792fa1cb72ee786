"""The crop kernel's (``csrc/warp.cu``) roofline bound for the profiled
calls' crops over its mean device time per launch, in %."""

from harness import readers


def read(out):
    return readers.crop_roofline_pct(out)
