"""Device ms a step of the work launched inside ``lsps.optim``: both
updates' gradient casts and Adam steps."""

from harness import spans


def read(out):
    return spans.device_ms_per_unit(out, "optim")
