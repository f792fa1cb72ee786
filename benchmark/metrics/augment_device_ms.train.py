"""Device ms a step of the kernels and copies launched inside the
trainer's ``lsps.augment`` span: both raw batches to the device and their
fused augment."""

from harness import spans


def read(out):
    return spans.device_ms_per_unit(out, "augment")
