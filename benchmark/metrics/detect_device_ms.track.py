"""Device ms per call of the kernels that ``RawProgram`` launches before
it hands over to ``FramesProgram`` (on-card detection)."""

from harness import readers


def read(out):
    return readers.launched_ms_per_unit(out, "bench.detect")
