"""Device ms per call of the host-to-device copies (the frames, CoMs and
cubes going in)."""

from harness import readers


def read(out):
    return readers.h2d_ms_per_unit(out)
