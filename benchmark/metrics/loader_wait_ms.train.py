"""The host's wait in ``next()`` on the two training loaders, mean ms per
iteration of the window (the harness's own span)."""

from harness import readers


def read(out):
    return readers.mean_ms(out, "loader_wait")
