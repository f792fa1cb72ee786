"""The median frame latency of the window, from due time to joints on the
host, in ms."""

from harness import readers


def read(out):
    return readers.median_ms(out, "latency")
