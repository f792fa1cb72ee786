"""Host ms a call inside ``lsps.regress``: the regressor's conv trunk,
launched from the host."""

from harness import spans


def read(out):
    return spans.host_ms_mean(out, "regress")
