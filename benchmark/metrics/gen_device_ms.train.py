"""Device ms a step of the work launched inside ``lsps.gen``: the
generator update's forward, losses, backward and Adam step."""

from harness import spans


def read(out):
    return spans.device_ms_per_unit(out, "gen")
