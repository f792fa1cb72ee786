"""Host ms a call inside ``lsps.predict``: the estimator's whole call up
to its return, the joints still on the device."""

from harness import spans


def read(out):
    return spans.host_ms_mean(out, "predict")
