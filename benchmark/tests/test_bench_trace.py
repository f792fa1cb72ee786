"""The profiled window and the result line's end-to-end values."""

import types

import pytest
import torch

from harness import trace
from harness.context import quantity


def test_a_window_without_a_complete_trace_fails(tmp_path):
    """On the CPU no window holds device activity: after its tries the
    run raises instead of reading metrics from a partial trace."""
    host = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    with pytest.raises(RuntimeError, match="no complete trace in 2"):
        trace.profile_window(host, lambda n: torch.ones(8).sum(), 1,
                             tmp_path / "t.json", tries=2)


def test_a_grouped_metric_reads_its_quantity():
    values = {"frames_per_s": 4614.5, "setup_s": 12.3}
    assert quantity(values, "frames_per_s") == 4614.5
    assert quantity(values, "frames_per_s.raw") == 4614.5
    assert quantity(values, "setup_s") == 12.3
    with pytest.raises(KeyError):
        quantity(values, "step_ms")
