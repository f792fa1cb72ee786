"""The profiled window, what its trace holds, and the result line's
end-to-end values."""

import types

import pytest
import torch

from harness import trace
from harness.context import quantity


def test_a_window_without_a_complete_trace_fails(tmp_path):
    """On the CPU no window holds device activity: after its tries the
    run raises instead of reading metrics from a partial trace."""
    host = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None,
                                   _sleep=lambda cycles: None))
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


def event(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def lead_in_window():
    """A window (ts 100-200) opened by lead-in spin kernels, one of them
    recorded inside it: two kernels and a copy launched, one launch
    without a device record, and a synchronize that is owed none."""
    spin = trace.LEAD_IN_KERNEL
    ev = [event("user_annotation", trace.WINDOW, 100, 100)]
    for i in range(3):
        ev += [event("cuda_runtime", "cudaLaunchKernel", 90 + i, 1, 900 + i),
               event("kernel", f"void {spin}(long)", 95 + 2 * i, 1, 900 + i)]
    ev += [event("cuda_runtime", "cudaLaunchKernel", 99, 1, 903),
           event("kernel", f"void {spin}(long)", 101, 2, 903),
           event("cuda_runtime", "cudaLaunchKernel", 110, 2, 1),
           event("kernel", "crop_kernel", 112, 10, 1),
           event("cuda_runtime", "cudaMemcpyAsync", 125, 2, 2),
           event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 127, 20, 2),
           event("cuda_runtime", "cudaLaunchKernelExC", 150, 2, 3),
           event("cuda_runtime", "cudaStreamSynchronize", 160, 5, 4),
           event("cuda_runtime", "cudaLaunchKernel", 170, 2, 5),
           event("kernel", "gemm", 172, 8, 5)]
    return ev


def test_the_lead_in_is_in_no_count():
    t = trace.Trace(lead_in_window())
    assert [n for n, *_ in t.kernels()] == ["crop_kernel", "gemm"]
    assert t.busy_s == pytest.approx((10 + 20 + 8) * 1e-6)
    assert all(trace.LEAD_IN_KERNEL not in n for n, _ in t.top_ops())
    assert t.launches == 4 and t.unrecorded == 1


def test_a_window_whose_launches_all_have_records():
    ev = [e for e in lead_in_window() if e.get("args", {}).get(
        "correlation") != 3]
    t = trace.Trace(ev)
    assert t.launches == 3 and t.unrecorded == 0
