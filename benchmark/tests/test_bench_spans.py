"""The readers of the system's own spans and counters, on a synthetic
Chrome trace: ``lsps.*`` ranges on the main thread, work launched inside
and outside them (a launch from a second thread too, as autograd's
backward launches), a range on a second thread; the loader's counters
from the loaded module."""

import sys
import types

import pytest

from harness import spans
from harness.manifest import Manifest
from harness.trace import Trace
from test_bench_manifest import ROOT

MAIN, OTHER = 1, 2
UNITS = 2
STEP = 100.0                # us between the steps' host ranges
DEVICE_LAG = 300.0          # us from a launch to its device work

# a step's ranges on the main thread: (name, start, end) in us
TRAIN_RANGES = [("lsps.augment", 10, 20), ("lsps.dis", 20, 60),
                ("lsps.backward", 30, 40), ("lsps.optim", 40, 58),
                ("lsps.gen", 60, 100), ("lsps.backward", 70, 80),
                ("lsps.optim", 80, 98)]
# a step's launches: (host ts, thread, category, device us)
TRAIN_WORK = [(5, MAIN, "kernel", 13.0),          # outside every span
              (15, MAIN, "gpu_memcpy", 2.0), (16, MAIN, "kernel", 3.0),
              (25, MAIN, "kernel", 5.0), (35, OTHER, "kernel", 7.0),
              (45, MAIN, "kernel", 1.0), (46, MAIN, "kernel", 1.0),
              (65, MAIN, "kernel", 11.0),
              (85, MAIN, "kernel", 1.0), (86, MAIN, "kernel", 1.0),
              (87, MAIN, "kernel", 1.0), (88, MAIN, "gpu_memset", 0.5)]

SERVE_RANGES = [("lsps.predict", 10, 90), ("lsps.h2d", 12, 20),
                ("lsps.detect", 20, 60), ("lsps.crop", 60, 62),
                ("lsps.regress", 62, 80), ("lsps.decode", 80, 88)]
SERVE_WORK = [(15, MAIN, "gpu_memcpy", 4.0), (30, MAIN, "kernel", 9.0)]


def _events(ranges, work, units=UNITS, extra=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0.0, "dur": 1000.0, "tid": MAIN}]
    corr = 0
    for k in range(units):
        o = k * STEP
        for name, lo, hi in ranges:
            ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": o + lo, "dur": hi - lo, "tid": MAIN})
        for ts, tid, cat, dur in work:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": o + ts, "dur": 0.5,
                       "tid": tid, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": cat, "name": f"{cat} {corr}",
                       "ts": o + ts + DEVICE_LAG, "dur": dur, "tid": 7,
                       "args": {"correlation": corr}})
    return ev + list(extra)


def _out(trace, units=UNITS):
    return types.SimpleNamespace(trace=trace,
                                 facts={"profiled_units": units})


# a second thread's range over the dis span's launches, which no reader of
# the trainer's spans reads
SECOND_THREAD = [{"ph": "X", "cat": "user_annotation",
                  "name": "lsps.loader_wait", "ts": 22.0, "dur": 30.0,
                  "tid": OTHER}]


@pytest.fixture
def train():
    return _out(Trace(_events(TRAIN_RANGES, TRAIN_WORK,
                              extra=SECOND_THREAD)))


@pytest.fixture
def serve():
    return _out(Trace(_events(SERVE_RANGES, SERVE_WORK)))


def _read(name, out):
    return Manifest(ROOT).reader(name).read(out)


@pytest.mark.parametrize("name,want", [
    ("augment_device_ms.train", (2.0 + 3.0) * 1e-3),
    ("dis_device_ms.train", (5.0 + 7.0 + 1.0 + 1.0) * 1e-3),
    ("gen_device_ms.train", (11.0 + 3 * 1.0 + 0.5) * 1e-3),
    ("optim_device_ms.train", (5 * 1.0 + 0.5) * 1e-3),
    ("optim_host_ms.train", (18.0 + 18.0) * 1e-3),
    ("optim_kernels.train", 5.0),
])
def test_trainer_readers(train, name, want):
    assert _read(name, train) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("detect_host_ms.track", 0.040),
    ("regress_host_ms.track", 0.018),
    ("h2d_host_ms.label", 0.008),
    ("h2d_host_ms.raw", 0.008),
    ("predict_host_ms.label", 0.080),
])
def test_estimator_readers(serve, name, want):
    assert _read(name, serve) == pytest.approx(want)


NEW = ["augment_device_ms.train", "dis_device_ms.train",
       "gen_device_ms.train", "optim_device_ms.train",
       "optim_host_ms.train", "optim_kernels.train",
       "loader_busy_ms.train", "loader_stall_pct.train",
       "detect_host_ms.track", "regress_host_ms.track",
       "h2d_host_ms.label", "predict_host_ms.label", "h2d_host_ms.raw"]


@pytest.mark.parametrize("name", NEW)
def test_without_a_trace_or_a_span_nothing_is_read(name, monkeypatch):
    # a system with neither spans nor loader counters
    monkeypatch.setitem(sys.modules, spans.LOADER_MODULE,
                        types.SimpleNamespace(DataLoader=type("D", (), {})))
    bare = Trace(_events([], TRAIN_WORK))
    assert _read(name, _out(None)) is None
    assert _read(name, _out(bare)) is None


def test_loader_readers(train, monkeypatch):
    loader = types.SimpleNamespace(batches=40, stalls=3, busy_s=0.004)
    monkeypatch.setitem(sys.modules, spans.LOADER_MODULE,
                        types.SimpleNamespace(DataLoader=loader))
    assert _read("loader_busy_ms.train", train) == pytest.approx(0.1)
    assert _read("loader_stall_pct.train", train) == pytest.approx(7.5)
    loader.batches = 0
    assert _read("loader_busy_ms.train", train) is None
    assert _read("loader_stall_pct.train", train) is None


def test_every_new_metric_is_in_the_manifest():
    """Each reader is named by one cell's metric, but the track cell's,
    kept for a tracking cell to come back as data."""
    per_layer = {m["name"]: m for m in Manifest(ROOT).data["per_layer"]}
    for name in NEW:
        if name.endswith(".track"):
            assert name not in per_layer
        else:
            assert len(per_layer[name]["workloads"]) == 1


def test_the_idle_gaps_name_the_innermost_span():
    """A gap that opens while the host is inside ``lsps.optim`` (inside
    ``lsps.dis``) is charged to ``lsps.optim``."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0.0, "dur": 100.0, "tid": MAIN},
          {"ph": "X", "cat": "user_annotation", "name": "lsps.dis",
           "ts": 0.0, "dur": 100.0, "tid": MAIN},
          {"ph": "X", "cat": "user_annotation", "name": "lsps.optim",
           "ts": 40.0, "dur": 60.0, "tid": MAIN},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 50.0,
           "tid": 7, "args": {}}]
    assert Trace(ev).idle_gaps()[0][0] == "lsps.optim"
