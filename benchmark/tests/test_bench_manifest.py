"""The manifest and every file it names: found by name, within the
contract's names, units and links, and open to new files without edits."""

import json
import shutil
from pathlib import Path

import pytest
import yaml

from harness.manifest import NAME, UNIT, Manifest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture
def manifest():
    return Manifest(ROOT)


def test_manifest_keys_and_files(manifest):
    d = manifest.data
    assert set(d) == TOP_KEYS
    assert d["paths"] == ["benchmark"]
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= d["run_seconds"] <= 51
    assert manifest.problems() == []
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_have_only_their_keys(manifest, kind):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[kind]
    for e in manifest.data[kind]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")


def test_bounds_and_sources(manifest):
    for m in manifest.data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in manifest.data["end_to_end"])
    for m in manifest.data["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(manifest):
    for w in manifest.data["workloads"]:
        e2e = [m["name"] for m in manifest.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.per_layer(w["name"]), w["name"]
        assert w["chips"] in (1, 4)
        assert manifest.entry(manifest.workload(w["name"])["entry"])
        limits = manifest.workload(w["name"])["limits"]
        assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("name", ["nnyu", "nicvl"])
def test_configs_hold_the_published_widths(manifest, name):
    cfg = manifest.config(name)
    assert manifest.config_entry(name)["reduced"] == []
    published = yaml.safe_load((ROOT / "exps" / f"{name}.yaml").read_text())
    assert cfg["hyperparameters"] == published["train"]["hyperparameters"]
    assert cfg["display"] == published["train"]["display"]


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    """A scratch copy of the benchmark with one cell, one configuration
    and one per-layer metric added as files and manifest entries: the
    manifest finds each by name and its checks pass."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "nnyu.json").read_text())
    cfg["name"] = "nnyu_copy"
    (bench / "configs" / "nnyu_copy.json").write_text(json.dumps(cfg))
    data["configs"].append({"name": "nnyu_copy", "source": "https://x.org",
                            "file": "benchmark/configs/nnyu_copy.json",
                            "reduced": [], "why": "a copy"})
    wl = json.loads((bench / "workloads" / "nnyu.track-raw-b1.json")
                    .read_text())
    wl["traffic"]["fps"] = 60
    (bench / "workloads" / "nnyu_copy.track-60.json").write_text(
        json.dumps(wl))
    data["workloads"].append({"name": "nnyu_copy.track-60",
                              "config": "nnyu_copy", "traffic": "track-60",
                              "chips": 1, "why": "60 fps"})
    data["end_to_end"].append({"name": "frame_p95_ms", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["nnyu_copy.track-60"]})
    (bench / "metrics" / "late_ms.track.py").write_text(
        "def read(out):\n    return 1.5\n")
    data["per_layer"].append({"name": "late_ms.track", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "serve/inference.py PoseEstimator",
                              "moves": "frame_p95_ms",
                              "workloads": ["nnyu_copy.track-60"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    m = Manifest(tmp_path, bench)
    assert m.problems() == []
    assert m.config(m.cell("nnyu_copy.track-60")["config"])["name"] == \
        "nnyu_copy"
    assert m.workload("nnyu_copy.track-60")["traffic"]["fps"] == 60
    assert [x["name"] for x in m.per_layer("nnyu_copy.track-60")] == [
        "late_ms.track"]
    assert m.reader("late_ms.track").read(None) == 1.5


def test_problems_names_a_broken_link(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["per_layer"][0]["moves"] = "frames_per_s"
    data["per_layer"][1]["name"] = "bad name"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    found = Manifest(tmp_path, bench).problems()
    assert any("does not report" in p for p in found)
    assert any("bad name" in p for p in found)
