"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the system under test."""

import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{imports}
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "lsps_tpu", "lsps_tpu_torch"}}))
"""


def loaded(imports):
    code = PROBE.format(bench=str(BENCH_DIR), root=str(ROOT),
                        imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_neither_jax_nor_the_system():
    assert loaded("import reference.nets, reference.train_step, "
                  "reference.serve") == "[]"


def test_harness_loads_no_jax():
    imports = ("import harness.context, harness.manifest, harness.readers, "
               "harness.scenes, harness.trace, harness.weights, "
               "harness.yardstick\n"
               "from harness.manifest import Manifest\n"
               "m = Manifest(__import__('pathlib').Path({root!r}))\n"
               "[m.entry(m.workload(w['name'])['entry']) "
               "for w in m.data['workloads']]\n"
               "[m.reader(x['name']) for x in m.data['per_layer']]\n"
               "import lsps_tpu_torch.train, lsps_tpu_torch.serve.inference, "
               "lsps_tpu_torch.data.loader").format(root=str(ROOT))
    assert loaded(imports) == "['lsps_tpu_torch']"


def test_a_rehearsal_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "nicvl.label-b256", "--seed", str(2 ** 31 + 11), "--seconds", "1",
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]


def test_without_the_system_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files:
    the run exits non-zero and prints no result."""
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "nicvl.label-b256", "--seed", "1", "--seconds", "1", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
