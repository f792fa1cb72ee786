"""Cross-topology resume of the port: a snapshot saved at 2 ranks resumes
in 1 process, and one saved in 1 process resumes at 2 ranks.

Counterpart of ``test_cross_topology_resume.py``.  The snapshots are
topology-free: the ``.npz`` sets and ``FullStateStore`` hold whole host
tensors, written by rank 0 alone; every rank reads them.  These tests pin
it with values: the step after a resume on the other topology has the
metrics of the uninterrupted run's third step (float64, the draws
injected global-shaped, within 1e-10 relative: the ranks' block means
against one mean).  The ranks are worker subprocesses under gloo
(``torch_dist.run_ranks``); one launch runs the two-rank side of both
directions.  Then the product path: ``depth_train --mesh-data 2`` saves,
a single-process ``--resume 1`` goes on from it, and the reverse.
"""

import os

import numpy as np
import pytest
import torch

import lsps_tpu_torch.cli.depth_train as depth_train
from helpers import make_synth_cfg, read_metrics
from lsps_tpu_torch.train.trainer import fresh_state_dict
from torch_dist import check_ranks, run_ranks
from torch_dp_worker import run_case
from torch_lockstep import REG, hyp

torch.set_num_threads(1)

RTOL = 1e-10
B = 4  # two rows a rank
LATENT = (32, 32, 16)  # the tiny generator's shared code, NHWC


def _step(k):
    rs = np.random.RandomState(7000 + k)
    images = (rs.uniform(-1, 1, (B, 128, 128, 1)),
              rs.uniform(-0.3, 0.3, (B, REG)),
              rs.uniform(-1, 1, (B, 128, 128, 1)),
              rs.uniform(-0.3, 0.3, (B, REG)))
    g = torch.Generator().manual_seed(7100 + k)

    def n(rows):
        return torch.randn((rows, *LATENT), generator=g, dtype=torch.float64)

    noise = {"dis": {"gen": n(2 * B)},
             "gen": {"gen": n(2 * B), "a2b": n(B), "b2a": n(B)}}
    return ("pretrain_update", images, {"noise": noise})


def _state_dicts():
    """The run's weights, and a fresh template that a resume overlays
    (other gen/dis/map weights; the VAE, which pretrain does not train,
    the run's)."""
    h = hyp()
    sd = {k: v.double() for k, v in fresh_state_dict(h, 21).items()}
    fresh = {k: (v if k.startswith("vae.") else w.double())
             for (k, v), w in zip(sd.items(),
                                  fresh_state_dict(h, 99).values())}
    return h, sd, fresh


def _saving_run(h, sd, tmp):
    """Two steps, the .npz set and the full state after them, a third."""
    return {"hyp": h, "state_dict": sd, "seed": 5, "actions": [
        _step(0), _step(1),
        ("save", (str(tmp / "npz" / "pre"), 1), {}),
        ("store_save", (str(tmp / "full"), 2), {}),
        _step(2)]}


def _resumed_runs(h, fresh, tmp):
    return {
        "npz": {"hyp": h, "state_dict": fresh, "seed": 5, "actions": [
            ("resume", (str(tmp / "npz" / "pre"),), {"load_opt": True}),
            _step(2)]},
        "full": {"hyp": h, "state_dict": fresh, "seed": 5, "actions": [
            ("store_restore", (str(tmp / "full"),), {}), _step(2)]},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    h, sd, fresh = _state_dicts()
    one = tmp_path_factory.mktemp("saved_by_1")
    two = tmp_path_factory.mktemp("saved_by_2")
    for d in (one, two):
        (d / "npz").mkdir()
    single = run_case(_saving_run(h, sd, one))
    spec = {"save": _saving_run(h, sd, two),
            **{f"resume_{k}": c
               for k, c in _resumed_runs(h, fresh, one).items()}}
    torch.save(spec, two / "spec.pt")
    check_ranks(run_ranks(["tests/torch_dp_worker.py", str(two / "spec.pt"),
                           str(two)], timeout=150))
    ranks = [torch.load(two / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return h, fresh, one, two, single, ranks


def _close(got, want, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=1e-12,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("store", ["npz", "full"])
def test_saved_at_two_ranks_resumes_in_one_process(runs, store):
    h, fresh, _, two, _, ranks = runs
    uninterrupted = ranks[0]["save"]["actions"][-1]["metrics"]
    assert [a["digest"] for a in ranks[0]["save"]["actions"]] == \
        [a["digest"] for a in ranks[1]["save"]["actions"]]
    resumed = run_case(_resumed_runs(h, fresh, two)[store])
    _close(resumed["actions"][-1]["metrics"], uninterrupted,
           f"2 ranks -> 1 process, {store}")


@pytest.mark.parametrize("store", ["npz", "full"])
def test_saved_in_one_process_resumes_at_two_ranks(runs, store):
    _, _, _, _, single, ranks = runs
    uninterrupted = single["actions"][-1]["metrics"]
    got = [r[f"resume_{store}"]["actions"] for r in ranks]
    assert [a["digest"] for a in got[0]] == [a["digest"] for a in got[1]]
    _close(got[0][-1]["metrics"], uninterrupted,
           f"1 process -> 2 ranks, {store}")


def test_cli_cross_topology_resume(tmp_path):
    """The product path: pretrain --mesh-data 2 saves a snapshot at 2, and
    a single-process --resume 1 runs steps 3-4 from it; then a snapshot
    of one process resumed at two ranks."""
    cfg = make_synth_cfg(tmp_path, "xt", ch=4, n_frames=10,
                         snapshot_iters=2, image_iters=100)
    out = tmp_path / "xt"
    base = ["--config", cfg, "--mode", "pretrain", "--batch-size", "4",
            "--device", "cpu"]
    check_ranks(run_ranks(["-m", "lsps_tpu_torch.cli.depth_train", *base,
                           "--log", str(tmp_path / "logs2"),
                           "--max-iterations", "2", "--mesh-data", "2"],
                          timeout=150))
    assert any(f.startswith("pre_gen_00000002") for f in os.listdir(out))
    log1 = str(tmp_path / "logs_res1")
    depth_train.main([*base, "--resume", "1", "--log", log1,
                      "--max-iterations", "4"])
    assert [r["step"] for r in read_metrics(log1, cfg)] == [3, 4]
    # the single process's own snapshot at 4, resumed at two ranks
    log2 = str(tmp_path / "logs_res2")
    check_ranks(run_ranks(["-m", "lsps_tpu_torch.cli.depth_train", *base,
                           "--resume", "1", "--log", log2,
                           "--max-iterations", "6", "--mesh-data", "2"],
                          timeout=150))
    recs = read_metrics(log2, cfg)
    assert [r["step"] for r in recs] == [5, 6]
    assert all(np.isfinite(r["dis_loss"]) for r in recs)
