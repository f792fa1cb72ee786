"""The port's spans and the loader's counters, on the CPU.

``utils.logging.span`` opens a ``lsps.<name>`` range only while a torch
profiler records: the estimator's and the trainer's calls emit their
spans, nested as the code nests them, under ``torch.profiler.profile``;
without one every span is the one shared no-op; a profiler changes no
result and no exported graph.  ``DataLoader.batches``, ``.stalls`` and
``.busy_s`` count every loader's batches, the consumer's waits on an empty
queue and the producer's seconds in the dataset.
"""

import contextlib
import copy
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lsps_tpu_torch.config import default_hyperparameters
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.loader import DataLoader
from lsps_tpu_torch.serve.inference import FramesProgram, PoseEstimator
from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.train.trainer import fresh_state_dict
from lsps_tpu_torch.utils.logging import span

torch.set_num_threads(1)

HYP = default_hyperparameters(reg_dim=42, small=True)
HYP["gen"]["ch"] = HYP["dis"]["ch"] = 4
HYP["map"]["output_ch"] = 4 * 2 ** (HYP["gen"]["n_enc_front_blk"] - 1)
B = 2
SERVE_SPANS = ["lsps.h2d", "lsps.detect", "lsps.crop", "lsps.regress",
               "lsps.decode"]


def _ranges(prof):
    """(name, start us, end us, thread) of the ``lsps.*`` ranges."""
    return sorted((e.name, e.time_range.start, e.time_range.end,
                   e.thread) for e in prof.events()
                  if e.name.startswith("lsps."))


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


@pytest.fixture(scope="module")
def estimator():
    sd = {k: v for k, v in fresh_state_dict(HYP, 3).items()
          if k.split(".")[0] in ("dis", "vae")}
    return PoseEstimator(HYP, sd, camera=Camera.icvl(), device="cpu")


def _frames(seed=0):
    """Two 320 x 240 uint16 frames, each with a disc of a hand's depth
    in front of a far wall."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:240, :320]
    frames = np.full((B, 240, 320), 2000, np.uint16)
    for i in range(B):
        cy, cx = rs.randint(90, 150), rs.randint(120, 200)
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < 30 ** 2
        frames[i][disc] = 500 + 40 * i
    return frames


def test_predict_raw_emits_its_spans_in_order(estimator):
    frames = _frames()
    cubes = np.full((B, 3), 250.0, np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        estimator.predict_raw(frames, cubes)
    ranges = _ranges(prof)
    predict = [r for r in ranges if r[0] == "lsps.predict"]
    assert len(predict) == 1
    inner = sorted((r for r in ranges if r[0] != "lsps.predict"),
                   key=lambda r: r[1])
    assert [r[0] for r in inner] == SERVE_SPANS
    assert all(_inside(r, predict[0]) for r in inner)
    # one after another, none inside another
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def _raw_batch(k):
    """Raw tuples of both domains (FastAugmenter.raw_batch's layout) and
    their labels."""
    rs = np.random.RandomState(100 + k)
    out = []
    for _ in range(2):
        ang = rs.uniform(-np.pi, np.pi, B)
        minv = np.tile(np.eye(3), (B, 1, 1))
        c, s = np.cos(ang), np.sin(ang)
        minv[:, 0, 0], minv[:, 0, 1] = c, s
        minv[:, 1, 0], minv[:, 1, 1] = -s, c
        minv[:, :2, 2] = 64 - 64 * (minv[:, :2, 0] + minv[:, :2, 1])
        com_z = rs.uniform(650, 850, B).astype(np.float32)
        cube_z = np.full(B, 300.0, np.float32)
        src = np.round(rs.uniform(com_z[:, None, None] - 140,
                                  com_z[:, None, None] + 140,
                                  (B, 128, 128))).astype(np.float32)
        out += [(src, minv, com_z, cube_z, com_z + 150, com_z - 150,
                 com_z + 150), rs.uniform(-0.3, 0.3, (B, 42))]
    return out


def _trainer():
    return LSPSTrainer(copy.deepcopy(HYP), fresh_state_dict(HYP, 5),
                       device="cpu", seed=9)


def test_pretrain_update_raw_emits_its_spans():
    trainer = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.pretrain_update_raw(*_raw_batch(0), with_viz=False)
    ranges = _ranges(prof)
    by = {}
    for r in ranges:
        by.setdefault(r[0], []).append(r)
    assert sorted(by) == ["lsps.augment", "lsps.backward", "lsps.dis",
                          "lsps.gen", "lsps.optim"]
    (aug,), (dis,), (gen,) = (by["lsps.augment"], by["lsps.dis"],
                              by["lsps.gen"])
    assert aug[2] <= dis[1] and dis[2] <= gen[1]
    for update in (dis, gen):
        (bwd,) = [r for r in by["lsps.backward"] if _inside(r, update)]
        (opt,) = [r for r in by["lsps.optim"] if _inside(r, update)]
        assert bwd[2] <= opt[1]
    assert len(by["lsps.backward"]) == len(by["lsps.optim"]) == 2


def test_without_a_profiler_every_span_is_the_shared_no_op(monkeypatch):
    assert span("a") is span("b")
    with span("a") as inner:
        assert inner is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("a") is not span("b")
        # while torch.export or torch.compile traces the program
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert span("a") is span("b")
    assert span("a") is span("b")


def test_a_profiler_changes_no_result(estimator):
    frames = _frames(1)
    cubes = np.full((B, 3), 250.0, np.float32)
    plain = estimator.predict_raw(frames, cubes, return_coms=True)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = estimator.predict_raw(frames, cubes, return_coms=True)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)

    losses = []
    for prof in (False, True):
        trainer = _trainer()
        with (profile(activities=[ProfilerActivity.CPU]) if prof
              else contextlib.nullcontext()):
            met, _ = trainer.pretrain_update_raw(*_raw_batch(1),
                                                 with_viz=False)
        losses.append({k: float(v) for k, v in met.items()})
        losses.append([p.detach().clone() for p in trainer.gen.parameters()])
    assert losses[0] == losses[2]
    assert all(torch.equal(a, b) for a, b in zip(losses[1], losses[3]))


def test_an_export_under_a_profiler_holds_no_span(estimator):
    program = FramesProgram(estimator.dis, estimator.vae, Camera.icvl())
    args = (torch.from_numpy(_frames(2).astype(np.float32)),
            torch.tensor([[160.0, 120.0, 500.0], [150.0, 110.0, 540.0]]),
            torch.full((B, 3), 250.0))
    plain = torch.export.export(program, args)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = torch.export.export(program, args)
    assert str(traced.graph) == str(plain.graph)
    assert "record_function" not in str(traced.graph)


class _Slow:
    """A dataset whose batches take ``delay`` seconds to make."""

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        return np.full(3, i, np.float32)


def _counts():
    return DataLoader.batches, DataLoader.stalls, DataLoader.busy_s


def test_a_slow_dataset_stalls_on_every_batch():
    loader = DataLoader(_Slow(6, 0.02), 2, shuffle=False)
    b0, s0, t0 = _counts()
    got = [b for b in loader]
    b1, s1, t1 = _counts()
    assert len(got) == 3
    assert b1 - b0 == 3 and s1 - s0 == 3
    assert t1 - t0 >= 3 * 2 * 0.02 * 0.9


def test_a_fast_dataset_under_a_slow_consumer_stalls_once_an_epoch():
    loader = DataLoader(_Slow(16, 0.0), 2, shuffle=True, seed=1)
    b0, s0, t0 = _counts()
    for _ in range(2):
        for _ in loader:
            time.sleep(0.01)
    b1, s1, t1 = _counts()
    assert b1 - b0 == 16
    assert s1 - s0 <= 2
    assert t1 > t0


def test_a_wait_on_the_empty_queue_is_a_span_of_the_consumer():
    loader = DataLoader(_Slow(4, 0.02), 2, shuffle=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("consumer"):
            got = list(loader)
    ranges = _ranges(prof)
    waits = [r for r in ranges if r[0] == "lsps.loader_wait"]
    (consumer,) = [r for r in ranges if r[0] == "lsps.consumer"]
    assert len(got) == 2 and len(waits) == 2
    assert all(r[3] == consumer[3] for r in waits)
