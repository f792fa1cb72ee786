"""The plain reference at small sizes on the CPU: against itself, and
against the system's plain CPU path, which computes the same function."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import scenes, weights
from reference import nets, serve, train_step

BENCH_DIR = Path(__file__).resolve().parents[1]


def hyp_of(name, ch=4):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    hyp = cfg["hyperparameters"]
    hyp["gen"]["ch"] = hyp["dis"]["ch"] = ch
    hyp["map"]["output_ch"] = nets.latent_ch(hyp["gen"])
    return cfg, hyp


@pytest.mark.parametrize("name", ["nnyu", "nicvl"])
def test_specs_are_the_systems_parameters(name):
    from lsps_tpu_torch.train.trainer import fresh_state_dict

    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    hyp = cfg["hyperparameters"]
    sd = fresh_state_dict(hyp, 0)
    specs = {s.key: tuple(s.shape) for s in nets.param_specs(hyp)}
    assert specs == {k: tuple(v.shape) for k, v in sd.items()}


def test_weights_follow_the_seed():
    _, hyp = hyp_of("nnyu")
    specs = nets.param_specs(hyp)
    a = weights.make(torch, specs, 5, "cpu")
    b = weights.make(torch, specs, 5, "cpu")
    c = weights.make(torch, specs, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dis.D.weight"], c["dis.D.weight"])
    w = a["gen.encode_A.0.0.weight"]
    assert abs(float(w.std()) - 0.02) < 0.005
    bias = a["dis.model_A.0.0.bias"]
    assert float(bias.abs().max()) <= 1 / 7.0
    assert weights.seed_for(2 ** 31 + 7, "x") < 2 ** 63


def test_augment_identity_is_the_chain():
    gen = torch.Generator().manual_seed(1)
    raw, _ = scenes.raw_crops(torch, gen, 6, 300.0, 108, hw=32)
    raw = (raw[0], np.tile(np.eye(3)[None], (6, 1, 1))) + raw[2:]
    got = train_step.augment(raw, "cpu")
    s = torch.from_numpy(raw[0].astype(np.float32))
    s = torch.where(s == 1, torch.from_numpy(raw[7])[:, None, None], s)
    p = [torch.from_numpy(a)[:, None, None] for a in raw[2:7]]
    assert torch.equal(got, train_step._chain(s, *p))
    assert float(got.abs().max()) <= 1.0 + 1e-6


def test_crop_matches_a_loop():
    gen = torch.Generator().manual_seed(2)
    frames, coms = scenes.still_hands(torch, gen, 2, (240, 320), 241.42,
                                      (80, 60))
    cubes = torch.full((2, 3), 250.0)
    crops = serve.crop(frames, coms, cubes, 241.42, 241.42)
    iy, ix = serve.crop_indices(coms, cubes, 241.42, 241.42, (240, 320))
    f = frames.float().numpy()
    for b in range(2):
        z, half = float(coms[b, 2]), 125.0
        for r in range(0, 128, 9):
            for c in range(0, 128, 7):
                v = (f[b, iy[b, r], ix[b, c]]
                     if iy[b, r] >= 0 and ix[b, c] >= 0 else 0.0)
                if v != 0 and v < z - half:
                    v = z - half
                if v > z + half:
                    v = 0.0
                if v == 0:
                    v = z + half
                assert abs(float(crops[b, r, c]) - (v - z) / half) < 1e-6


def test_detection_finds_every_rendered_hand():
    gen = torch.Generator().manual_seed(3)
    frames = scenes.moving_hand(torch, gen, 3, (480, 640), 588.03, 30.0)
    f2, coms = scenes.still_hands(torch, gen, 3, (480, 640), 588.03,
                                  (160, 120))
    for fr in (frames, f2):
        c = serve.detect(fr, torch.full((3, 3), 300.0), 588.03, 587.07)
        assert bool((c[:, 2] > 0).all())
    got = serve.detect(f2, torch.full((3, 3), 300.0), 588.03, 587.07)
    # the fingers above the palm pull the centroid up
    assert float((got[:, :2] - coms[:, :2]).abs().max()) < 25.0


def test_pretrain_step_is_the_systems():
    """Two iterations of the system's trainer (its CPU path) and of the
    reference, from the same weights, batches and noise."""
    from lsps_tpu_torch.train import LSPSTrainer

    _, hyp = hyp_of("nnyu")
    init = weights.make(torch, nets.param_specs(hyp), 11, "cpu")
    gen = torch.Generator().manual_seed(12)
    raws = [scenes.raw_crops(torch, gen, 2, 300.0, 108) for _ in range(4)]
    trainer = LSPSTrainer(hyp, init, device="cpu")
    ref = train_step.Pretrain(hyp, init)
    lc = nets.latent_ch(hyp["gen"])
    for step in range(2):
        (ra, la), (rb, lb) = raws[2 * step], raws[2 * step + 1]
        z = [torch.randn((n, 32, 32, lc), generator=gen)
             for n in (4, 4, 2, 2)]
        noise = {"dis": {"gen": z[0]},
                 "gen": {"gen": z[1], "a2b": z[2], "b2a": z[3]}}
        met, (_, ia, ib) = trainer.pretrain_update_raw(ra, la, rb, lb,
                                                       noise=noise)
        xa = train_step.augment(ra, "cpu")[..., None]
        xb = train_step.augment(rb, "cpu")[..., None]
        assert torch.equal(xa, ia) and torch.equal(xb, ib)
        got = ref.step(xa, xb, noise)
        for k in ("dis_loss", "gen_total_loss"):
            assert abs(float(met[k]) - float(got[k])) <= 1e-5 * abs(
                float(got[k])), k
    # conv biases that feed an InstanceNorm get gradients of round-off
    # (and weight decay) only, and move by them: left out
    g = {k: float(v.norm()) for k, v in ref.first_grads().items()}
    med = float(np.median(list(g.values())))
    for prefix, net in (("dis.", trainer.dis), ("gen.", trainer.gen)):
        for n, p in net.named_parameters():
            if g[prefix + n] < 1e-2 * med:
                continue
            r = ref.p[prefix + n].detach()
            moved = float((r - init[prefix + n]).norm())
            assert float((p.detach() - r).norm()) <= 1e-2 * max(moved,
                                                                 1e-6), n


@pytest.mark.parametrize("name,detect", [("nnyu", True), ("nicvl", False)])
def test_serving_chain_is_the_systems(name, detect):
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.serve.inference import PoseEstimator

    cfg, hyp = hyp_of(name)
    cam, hw = cfg["camera"], tuple(cfg["frame_hw"])
    params = weights.make(torch, nets.param_specs(hyp, ("dis", "vae")), 3,
                          "cpu")
    est = PoseEstimator(hyp, params, device="cpu", camera=Camera(
        cam["fx"], cam["fy"], cam["ux"], cam["uy"], flip_y=cam["flip_y"],
        depth_map_size=(hw[1], hw[0])))
    gen = torch.Generator().manual_seed(4)
    frames, coms = scenes.still_hands(torch, gen, 3, hw, cam["fx"],
                                      (hw[1] // 4, hw[0] // 4))
    cubes = torch.full((3, 3), float(cfg["cube_mm"]))
    rcam = serve.Camera(cam["fx"], cam["fy"], cam["ux"], cam["uy"],
                        cam["flip_y"])
    if detect:
        got, got_coms = est.predict_raw(frames.numpy(), cubes,
                                        return_coms=True)
        coms = serve.detect(frames, cubes, cam["fx"], cam["fy"])
        assert torch.equal(got_coms, coms)
    else:
        got = est.predict_frames(frames.numpy(), coms, cubes)
    want = serve.joints(params, hyp, rcam, frames, coms, cubes)
    assert float((got - want).abs().max()) < 1e-3


def test_flop_counts_follow_the_shapes():
    cfg, hyp = hyp_of("nnyu", ch=64)
    one, two = serve.call_flops(hyp, 1), serve.call_flops(hyp, 2)
    assert two == 2 * one
    # the first conv alone: 64 7x7 filters over a 64 x 64 output
    assert one > 2 * 64 * 49 * 64 * 64
    assert train_step.step_flops(hyp, 2) > 2 * one
