"""Entry ``pretrain``: VAE-GAN pretrain iterations, as the training CLI
runs them with the augment fused into the step.

Set-up makes the weights on the device from the seed, renders a training
set of raw crops for each domain, builds the system's ``LSPSTrainer``
and its two ``DataLoader``s (shuffled, the fused-augment ``step``
batches, a prefetch thread each), and drives the trainer through its
first steps with the window's own call: a batch from each loader, the
generator's noise drawn on the device from the seed, one
``pretrain_update_raw``.  The window repeats that call for ``--seconds``,
epoch after epoch, with the CLI's display cadence (the metrics read on
the host every ``display`` iterations).  ``step_ms`` is the window over
the iterations completed in it.

After the window the trainer is freed and the plain reference follows the
first three steps from the same weights, batches and noise: the
augmented images of the first step, each step's two losses, the first
gradient of every leaf (from Adam's first moment after one step) and the
parameters' change after three steps are compared.
"""

from __future__ import annotations

import gc
import statistics
import time

from harness import scenes, weights
from harness.context import Outcome, now, tf32_off
from harness.trace import profile_window
from reference import nets, train_step

B1 = 0.5
LOSSES = ("dis_loss", "gen_total_loss")
FIRST_STEPS = 3     # the steps the reference follows


class RawSet:
    """A training set served to the system's loader as fused-augment
    batches: ``(raw tuple, labels)`` for a list of indices."""

    def __init__(self, raw, labels):
        self.raw, self.labels = raw, labels

    def __len__(self):
        return self.labels.shape[0]

    def enable_fast_augment(self, backend, device=None):
        return backend == "step"

    def raw_fast_batch(self, idxs):
        return tuple(a[idxs] for a in self.raw), self.labels[idxs]


def noise_drawer(torch, gen, batch, side, ch, device):
    def z(n):
        return torch.randn((n, side, side, ch), generator=gen, device=device)

    def draw():
        return {"dis": {"gen": z(2 * batch)},
                "gen": {"gen": z(2 * batch), "a2b": z(batch),
                        "b2a": z(batch)}}

    return draw


def leaf_norms(torch, named):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in named}


def first_grads(torch, trainer):
    """Each leaf's norm of the first gradient the optimizers took, from
    Adam's first moment after one step (mu = (1 - b1) g)."""
    named = [("dis." + n, mu) for (n, _), mu in
             zip(trainer.dis.named_parameters(), trainer.dis_opt.mu)]
    gen_names = ([("gen." + n) for n, _ in trainer.gen.named_parameters()]
                 + [("map." + n) for n, _ in trainer.map.named_parameters()])
    named += list(zip(gen_names, trainer.gen_opt.mu))
    return leaf_norms(torch, ((k, mu / (1 - B1)) for k, mu in named))


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def summary(name, gaps: dict) -> str:
    worst = max(gaps, key=gaps.get)
    return (f"{name}: worst leaf {worst} {gaps[worst]!r}, median leaf "
            f"{statistics.median(gaps.values())!r}")


def run(ctx) -> Outcome:
    torch, dev = ctx.torch, ctx.device
    tr, hyp = ctx.traffic, ctx.hyp
    b = tr["batch"]
    if ctx.variant == "control":
        prog_hyp = dict(hyp, compute_dtype="bfloat16")
    else:
        prog_hyp = hyp

    from lsps_tpu_torch.data.loader import DataLoader
    from lsps_tpu_torch.train import LSPSTrainer

    ctx.mark("imports")
    sd = weights.make(torch, nets.param_specs(hyp), ctx.seed_for("weights"),
                      dev)
    init = {k: v.cpu() for k, v in sd.items()}
    n_pool = tr["pool_batches"] * b
    gen = torch.Generator(device=dev)
    sets = []
    for dom in "ab":
        gen.manual_seed(ctx.seed_for(f"crops {dom}"))
        sets.append(RawSet(*scenes.raw_crops(
            torch, gen, n_pool, ctx.config["cube_mm"],
            hyp["vae"]["input_dim"])))
    ctx.mark("weights and crops")
    trainer = LSPSTrainer(prog_hyp, sd, device=dev,
                          seed=ctx.seed_for("trainer") % 2 ** 31)
    del sd
    if ctx.variant:
        plant(ctx.variant, trainer)
    loaders = [DataLoader(s, b, shuffle=True,
                          seed=ctx.seed_for(f"shuffle {i}") % 2 ** 32,
                          fast=True, fast_backend="step", device=dev)
               for i, s in enumerate(sets)]
    noise_gen = torch.Generator(device=dev).manual_seed(
        ctx.seed_for("noise"))
    noise_state = noise_gen.get_state()
    side = 128 // 2 ** (hyp["gen"]["n_enc_front_blk"] - 1)
    draw = noise_drawer(torch, noise_gen, b, side,
                        nets.latent_ch(hyp["gen"]), dev)

    def batches():
        while True:
            for ba, bb in zip(iter(loaders[0]), iter(loaders[1])):
                yield ba, bb

    stream = batches()
    waits = []

    def iteration():
        t = time.perf_counter()
        with ctx.span("loader"):
            (raw_a, la), (raw_b, lb) = next(stream)
        waits.append(time.perf_counter() - t)
        with ctx.span("step"):
            met, outs = trainer.pretrain_update_raw(raw_a, la, raw_b, lb,
                                                    noise=draw())
        return (raw_a, raw_b), met, outs

    ctx.mark("trainer and loaders")
    # the first steps, which the reference follows
    first, losses = [], []
    for i in range(FIRST_STEPS):
        raws, met, outs = iteration()
        first.append(raws)
        losses.append({k: float(met[k]) for k in LOSSES})
        if i == 0:
            images = [o.detach().cpu() for o in outs[1:]]
            grads = first_grads(torch, trainer)
    with torch.no_grad():
        change = {}
        for prefix, net in (("dis.", trainer.dis), ("gen.", trainer.gen),
                            ("map.", trainer.map)):
            for n, p in net.named_parameters():
                change[prefix + n] = float(torch.linalg.vector_norm(
                    (p.detach() - init[prefix + n].to(dev)).double()))
    ctx.synchronize()
    ctx.mark("first steps")
    setup_s = now() - ctx.t_start
    ctx.open_window()

    # the window
    display = ctx.config["display"]
    waits.clear()
    trace, prof_units = None, 0
    t0 = now()
    n = 0

    def run_units(k):
        nonlocal n
        for _ in range(k):
            _, met, _ = iteration()
            n += 1
            if n % display == 0:   # the CLI's loss line
                with ctx.span("display"):
                    _ = {key: float(v) for key, v in met.items()}

    if ctx.trace and dev.type == "cuda":
        prof_units = tr["profile_steps"]
        trace = profile_window(
            torch, run_units, prof_units,
            ctx.trace_dir / f"{ctx.cell['name']}.json",
            complete=lambda t: bool(t.kernels("in_act")))
        waits.clear()
    # a traced run measures its free part for --seconds after the profiled
    # steps and the trace's reading
    t_free = now()
    n_free = n
    while now() < t_free + ctx.seconds:
        run_units(1)
    ctx.synchronize()
    t1 = now()
    steps = n - n_free
    step_s = (t1 - t_free) / steps if steps else float("nan")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx.close_window()

    del trainer, loaders, stream
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with tf32_off(torch):
        checks, notes = compare(ctx, hyp, init, first, losses, images, grads,
                                change, noise_state, draw, noise_gen)
    out = Outcome(
        e2e={"step_ms": (t1 - t0) / n * 1e3}, setup_s=setup_s, attempted=n,
        failed=0, memory_peak_bytes=peak, checks=checks,
        spans={"loader_wait": list(waits)},
        facts={"unit_s": step_s,
               "latent_hw": side * side,
               "profiled_units": prof_units},
        trace=trace, notes=[ctx.setup_note(), *notes])
    if ctx.trace:
        out.facts["flops_per_unit"] = train_step.step_flops(hyp, b)
    return out


def compare(ctx, hyp, init, first, losses, images, grads, change,
            noise_state, draw, noise_gen):
    """The reference's first steps against the system's: the numbers
    compared, with their limits."""
    torch, dev = ctx.torch, ctx.device
    ref = train_step.Pretrain(hyp, {k: v.to(dev) for k, v in init.items()})
    noise_gen.set_state(noise_state)
    loss_gaps, aug_gap = [], 0.0
    for i, (raw_a, raw_b) in enumerate(first):
        xa = train_step.augment(raw_a, dev)[..., None]
        xb = train_step.augment(raw_b, dev)[..., None]
        if i == 0:
            aug_gap = max(float((xa.cpu() - images[0]).abs().max()),
                          float((xb.cpu() - images[1]).abs().max()))
        got = ref.step(xa, xb, draw())
        loss_gaps.append([abs(losses[i][k] - float(got[k]))
                          / abs(float(got[k])) for k in LOSSES])
        if i == 0:
            ref_grads = leaf_norms(torch, ref.first_grads().items())
    ref_change = {k: float(torch.linalg.vector_norm(
        (v.detach() - init[k].to(dev)).double())) for k, v in ref.p.items()}
    keys = sorted(ref_grads)
    med = statistics.median(ref_grads[k] for k in keys)
    moved = [k for k in keys if ref_grads[k] >= 1e-3 * med]
    g_gaps = leaf_gaps(grads, ref_grads, keys)
    c_gaps = leaf_gaps(change, ref_change, moved)
    notes = [f"loss gaps by step (dis, gen): {loss_gaps!r}",
             summary("first gradient", g_gaps),
             summary("change after three steps", c_gaps),
             f"leaves left out of the change (first gradient under 1e-3 of "
             f"the median leaf's): {len(keys) - len(moved)} of {len(keys)}"]
    lim = ctx.limits
    checks = [("loss_gap_step1", max(loss_gaps[0]), lim["loss_gap_step1"]),
              ("loss_gap", max(max(g) for g in loss_gaps), lim["loss_gap"]),
              ("grad_gap", max(g_gaps.values()), lim["grad_gap"]),
              ("change_gap", max(c_gaps.values()), lim["change_gap"]),
              ("augment_gap", aug_gap, lim["augment_gap"])]
    return checks, notes


# ---------------------------------------------------------------------------
# faults planted under the timed path (tests only)
# ---------------------------------------------------------------------------

def plant(variant, trainer):
    """Break the system under the timed path.  ``augment``: one pixel of
    each augmented batch moved by 0.01 where the augment produces it;
    ``unchanged``: every optimizer step leaves the state as it was;
    ``half_batch``: each step sees the first half of its batch (and of
    each draw), so its means are taken over half the rows."""
    if variant == "augment":
        inner_aug = trainer._augment

        def altered(raw):
            out = inner_aug(raw).clone()
            out[0, 0, 0, 0] += 0.01
            return out

        trainer._augment = altered
    elif variant == "unchanged":
        for opt in (trainer.dis_opt, trainer.gen_opt, trainer.vae_opt):
            opt.step = lambda grads: None
    elif variant == "half_batch":
        import torch

        inner = trainer._pretrain

        def halved(xa, la, xb, lb, noise=None, **kw):
            h = xa.shape[0] // 2

            def cut(t):
                if t.shape[0] == 2 * xa.shape[0]:
                    return torch.cat([t[:h], t[xa.shape[0]:xa.shape[0] + h]])
                return t[:h]

            noise = {k: {kk: cut(vv) for kk, vv in v.items()}
                     for k, v in (noise or {}).items()}
            return inner(xa[:h], la[:h], xb[:h], lb[:h], noise=noise, **kw)

        trainer._pretrain = halved
    elif variant != "control":
        raise ValueError(f"unknown variant {variant!r}")


