"""Entry ``serve``: depth frames through the system's ``PoseEstimator``.

Set-up makes the regressor's and the pose VAE's weights on the device from
the seed, renders a pool of frames on the device (uint16 millimetres,
kept in host memory as a camera or a recorded sequence hands them over)
and warms the estimator up at the cell's batch.  Every call copies its
frames in from host memory and brings its joints back to the host.

* ``mode: stream`` is a camera: one frame at a time, due every 1 / fps
  seconds from the window's start (open loop: a late call delays the
  frames after it, whose latency counts from their due times).  The
  stream's clock (``harness.clock.wait_until``) spins the caller up to
  each due time, so that no oversleep of its own enters the latencies.
  ``frame_p95_ms`` is the 95th percentile over all frames of the window,
  each from its due time to its joints on the host.
* ``mode: batches`` is an offline labelling job: batches of ``batch``
  frames back to back (closed loop, one caller), from pinned host memory
  with ``pinned: true``.  ``frames_per_s`` is the frames labelled in the
  window over the window.

``detect: true`` calls ``predict_raw``, which finds each frame's CoM on
the card; otherwise ``predict_frames`` takes the CoMs and cubes that the
scene's labels give.  After the window the estimator is freed and the
plain reference computes every pool frame's joints (its own CoMs where
the cell detects); every answer of the window is compared with them.
"""

from __future__ import annotations

import gc

import numpy as np

from harness import scenes, weights, yardstick
from harness.clock import wait_until
from harness.context import Outcome, now, tf32_off
from harness.trace import profile_window
from reference import nets
from reference import serve as ref

ANSWER_FAULT_MM = 1.0


def run(ctx) -> Outcome:
    torch, dev = ctx.torch, ctx.device
    tr, hyp, cfg = ctx.traffic, ctx.hyp, ctx.config
    from lsps_tpu_torch.data.camera import Camera
    from lsps_tpu_torch.serve.inference import PoseEstimator

    cam = cfg["camera"]
    hw = tuple(cfg["frame_hw"])
    detect, stream = tr["detect"], tr["mode"] == "stream"
    b = tr["batch"]
    ctx.mark("imports")
    sd = weights.make(torch, nets.param_specs(hyp, ("dis", "vae")),
                      ctx.seed_for("weights"), dev)
    init = {k: v.cpu() for k, v in sd.items()}
    est = PoseEstimator(
        hyp, sd, camera=Camera(cam["fx"], cam["fy"], cam["ux"], cam["uy"],
                               flip_y=cam["flip_y"],
                               depth_map_size=(hw[1], hw[0])),
        device=dev,
        dtype=torch.bfloat16 if ctx.variant == "control" else torch.float32)
    del sd
    if ctx.variant and ctx.variant != "control":
        plant(ctx.variant, est)
    ctx.mark("weights and estimator")

    # the pool: units of `b` frames (one frame a unit in a stream)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("frames"))
    if stream:
        n_units = tr["pool_frames"]
        f = scenes.moving_hand(torch, gen, n_units, hw, cam["fx"], tr["fps"])
        frames = f.cpu().numpy()[:, None]
        coms = np.zeros((n_units, 1, 3), np.float32)
    else:
        n_units = tr["pool_batches"]
        fs, cs = [], []
        for _ in range(n_units):
            f, c = scenes.still_hands(torch, gen, b, hw, cam["fx"],
                                      margin=(0.25 * hw[1], 0.25 * hw[0]))
            fs.append(f.cpu().numpy())
            cs.append(c.cpu().numpy())
        frames, coms = np.stack(fs), np.stack(cs).astype(np.float32)
    cubes = np.full(coms.shape, float(cfg["cube_mm"]), np.float32)
    # the frames as the estimator gets them: pageable numpy, or a host
    # tensor in pinned memory, as a loader with pin_memory hands it over
    inputs = frames
    if tr.get("pinned") and dev.type == "cuda":
        inputs = torch.from_numpy(frames).pin_memory()
    ctx.mark("frames")

    def call(k):
        if detect:
            j, c = est.predict_raw(inputs[k], cubes[k], return_coms=True)
        else:
            j, c = est.predict_frames(inputs[k], coms[k], cubes[k]), None
        return j.cpu().numpy(), c

    for i in range(tr["warmup_calls"]):
        call(i % n_units)
    ctx.synchronize()
    ctx.mark("warm-up calls")
    setup_s = now() - ctx.t_start
    ctx.open_window()

    answers, lat, late = [], [], []
    overran = 0             # frames due while the call before ran on
    t0 = now()
    period = 1.0 / tr["fps"] if stream else 0.0
    sched = {"origin": t0, "base": 0}    # the stream's clock

    def run_units(count):
        nonlocal overran
        for _ in range(count):
            i = len(answers)
            k = i % n_units
            if stream:
                due = sched["origin"] + (i - sched["base"]) * period
                if now() < due:
                    with ctx.span("wait"):
                        wait_until(due, now)
                elif i > sched["base"]:    # the first is due at the origin
                    overran += 1
                late.append(max(0.0, now() - due))
            else:
                due = now()
            with ctx.span("call"):
                j, c = call(k)
            lat.append(now() - due)
            answers.append((k, j, c))

    trace, n_prof = None, 0
    if ctx.trace and dev.type == "cuda":
        n_prof = tr["profile_units"]
        hooks = detect_ranges(est) if detect else []
        trace = profile_window(
            torch, run_units, n_prof,
            ctx.trace_dir / f"{ctx.cell['name']}.json",
            complete=lambda t: bool(t.kernels(yardstick.CROP_SYMBOL)))
        for h in hooks:
            h.remove()
    # a traced run measures its free part for --seconds after the profiled
    # calls and the trace's reading; the stream's clock starts again there
    t_free, n_free = now(), len(answers)
    sched.update(origin=t_free, base=n_free)
    late.clear()
    overran = 0
    if stream:
        run_units(max(1, int(ctx.seconds * tr["fps"])))
    else:
        while now() < t_free + ctx.seconds:
            run_units(1)
    ctx.synchronize()
    t1 = now()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx.close_window()
    copy_note = copy_in_note(torch, inputs, dev)
    del est
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    got_coms = [c.cpu().numpy() if c is not None else None
                for _, _, c in answers]
    with tf32_off(torch):
        checks, notes, failed = compare(ctx, hyp, init, frames, coms, cubes,
                                        answers, got_coms, detect)
    n_frames = len(answers) * b
    free_lat = lat[n_free:]
    notes.append(latency_note(free_lat, "frame" if stream else "call"))
    if copy_note:
        notes.append(copy_note)
    if stream:
        e2e = {"frame_p95_ms": yardstick.percentile(free_lat, 95) * 1e3}
        notes.append(f"generator: {len(late)} frames, late by at most "
                     f"{max(late) * 1e3:.4f} ms, median "
                     f"{float(np.median(late)) * 1e3:.4f} ms; {overran} "
                     f"due while the call before still ran")
        unit_s = yardstick.percentile(free_lat, 50)
    else:
        e2e = {"frames_per_s": n_frames / (t1 - t0)}
        unit_s = (t1 - t_free) / max(1, len(answers) - n_free)
    out = Outcome(e2e=e2e, setup_s=setup_s, attempted=n_frames,
                  failed=failed, memory_peak_bytes=peak, checks=checks,
                  spans={"latency": free_lat}, notes=notes, trace=trace)
    if ctx.trace:
        out.facts.update(
            unit_s=unit_s, profiled_units=n_prof,
            flops_per_unit=ref.call_flops(hyp, b),
            crop_bound_s=crop_bound(torch, cam, hw, answers[:n_prof],
                                    got_coms[:n_prof], coms, cubes))
    return out


def latency_note(lat, unit) -> str:
    q = [yardstick.percentile(lat, p) * 1e3 for p in (50, 95, 100)]
    return (f"{unit} latency over the free window: {len(lat)} {unit}s, p50 "
            f"{q[0]:.4f} ms, p95 {q[1]:.4f} ms, max {q[2]:.4f} ms")


def copy_in_note(torch, inputs, dev):
    """The pinned pool's copy to the card, timed by CUDA events after the
    window: the host link as this run's buffers found it; None for frames
    in pageable memory."""
    if dev.type != "cuda" or not torch.is_tensor(inputs):
        return None
    buf = torch.empty_like(inputs[0], device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 3
    start.record()
    for _ in range(reps):
        for unit in inputs:
            buf.copy_(unit, non_blocking=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    gb = reps * inputs.numel() * inputs.element_size() / 1e9
    del buf
    return (f"copy in after the window: {reps} x {inputs.shape[0]} pinned "
            f"units, {gb / ms * 1e3:.2f} GB/s ({ms / reps / inputs.shape[0]:.4f}"
            f" ms a unit)")


def crop_bound(torch, cam, hw, answers, got_coms, coms, cubes) -> float:
    """The crop kernel's bound per call over the profiled calls: the
    bytes of their crops (from the CoMs the calls used) over the
    bandwidth, or the operations over the float32 peak."""
    if not answers:
        return float("nan")
    total = 0.0
    for (k, _, _), c in zip(answers, got_coms):
        c = torch.from_numpy(coms[k] if c is None else c)
        iy, ix = ref.crop_indices(c, torch.from_numpy(cubes[k]), cam["fx"],
                                  cam["fy"], hw)
        total += yardstick.bound_s(yardstick.warp_bytes(2, iy, ix),
                                   yardstick.warp_flops(c.shape[0], 128, 128))
    return total / len(answers)


def compare(ctx, hyp, init, frames, coms, cubes, answers, got_coms,
            detect):
    """Every answer of the window against the reference's joints of its
    frames: the largest gap in mm, with its limit."""
    torch, dev = ctx.torch, ctx.device
    cam = ctx.config["camera"]
    rcam = ref.Camera(cam["fx"], cam["fy"], cam["ux"], cam["uy"],
                      cam["flip_y"])
    params = {k: v.to(dev) for k, v in init.items()}
    want, want_coms = [], []
    with torch.no_grad():
        for k in range(frames.shape[0]):
            f = torch.from_numpy(frames[k]).to(dev)
            q = torch.from_numpy(cubes[k]).to(dev)
            c = (ref.detect(f, q, cam["fx"], cam["fy"]) if detect
                 else torch.from_numpy(coms[k]).to(dev))
            want.append(ref.joints(params, hyp, rcam, f, c, q).cpu().numpy())
            want_coms.append(c.cpu().numpy())
    gap, com_gap, failed = 0.0, 0.0, 0
    for (k, j, _), c in zip(answers, got_coms):
        bad = ~np.isfinite(j).all(axis=(1, 2))
        if c is not None:
            bad |= ~c.any(axis=1)
            com_gap = max(com_gap, float(np.abs(c - want_coms[k]).max()))
        failed += int(bad.sum())
        gap = max(gap, float(np.nan_to_num(np.abs(j - want[k]),
                                           nan=np.inf).max()))
    notes = [ctx.setup_note(),
             f"answers compared: {len(answers)} calls, every one"]
    if detect:
        notes.append(f"CoM gap (u, v px; z mm; in the joints' gap): "
                     f"{com_gap!r}")
    if any(not w.any(axis=1).all() for w in want_coms):
        notes.append("the reference found no hand in some frame")
    return ([("joint_gap_mm", gap, ctx.limits["joint_gap_mm"])],
            notes, failed)


def detect_ranges(est):
    """Forward hooks on the estimator's programs that open a
    ``bench.detect`` range when ``RawProgram`` starts and close it when it
    hands over to ``FramesProgram``: the kernels launched inside are
    detection's."""
    from torch.profiler import record_function

    open_ = []

    def start(module, args):
        rf = record_function("bench.detect")
        rf.__enter__()
        open_.append(rf)

    def stop(module, args):
        while open_:
            open_.pop().__exit__(None, None, None)

    return [est.raw_program.register_forward_pre_hook(start),
            est.frames_program.register_forward_pre_hook(stop)]


def plant(variant, est):
    """``answer``: every call's first joint of its first frame moved by
    1 mm where the joints are produced."""
    if variant != "answer":
        raise ValueError(f"unknown variant {variant!r}")
    prog = est.frames_program
    inner = prog.forward

    def altered(frames, coms, cubes):
        j = inner(frames, coms, cubes).clone()
        j[0, 0, 0] += ANSWER_FAULT_MM
        return j

    prog.forward = altered
