"""Data parallelism of the port (``lsps_tpu_torch/parallel``, the trainer's
``mesh``) on the CPU, against one process and against the JAX mesh.

Counterpart of ``test_parallel.py``, ``test_multihost.py`` and
``test_multiprocess.py``.  The ranks are worker subprocesses
(``torch_dp_worker.py``) on a free local port under gloo, started and
harvested by ``torch_dist.run_ranks`` with one deadline that kills every
rank.  One launch runs every case (``ranks`` fixture); the tests read it.

* Two ranks take the step one process takes on the global batch: losses
  within 1e-10 relative in float64 (the ranks' block means against one
  mean: reduction order only), parameters within the lockstep's
  ``PARAM_RTOL`` / ``PARAM_ATOL`` (``torch_lockstep.py``: the IN-fed conv
  biases' Adam steps amplify float64 reduction noise), and after every
  step every rank's parameters bit for bit rank 0's.  The draws are not
  injected: each rank draws the global shape and takes its rows.
* The mesh cases of ``test_parallel.py``: bfloat16 (losses within 5e-3
  relative of one process: bfloat16 convs over half the rows), train_map
  (the joint pass's a/b draws sliced block by block) and estimate4's
  ``post_update`` (the feature alignment on the global batch's first four
  rows on every rank); and remat and the fused-augment raw step.
* Two ranks against the JAX package's 2-device ``pjit_update``, x64, with
  JAX's draws injected (global-shaped, sliced by the trainer): within
  ``TRAJ_RTOL`` / ``TRAJ_ATOL`` of the losses, parameters within
  ``PARAM_RTOL`` / ``PARAM_ATOL``.
"""

import logging

import numpy as np
import pytest
import torch

import jax
from jax import enable_x64

from lsps_tpu.ops.pallas import norm_act as J
from lsps_tpu.parallel import make_mesh, pjit_update, shard_batch, \
    shard_state
from lsps_tpu_torch.parallel import (DataMesh, RowDraws, choose_backend,
                                     initialize, local_rows)
from lsps_tpu_torch.train.trainer import fresh_state_dict
from lsps_tpu_torch.weights import from_jax_params
from torch_dist import check_ranks, run_ranks
from torch_dp_worker import run_case
from torch_lockstep import (PARAM_ATOL, PARAM_RTOL, REG, TRAJ_ATOL,  # noqa: F401
                            TRAJ_RTOL, batch, hyp, jnp_norms, pair,
                            pretrain_noise, raw_batch, recorded)

torch.set_num_threads(1)

STEP_RTOL = 1e-10      # float64 losses, two ranks against one process
BF16_RTOL = 5e-3       # bfloat16 losses, two ranks against one process
GLOBAL_B = 4           # two rows a rank


def _f64(sd):
    return {k: v.double() for k, v in sd.items()}


def _images(k, b=GLOBAL_B):
    rs = np.random.RandomState(3000 + k)
    return (rs.uniform(-1, 1, (b, 128, 128, 1)),
            rs.uniform(-0.3, 0.3, (b, REG)),
            rs.uniform(-1, 1, (b, 128, 128, 1)),
            rs.uniform(-0.3, 0.3, (b, REG)))


def _case(h, sd, actions, **kw):
    return {"hyp": h, "state_dict": sd, "actions": actions, "seed": 5,
            "sch_interval": 2, **kw}


def _port_cases():
    h = hyp()
    sd = _f64(fresh_state_dict(h, 11))
    h_map = hyp(train_map=True)
    h_bf16 = hyp(compute_dtype="bfloat16")
    h_remat = hyp(remat=True)
    ys = [np.random.RandomState(50 + k).uniform(-0.4, 0.4, (8, REG))
          for k in range(3)]
    return {
        "pretrain": _case(h, sd, [("pretrain_update", _images(k), {})
                                  for k in range(3)]),
        "vae": _case(h, sd, [("vae_update", (y,), {}) for y in ys]),
        "train_map": _case(h_map, _f64(fresh_state_dict(h_map, 12)),
                           [("pretrain_update", _images(10 + k), {})
                            for k in range(2)]),
        "post4": _case(h, sd, [("post_update", _images(20 + k),
                                {"mode": 4}) for k in range(2)]),
        "bf16": _case(h_bf16, fresh_state_dict(h_bf16, 13),
                      [("pretrain_update", _images(30 + k), {})
                       for k in range(2)]),
        "remat": _case(h_remat, sd, [("pretrain_update", _images(40 + k),
                                      {}) for k in range(2)]),
        "raw": _case(h, sd, [("pretrain_update_raw", tuple(raw_batch(k)),
                              {}) for k in range(2)]),
    }


def _jax_case():
    """The JAX trainer's 2-device pjit_update trajectory (x64) and the
    port case that replays it with JAX's draws injected (the plain norms,
    as ``torch_lockstep.jnp_norms`` sets them for a test)."""
    J.set_pallas_enabled(False)
    try:
        return _jax_trajectory()
    finally:
        J.set_pallas_enabled(None)


def _jax_trajectory():
    with enable_x64():
        jt, state, port = pair()
        sd = {k: v.clone() for k, v in port.nets.state_dict().items()}
        mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
        step = pjit_update(jt._pretrain_update, mesh, n_batch_args=4,
                           donate_state=False)
        sstate = shard_state(mesh, state)
        actions, want = [], []
        for k in range(2):
            b = batch(50 + k)
            key = jax.random.PRNGKey(k)
            _, d = recorded(jt._pretrain_update, state, *b, key)
            sstate, met, _ = step(sstate, *shard_batch(mesh, *b), key)
            state = jax.device_get(sstate)
            want.append({k2: float(np.asarray(v)) for k2, v in met.items()})
            actions.append(("pretrain_update", b,
                            {"noise": pretrain_noise(d, False)}))
    h = hyp()
    return _case(h, sd, actions), want, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cases = _port_cases()
    cases["jax"], jax_want, jax_state = _jax_case()
    torch.save(cases, tmp / "spec.pt")
    check_ranks(run_ranks(["tests/torch_dp_worker.py", str(tmp / "spec.pt"),
                           str(tmp)], timeout=240))
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return cases, out, jax_want, jax_state


def _check_ranks_equal(out, name):
    """Every rank's parameters are rank 0's, bit for bit, after every
    action."""
    for i, (a, b) in enumerate(zip(out[0][name]["actions"],
                                   out[1][name]["actions"])):
        assert a["digest"] == b["digest"], f"{name}: action {i}"


def _check_against_single(cases, out, name, rtol=STEP_RTOL,
                          param_rtol=PARAM_RTOL, param_atol=PARAM_ATOL):
    single = run_case(cases[name])
    for i, (got, want) in enumerate(zip(out[0][name]["actions"],
                                        single["actions"])):
        assert got["metrics"].keys() == want["metrics"].keys()
        for key, w in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], w, rtol=rtol,
                                       atol=1e-12,
                                       err_msg=f"{name} step {i}: {key}")
    for key, w in single["params"].items():
        np.testing.assert_allclose(out[0][name]["params"][key].float()
                                   .numpy(), w.float().numpy(),
                                   rtol=param_rtol, atol=param_atol,
                                   err_msg=f"{name}: {key}")


@pytest.mark.parametrize("name", ["pretrain", "vae", "train_map", "post4",
                                  "remat", "raw"])
def test_two_ranks_take_the_global_step(ranks, name):
    cases, out, _, _ = ranks
    _check_ranks_equal(out, name)
    _check_against_single(cases, out, name)


def test_two_ranks_bf16(ranks):
    cases, out, _, _ = ranks
    _check_ranks_equal(out, "bf16")
    _check_against_single(cases, out, "bf16", rtol=BF16_RTOL,
                          param_rtol=0, param_atol=1e-2)


def test_two_ranks_match_the_jax_mesh(ranks):
    """Two gloo ranks against the JAX package's 2-device pjit_update on
    the 8-device CPU mesh, x64, JAX's draws injected."""
    _, out, want, state = ranks
    _check_ranks_equal(out, "jax")
    for i, (got, w) in enumerate(zip(out[0]["jax"]["actions"], want)):
        assert set(got["metrics"]) == set(w)
        for key, v in w.items():
            np.testing.assert_allclose(got["metrics"][key], v,
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                       err_msg=f"jax mesh step {i}: {key}")
    with enable_x64():
        wants = from_jax_params(state["params"])
    for key, w in wants.items():
        np.testing.assert_allclose(out[0]["jax"]["params"][key].numpy(),
                                   w.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# parallel/ without a process group
# ---------------------------------------------------------------------------

def test_initialize_single_process_noop(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize() == (False, "single-process")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize(backend="gloo") == (False, "single-process")
    assert not dist.is_initialized()


def test_initialize_failure_is_logged_with_reason(monkeypatch, caplog):
    """Two ranks without a rendezvous address: a fast argument error of
    the env:// rendezvous, returned with its reason and logged."""
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with caplog.at_level(logging.WARNING,
                         logger="lsps_tpu_torch.parallel.multihost"):
        ok, reason = initialize(on_cuda=False)
    assert ok is False
    assert "MASTER_ADDR" in reason
    assert any("initialize failed" in r.message and "MASTER_ADDR"
               in r.message for r in caplog.records)
    assert not dist.is_initialized()


def test_backend_rule():
    """NCCL only for CUDA ranks with a card each; gloo on the CPU or when
    ranks share a card (NCCL refuses two ranks on one GPU)."""
    assert choose_backend(True, 1, 1) == "nccl"
    assert choose_backend(True, 4, 4) == "nccl"
    assert choose_backend(True, 2, 1) == "gloo"
    assert choose_backend(False, 2, 8) == "gloo"


def test_local_rows():
    x = np.arange(24).reshape(8, 3)
    np.testing.assert_array_equal(local_rows(x, 1, 2), x[4:])
    t = torch.arange(16).reshape(2, 8)  # a (K, B) scan stack: axis 1
    assert torch.equal(local_rows(t, 0, 4, axis=1), t[:, 0:2])
    # two segments (a then b): rank 1 of 2 takes rows 2-3 and 6-7
    np.testing.assert_array_equal(local_rows(x, 1, 2, segments=2),
                                  x[[2, 3, 6, 7]])
    with pytest.raises(ValueError, match="do not split"):
        local_rows(x, 0, 3)


def test_row_draws_reassemble_the_global_draw():
    """Each rank draws the global shape and keeps its rows; the ranks'
    rows, put back block by block, are the one-process draw."""
    world, rows = 2, 3
    want = torch.randn((2 * rows * world, 5),
                       generator=torch.Generator().manual_seed(9))
    parts = []
    for r in range(world):
        g = torch.Generator().manual_seed(9)
        d = RowDraws(g, DataMesh(r, world, "cpu"), rows)
        parts.append(d.normal((2 * rows, 5), torch.float32, "cpu"))
    got = torch.cat([parts[0][:rows], parts[1][:rows],
                     parts[0][rows:], parts[1][rows:]])
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="segments"):
        d.uniform((rows + 1, 2), "cpu")
