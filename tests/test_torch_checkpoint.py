"""The port's ``.npz`` checkpoints against the JAX package's, both ways.

* ``weights.to_jax_params`` gives each net's JAX pytree, structure and
  leaves, and is the inverse of ``from_jax_params``.
* A set saved by the JAX ``CheckpointManager`` resumes in the port with
  ``load_opt=True``, and the next port step equals the next JAX step
  (float64 lockstep, ``test_torch_train.py``'s tolerances).
* A set saved by the port loads in the JAX ``CheckpointManager`` with
  every leaf (parameters, Adam's moments and both counts) equal bit for
  bit.
* ``save_vae`` / ``load_vae`` round trip, and cross-load with JAX.
* Both packages write the same file names.
* A resume with no optimizer files continues the LR schedule from the
  parsed iteration while Adam restarts, exactly as the JAX trainer does.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from lsps_tpu.train.checkpoint import CheckpointManager
from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.train import checkpoint as ckpt
from lsps_tpu_torch.weights import from_jax_params, to_jax_params
from torch_lockstep import (batch, check_metrics, check_params,
                            jnp_norms,  # noqa: F401
                            pair, pretrain_noise, recorded)

torch.set_num_threads(1)

NETS = ("dis", "gen", "vae", "map")


def _leaves_equal(got, want, what):
    """Two pytrees with the same structure and bit-equal leaves."""
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want)), what
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, path)
        assert np.array_equal(g, w), (what, jax.tree_util.keystr(path))


def test_to_jax_params_is_the_jax_tree():
    _, state, port = pair(train_map=True, dtype=jnp.float32)
    for net in NETS:
        tree = to_jax_params(port.nets[net])
        _leaves_equal(tree, jax.tree.map(np.asarray, state["params"][net]),
                      net)
        sd = port.nets[net].state_dict()
        back = from_jax_params(tree)
        assert list(back) == list(sd)
        assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_jax_save_resumes_in_port_and_steps_in_lockstep(tmp_path):
    prefix = str(tmp_path / "pre")
    with enable_x64():
        jt, state, port = pair()
        for k in range(2):
            (state, _, _), _ = recorded(jt._pretrain_update, state,
                                        *batch(500 + k),
                                        jax.random.PRNGKey(k))
        jt.save(state, prefix, 1)
        assert port.resume(prefix, load_opt=True) == 2
        assert (port.gen_opt.count, port.gen_opt.sched_count) == (2, 2)
        assert (port.dis_opt.count, port.dis_opt.sched_count) == (2, 2)
        check_params(port, state, ("dis", "gen", "map"), "resumed")
        data = batch(510)
        (state, want, _), d = recorded(jt._pretrain_update, state, *data,
                                       jax.random.PRNGKey(9))
        got, _ = port.pretrain_update(*data,
                                      noise=pretrain_noise(d, False))
        check_metrics(got, want, "step after resume")
        check_params(port, state, ("dis", "gen", "map"), "step after resume")


def test_port_save_loads_in_jax_bit_for_bit(tmp_path):
    prefix = str(tmp_path / "pre")
    jt, state, port = pair(train_map=True, dtype=jnp.float32)
    for k in range(2):
        port.pretrain_update(*batch(520 + k))
    port.save(prefix, 1)
    template = jt.init_state(jax.random.PRNGKey(5))
    loaded, it = jt.resume(template, prefix, load_opt=True)
    assert it == 2 and jt.ckpt.last_opt_loaded
    for net in ("dis", "gen", "map"):
        _leaves_equal(loaded["params"][net], to_jax_params(port.nets[net]),
                      net)
    for key, opt, nets in (("gen", port.gen_opt, port.gen_opt_nets),
                           ("dis", port.dis_opt, port.dis_opt_nets)):
        want = ckpt.opt_arrays(opt, nets)
        adam, sched = loaded["opt"][key][1], loaded["opt"][key][2]
        assert int(adam.count) == int(sched.count) == 2
        flat = ckpt.flatten(jax.tree.map(np.asarray, adam.mu), "1/.mu/")
        flat.update(ckpt.flatten(jax.tree.map(np.asarray, adam.nu),
                                 "1/.nu/"))
        assert set(flat) == set(want) - {"1/.count", "2/.count"}
        for k, v in flat.items():
            assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k


def test_vae_round_trip_and_cross_load(tmp_path):
    prefix = str(tmp_path / "pose")
    jt, state, port = pair(dtype=jnp.float32)
    ys = np.random.RandomState(3).uniform(-0.4, 0.4, (8, 12))
    port.vae_update(ys)
    port.save_vae(prefix, 4, 0.5)
    assert os.path.isfile(f"{prefix}_vae_0.50_00000005.npz")
    fresh = LSPSTrainer(port.hyp, from_jax_params(state["params"]),
                        device="cpu")
    assert not fresh.load_vae(prefix, 0.25)
    assert fresh.load_vae(prefix, 0.5)
    for a, b in zip(fresh.vae.parameters(), port.vae.parameters()):
        assert torch.equal(a, b)
    loaded, ok = jt.load_vae(state, prefix, 0.5)
    assert ok
    _leaves_equal(loaded["params"]["vae"], to_jax_params(port.vae), "vae")
    # and a JAX-saved VAE loads in the port
    jt.save_vae(state, str(tmp_path / "jax" / "pose"), 0, 0.5)
    assert fresh.load_vae(str(tmp_path / "jax" / "pose"), 0.5)
    _leaves_equal(to_jax_params(fresh.vae),
                  jax.tree.map(np.asarray, state["params"]["vae"]), "vae")


def test_same_file_names(tmp_path):
    jt, state, port = pair(dtype=jnp.float32)
    for tag, save in (("jax", lambda p, i: jt.save(state, p, i)),
                      ("port", port.save)):
        os.makedirs(tmp_path / tag)
        save(str(tmp_path / tag / "pre"), 41)
        save(str(tmp_path / tag / "pre_est"), 7)
    jt.save_vae(state, str(tmp_path / "jax" / "pose"), 9, 0.9)
    port.save_vae(str(tmp_path / "port" / "pose"), 9, 0.9)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "pre_gen_00000042.npz" in names
    assert "pre_est_optd_00000008.npz" in names
    assert "pose_vae_0.90_00000010.npz" in names
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files), name
    # an est resume picks the est set
    assert port.resume(str(tmp_path / "jax" / "pre"), est=True) == 8


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_resume_without_optimizer_files(tmp_path, saved_by):
    """Saved at iteration 250 without optimizer files, with the schedule
    stepping every iteration (milestone 200 passed): both trainers resume
    the LR at count 251, half the base, with Adam's count at 0."""
    prefix = str(tmp_path / "pre")
    with enable_x64():
        jt, state, port = pair(sch_interval=1)
        if saved_by == "jax":
            CheckpointManager().save(state, prefix, 250, save_opt=False)
        else:
            port.save(prefix, 250, save_opt=False)
        assert not any("_opt" in f for f in os.listdir(tmp_path))
        state, it = jt.resume(state, prefix, load_opt=True)
        assert it == 251 and port.resume(prefix, load_opt=True) == 251
        assert int(state["opt"]["gen"][2].count) == 251
        assert int(state["opt"]["gen"][1].count) == 0
        assert (port.gen_opt.count, port.gen_opt.sched_count) == (0, 251)
        assert (port.dis_opt.count, port.dis_opt.sched_count) == (0, 251)
        data = batch(530)
        (state, want, _), d = recorded(jt._pretrain_update, state, *data,
                                       jax.random.PRNGKey(4))
        got, _ = port.pretrain_update(*data,
                                      noise=pretrain_noise(d, False))
        assert got["gen_lr"] == pytest.approx(jt.hyp["lr"] * 0.5)
        check_metrics(got, want, "step after a resume without optimizers")
        check_params(port, state, ("dis", "gen", "map"), "after resume")
