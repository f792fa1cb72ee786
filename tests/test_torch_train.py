"""The port's LSPSTrainer vs the JAX package's, step by step, in float64.

Both trainers start from the same weights (the JAX trainer's init, carried
over by ``weights.from_jax_params``) at the width of
``helpers.tiny_trainer`` (ch 4, 12-d poses), take the same batches, and
see the same noise: each JAX update runs un-jitted with
``jax.random.normal`` wrapped to record its draws, which are then injected
into the port's update.  After every step the losses and every parameter
of every net must agree.

Tolerances are those of ``test_reference_trajectory_parity.py``: losses to
1e-7 relative / 1e-8 absolute; parameters to 1e-5 relative / 1e-8
absolute.  The parameter tolerance is the wider one because the conv
biases that feed an InstanceNorm have analytically zero loss gradients:
their Adam input is weight decay plus float64 reduction noise, and the
divide by sqrt(nu) + eps amplifies the difference in that noise.  A wrong
decay, grouping, schedule or moment rule moves a parameter by 1e-2 of its
update or more.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64
import optax

from helpers import tiny_trainer
from lsps_tpu.ops.pallas import norm_act as J
from lsps_tpu.train import optim as jax_optim
from lsps_tpu.train.trainer import TrainState, zeroed_subtrees
from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.train import optim
from lsps_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

TRAJ_RTOL, TRAJ_ATOL = 1e-7, 1e-8
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-8
B = 2
REG = 12


@pytest.fixture(autouse=True)
def jnp_norms():
    J.set_pallas_enabled(False)
    yield
    J.set_pallas_enabled(None)


def _pair(train_map=False, sch_interval=2):
    """JAX trainer + float64 state, and the port's trainer on the CPU
    with the same weights.  Call inside ``enable_x64()``."""
    jt = tiny_trainer(map_output_ch=16, train_map=train_map)
    jt = type(jt)(jt.hyp, sch_interval=sch_interval)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jt.init_state(jax.random.PRNGKey(0))["params"])
    opt = {"dis": jt.dis_opt.init(params["dis"]),
           "gen": jt.gen_opt.init({"gen": params["gen"],
                                   "map": params["map"]}),
           "vae": jt.vae_opt.init(params["vae"])}
    port = LSPSTrainer(jt.hyp, from_jax_params(params),
                       sch_interval=sch_interval, device="cpu")
    return jt, TrainState.create(params, opt), port


def recorded(fn, *args, **kw):
    """fn(*args, **kw) with every jax.random.normal draw recorded."""
    draws, orig = [], jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        out = orig(key, shape, dtype)
        draws.append(torch.from_numpy(np.array(out)))
        return out

    jax.random.normal = normal
    try:
        return fn(*args, **kw), draws
    finally:
        jax.random.normal = orig


def _batch(k):
    rs = np.random.RandomState(1000 + k)
    return (rs.uniform(-1, 1, (B, 128, 128, 1)),
            rs.uniform(-0.3, 0.3, (B, REG)),
            rs.uniform(-1, 1, (B, 128, 128, 1)),
            rs.uniform(-0.3, 0.3, (B, REG)))


def _check_metrics(got, want, what):
    assert set(got) == set(want), what
    for key, w in want.items():
        np.testing.assert_allclose(float(got[key]), float(np.asarray(w)),
                                   rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                   err_msg=f"{what}: {key}")


def _check_params(port, state, nets, what):
    for net in nets:
        want = from_jax_params(state["params"][net])
        got = port.nets[net].state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {net}.{k}")


@pytest.mark.parametrize("train_map", [False, True], ids=["map_off",
                                                          "map_on"])
def test_pretrain_lockstep(train_map):
    with enable_x64():
        jt, state, port = _pair(train_map)
        map0 = {k: v.clone() for k, v in port.map.state_dict().items()}
        for k in range(3):
            batch = _batch(k)
            (state, want, _), d = recorded(jt._pretrain_update, state,
                                           *batch, jax.random.PRNGKey(k))
            if train_map:
                noise = {"dis": {"gen": d[0], "vae": d[1]},
                         "gen": {"gen": d[2], "a2b": d[3], "b2a": d[4],
                                 "vae": d[5]}}
            else:
                noise = {"dis": {"gen": d[0]},
                         "gen": {"gen": d[1], "a2b": d[2], "b2a": d[3]}}
            assert len(d) == (6 if train_map else 4)
            got, outs = port.pretrain_update(*batch, noise=noise)
            assert len(outs) == 8
            what = f"pretrain step {k} train_map={train_map}"
            _check_metrics(got, want, what)
            _check_params(port, state, ("dis", "gen", "map", "vae"), what)
    if not train_map:
        for k, v in port.map.state_dict().items():
            assert torch.equal(v, map0[k]), f"map.{k} moved"


def test_post_lockstep_modes_0_1_3_4():
    """One dis optimizer through modes 0, 1, 3, 4: the head a mode leaves
    unreached (the other front, D) gets no grad and no decay, while the
    shared count moves on."""
    keys = {0: ["vae_a"], 1: ["vae_b"], 3: ["gen", "vae_a"],
            4: ["gen", "vae_a", "vae_b"]}
    with enable_x64():
        jt, state, port = _pair()
        for k, mode in enumerate((0, 1, 3, 4)):
            batch = _batch(100 + k)
            (state, want, jouts), d = recorded(
                jt._post_update, state, *batch, jax.random.PRNGKey(k),
                mode=mode)
            assert len(d) == len(keys[mode])
            got, outs = port.post_update(*batch, mode=mode,
                                         noise=dict(zip(keys[mode], d)))
            what = f"post step {k} mode {mode}"
            _check_metrics(got, want, what)
            _check_params(port, state, ("dis",), what)
            for g, w in zip(outs, jouts):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=0, atol=1e-10)


def test_post_mode_5_is_mode_3():
    with enable_x64():
        _, _, a = _pair()
        _, _, b = _pair()
        batch = _batch(200)
        noise = {"gen": torch.zeros(4, 32, 32, 16, dtype=torch.float64),
                 "vae_a": torch.zeros(B, 20, dtype=torch.float64)}
        ma, _ = a.post_update(*batch, mode=3, noise=noise)
        mb, _ = b.post_update(*batch, mode=5, noise=noise)
    assert ma == mb
    for x, y in zip(a.dis.parameters(), b.dis.parameters()):
        assert torch.equal(x, y)


def test_vae_lockstep():
    with enable_x64():
        jt, state, port = _pair(sch_interval=1)
        for k in range(3):
            y = np.random.RandomState(5000 + k).uniform(-0.4, 0.4, (8, REG))
            (state, want, jdec), d = recorded(jt._vae_update, state, y,
                                              jax.random.PRNGKey(k))
            got, dec = port.vae_update(y, noise=d[0])
            what = f"vae step {k}"
            _check_metrics(got, want, what)
            np.testing.assert_allclose(dec.numpy(), np.asarray(jdec),
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
            _check_params(port, state, ("vae",), what)
    assert port.step == 3


def test_adam_none_grads_match_optax_chain():
    """A head with None grads for two steps and real grads on the third,
    against the optax chain given zero grads and zero decay for that head
    (``zeroed_subtrees``): one count for the optimizer, moments of every
    leaf updated on every step.  ``torch.optim.Adam`` would skip the head
    and count its steps apart."""
    rs = np.random.RandomState(0)
    w = {"body": rs.randn(3, 4), "head": rs.randn(5)}
    grads = [{"body": rs.randn(3, 4), "head": rs.randn(5)} for _ in range(4)]
    live = [False, False, True, True]
    with enable_x64():
        chain = jax_optim.adam_multistep(1e-2, 1e-3, (1, 3), 0.5, 1)
        params = jax.tree.map(jnp.asarray, w)
        opt_state = chain.init(params)
        port_params = [torch.from_numpy(w["body"].copy()),
                       torch.from_numpy(w["head"].copy())]
        adam = optim.AdamMultiStep(
            port_params, optim.multistep_lr(1e-2, (1, 3), 0.5, 1), 1e-3)
        for g, head_live in zip(grads, live):
            jg = dict(g) if head_live else {**g, "head": np.zeros(5)}
            ref = params if head_live else zeroed_subtrees(params,
                                                           ("head",))
            upd, opt_state = chain.update(jax.tree.map(jnp.asarray, jg),
                                          opt_state, ref)
            params = optax.apply_updates(params, upd)
            adam.step([torch.from_numpy(g["body"]),
                       torch.from_numpy(g["head"]) if head_live else None])
            for p, k in zip(port_params, ("body", "head")):
                np.testing.assert_allclose(p.numpy(), np.asarray(params[k]),
                                           rtol=1e-13, atol=1e-15)
    assert adam.count == 4
    # the head moved on the None-grad steps too: momentum from nothing is
    # nothing, so only after its first real grad
    assert not np.array_equal(port_params[1].numpy(), w["head"])


@pytest.mark.parametrize("interval", [1, 100])
def test_multistep_lr_matches_jax(interval):
    for base, ms, gamma in ((1e-4, optim.DIS_GEN_MILESTONES,
                             optim.DIS_GEN_GAMMA),
                            (1e-3, optim.VAE_MILESTONES, optim.VAE_GAMMA)):
        ours = optim.multistep_lr(base, ms, gamma, interval)
        ref = jax_optim.multistep_lr(base, ms, gamma, interval)
        counts = sorted({c for m in ms for c in (m * interval - 2,
                                                 m * interval - 1,
                                                 m * interval)} | {0})
        for c in counts:
            assert ours(c) == pytest.approx(float(ref(c)), rel=1e-6), c
