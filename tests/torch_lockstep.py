"""Shared harness of the trainer tests: the port's LSPSTrainer beside the
JAX package's, from the same weights, with the JAX draws recorded and
injected into the port.

Each JAX update runs un-jitted with ``jax.random.normal`` (and, for
dropout, ``jax.random.bernoulli``) wrapped to record its draws, which the
port's update is then given: normal draws through ``noise=``, dropout
masks through ``injected_dropout``.  Tolerances are those of
``test_reference_trajectory_parity.py`` (see ``test_torch_train.py``).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import tiny_trainer
from lsps_tpu.data.fast_augment import _batched_rotation_dst_to_src
from lsps_tpu.ops.pallas import norm_act as J
from lsps_tpu.train.trainer import TrainState
from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.weights import from_jax_params

TRAJ_RTOL, TRAJ_ATOL = 1e-7, 1e-8
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-8
B = 2
REG = 12


@pytest.fixture(autouse=True)
def jnp_norms():
    J.set_pallas_enabled(False)
    yield
    J.set_pallas_enabled(None)


def hyp(train_map=False, gen=None, **over):
    """The tiny trainer's hyperparameters; ``gen`` updates the generator's
    config, ``over`` the top level."""
    h = copy.deepcopy(tiny_trainer(map_output_ch=16, train_map=train_map,
                                   **over).hyp)
    h["gen"].update(gen or {})
    return h


def pair(train_map=False, sch_interval=2, dtype=jnp.float64, gen=None,
         port_hyp=None, **over):
    """JAX trainer + state in ``dtype``, and the port's trainer on the CPU
    with the same weights (and ``port_hyp`` if given).  For float64 call
    inside ``enable_x64()``."""
    from lsps_tpu.train import LSPSTrainer as JaxTrainer

    h = hyp(train_map, gen, **over)
    jt = JaxTrainer(h, sch_interval=sch_interval)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                          jt.init_state(jax.random.PRNGKey(0))["params"])
    opt = {"dis": jt.dis_opt.init(params["dis"]),
           "gen": jt.gen_opt.init({"gen": params["gen"],
                                   "map": params["map"]}),
           "vae": jt.vae_opt.init(params["vae"])}
    port = LSPSTrainer(port_hyp or h, from_jax_params(params),
                       sch_interval=sch_interval, device="cpu")
    return jt, TrainState.create(params, opt), port


def _torch(out):
    a = np.array(out)
    if a.dtype.name == "bfloat16":  # the port casts noise to x's dtype
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def recorded(fn, *args, **kw):
    """fn(*args, **kw) with every jax.random.normal draw recorded."""
    (out, draws, _) = recorded_with_masks(fn, *args, **kw)
    return out, draws


def recorded_with_masks(fn, *args, **kw):
    """fn(*args, **kw), its normal draws and its dropout keep-masks (NHWC
    bool arrays), each in the order drawn."""
    draws, masks = [], []
    orig_normal, orig_bernoulli = jax.random.normal, jax.random.bernoulli

    def normal(key, shape=(), dtype=jnp.float32):
        out = orig_normal(key, shape, dtype)
        draws.append(_torch(out))
        return out

    def bernoulli(key, p=0.5, shape=None):
        out = orig_bernoulli(key, p, shape)
        masks.append(np.array(out))
        return out

    jax.random.normal, jax.random.bernoulli = normal, bernoulli
    try:
        return fn(*args, **kw), draws, masks
    finally:
        jax.random.normal, jax.random.bernoulli = orig_normal, orig_bernoulli


@contextlib.contextmanager
def injected_dropout(masks):
    """Within the block every ``Dropout`` of the port takes the next of
    ``masks`` (NHWC, in the JAX package's order) as its keep-mask; the
    block fails if any is left over."""
    queue = list(masks)

    def forward(self, x, generator=None):
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.from_numpy(queue.pop(0)).permute(0, 3, 1, 2)
        return torch.where(mask, x / keep, torch.zeros_like(x))

    orig = L.Dropout.forward
    L.Dropout.forward = forward
    try:
        yield
    finally:
        L.Dropout.forward = orig
    assert not queue, f"{len(queue)} dropout masks left over"


def batch(k):
    rs = np.random.RandomState(1000 + k)
    return (rs.uniform(-1, 1, (B, 128, 128, 1)),
            rs.uniform(-0.3, 0.3, (B, REG)),
            rs.uniform(-1, 1, (B, 128, 128, 1)),
            rs.uniform(-0.3, 0.3, (B, REG)))


def raw_batch(k, u16=False):
    """Raw tuples of both domains and labels: rotations over +-180 degrees
    and shifts, sentinel pixels, float32 or uint16-coded sources."""
    rs = np.random.RandomState(2000 + k)
    out = []
    for _ in range(2):
        minv = _batched_rotation_dst_to_src((64, 64), rs.uniform(0, 360, B))
        minv[:, :2, 2] += rs.uniform(-8, 8, (B, 2))
        com_z = rs.uniform(650, 850, B).astype(np.float32)
        cube_z = np.full(B, 300.0, np.float32)
        premax = com_z + cube_z / 2
        src = rs.uniform(com_z[:, None, None] - 140, com_z[:, None, None]
                         + 140, (B, 128, 128)).astype(np.float32)
        src[:, :10] = 0.0
        src[:, 40:44] = 32000.0
        src[:, 60:64] = premax[:, None, None]
        raw = (np.round(src), minv, com_z, cube_z, premax,
               com_z - cube_z / 2, com_z + cube_z / 2)
        if u16:
            raw = (raw[0].astype(np.uint16), *raw[1:],
                   rs.uniform(500, 520, B).astype(np.float32))
        out += [raw, rs.uniform(-0.3, 0.3, (B, REG))]
    return out


def pretrain_noise(d, train_map):
    """The recorded draws of one JAX pretrain step as the port's noise."""
    if train_map:
        assert len(d) == 6
        return {"dis": {"gen": d[0], "vae": d[1]},
                "gen": {"gen": d[2], "a2b": d[3], "b2a": d[4], "vae": d[5]}}
    assert len(d) == 4
    return {"dis": {"gen": d[0]},
            "gen": {"gen": d[1], "a2b": d[2], "b2a": d[3]}}


def check_metrics(got, want, what, rtol=TRAJ_RTOL, atol=TRAJ_ATOL):
    assert set(got) == set(want), what
    for key, w in want.items():
        np.testing.assert_allclose(float(got[key]), float(np.asarray(w)),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {key}")


def check_params(port, state, nets, what):
    for net in nets:
        want = from_jax_params(state["params"][net])
        got = port.nets[net].state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {net}.{k}")
