"""``compute_dtype: bfloat16`` and ``remat`` of the port's trainer.

bfloat16: the port against the JAX trainer, both in bfloat16 compute over
float32 parameters, over 3 ``pretrain_update`` steps with train_map off
and 1 with it on, the JAX draws injected.  Each step starts from the JAX
state (the port's parameters are set to JAX's before it): a free-running
bfloat16 trajectory drifts through Adam's first steps, whose update is
about +-lr per element whatever the gradient's size, so an element whose
gradient is within rounding of zero may move the other way.  Every loss then agrees
within BF16_RTOL.  The widest is ``dis_feat_loss``, the L1 distance of the
features of two nearly equal images (~1e-4 against a ``dis_loss`` of
~28), measured at 3.2e-3; every other loss within 2.6e-4.  (Free-running,
the same 3 steps read 4e-2 on ``dis_feat_loss`` and 1.3e-3 on the rest;
the JAX trainer's own bfloat16 and float32 runs read 2e-2 apart on it.)
The port rounds where JAX does (``ops/layers.py``): without that the
first step alone reads 4e-2.

Parameters and Adam's moments stay float32 at rest, outputs are float32,
and the norm kernels' plain versions see bfloat16 planes.

remat: the same float64 trainer with and without ``remat``, from the same
seed and with no noise injected, must take the same steps (1e-12): a
recompute that drew its noise or dropout masks anew would not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from lsps_tpu_torch.ops.kernels import norm_act as N
from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.weights import from_jax_params
from torch_lockstep import (batch, check_metrics, hyp,
                            jnp_norms,  # noqa: F401
                            pair, pretrain_noise, raw_batch, recorded)

torch.set_num_threads(1)

BF16_RTOL = 5e-3


@pytest.mark.parametrize("train_map,steps", [(False, 3), (True, 1)],
                         ids=["map_off", "map_on"])
def test_bf16_pretrain_matches_jax_bf16(train_map, steps):
    jt, state, port = pair(train_map, dtype=jnp.float32,
                           compute_dtype="bfloat16")
    assert port.compute_dtype == torch.bfloat16
    seen = []
    orig = N.in_act_forward_reference

    def spy(x, slope):
        seen.append(x.dtype)
        return orig(x, slope)

    for k in range(steps):
        for net in ("dis", "gen", "map"):
            port.nets[net].load_state_dict(
                from_jax_params(state["params"][net]))
        data = tuple(np.asarray(a, np.float32) for a in batch(300 + k))
        (state, want, jouts), d = recorded(jt._pretrain_update, state,
                                           *data, jax.random.PRNGKey(k))
        N.in_act_forward_reference = spy
        try:
            got, outs = port.pretrain_update(
                *data, noise=pretrain_noise(d, train_map))
        finally:
            N.in_act_forward_reference = orig
        check_metrics(got, want, f"bf16 step {k} train_map={train_map}",
                      rtol=BF16_RTOL, atol=0.0)
        assert all(o.dtype == torch.float32 for o in outs)
        assert all(np.asarray(o).dtype == np.float32 for o in jouts)
    assert seen and set(seen) == {torch.bfloat16}
    for p in port.nets.parameters():
        assert p.dtype == torch.float32
    for opt in (port.dis_opt, port.gen_opt, port.vae_opt):
        assert all(m.dtype == torch.float32 for m in opt.mu + opt.nu)


def test_bf16_post_gen_and_raw_steps_keep_float32():
    h = hyp(compute_dtype="bfloat16")
    _, state, _ = pair(dtype=jnp.float32)
    port = LSPSTrainer(h, from_jax_params(state["params"]), device="cpu")
    data = batch(310)
    for mode in (0, 1, 3, 4):
        met, outs = port.post_update(*data, mode=mode)
        assert np.isfinite(float(met["dis_total_loss"])), mode
        assert all(o.dtype == torch.float32 for o in outs), mode
    met, outs = port.gen_update(*data)
    assert all(o.dtype == torch.float32 for o in outs)
    assert all(np.isfinite(float(v)) for v in met.values())
    met, (outs, ia, ib) = port.pretrain_update_raw(*raw_batch(0, u16=True))
    assert all(o.dtype == torch.float32 for o in (*outs, ia, ib))
    assert all(np.isfinite(float(v)) for v in met.values())
    for p in port.nets.parameters():
        assert p.dtype == torch.float32


def test_unsupported_compute_dtype_raises():
    _, state, _ = pair(dtype=jnp.float32)
    with pytest.raises(ValueError, match="float16"):
        LSPSTrainer(hyp(compute_dtype="float16"),
                    from_jax_params(state["params"]), device="cpu")


@pytest.mark.parametrize("dropout", [0.0, 0.5], ids=["noise", "dropout"])
def test_remat_takes_the_same_steps(dropout):
    with enable_x64():
        _, state, _ = pair(train_map=True)
    sd = from_jax_params(state["params"])
    gen = {"res_dropout_ratio": dropout}
    plain = LSPSTrainer(hyp(True, gen), sd, device="cpu", seed=7)
    remat = LSPSTrainer(hyp(True, gen, remat=True), sd, device="cpu",
                        seed=7)
    assert remat.remat and not plain.remat
    for k in range(2):
        data = batch(320 + k)
        mp, op = plain.pretrain_update(*data)
        mr, orr = remat.pretrain_update(*data)
        check_metrics(mr, mp, f"remat step {k}", rtol=1e-12, atol=1e-12)
        for a, b in zip(orr, op):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)
    for (name, a), b in zip(remat.nets.named_parameters(),
                            plain.nets.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert torch.equal(remat.generator.get_state(),
                       plain.generator.get_state())
