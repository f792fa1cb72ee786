"""The port's fused-augment steps and the train_map decode against the JAX
trainer, step by step, in float64.

``pretrain_update_raw`` (train_map off and on), ``gen_update_raw`` and
``post_update_raw`` (modes 0, 1, 3, 4) against the un-jitted
``_pretrain_update_raw`` etc. on the same raw tuples (``FastAugmenter``'s
layout: float32 and uint16 sources, rotations and shifts), with the JAX
draws injected.  The JAX augment's float32 crops meet float64 weights
there, which its convs refuse, so the JAX trainer's ``_device_augment`` is
wrapped to cast them to float64 (exact), as the port's step does.  Then
``pretrain_update`` with ``res_dropout_ratio: 0.5``
and train_map on, the JAX dropout masks injected too, which holds only if
the train_map decodes run without dropout, as the JAX trainer's do.
Tolerances are ``test_torch_train.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import enable_x64

from torch_lockstep import (B, batch, check_metrics, check_params,
                            injected_dropout, jnp_norms,  # noqa: F401
                            pair, pretrain_noise, raw_batch, recorded,
                            recorded_with_masks)

torch.set_num_threads(1)


def raw_pair(train_map=False):
    """``pair`` with the JAX trainer's crops cast to float64."""
    jt, state, port = pair(train_map)
    augment = jt._device_augment
    jt._device_augment = lambda raw: augment(raw).astype(jnp.float64)
    return jt, state, port


@pytest.mark.parametrize("train_map", [False, True], ids=["map_off",
                                                          "map_on"])
def test_pretrain_update_raw_lockstep(train_map):
    with enable_x64():
        jt, state, port = raw_pair(train_map)
        for k in range(2):
            raw = raw_batch(k, u16=k == 1)
            (state, want, jouts), d = recorded(
                jt._pretrain_update_raw, state, *raw, jax.random.PRNGKey(k))
            got, outs = port.pretrain_update_raw(
                *raw, noise=pretrain_noise(d, train_map))
            what = f"pretrain_update_raw step {k} train_map={train_map}"
            check_metrics(got, want, what)
            check_params(port, state, ("dis", "gen", "map"), what)
            gen_outs, images_a, images_b = outs
            assert len(gen_outs) == 8
            # the crops come back NHWC float32, bit-equal to JAX's
            for g, w in ((images_a, jouts[1]), (images_b, jouts[2])):
                assert g.shape == (B, 128, 128, 1)
                assert g.dtype == torch.float32
                assert np.array_equal(g.numpy(), np.asarray(w))


def test_gen_update_raw_lockstep():
    with enable_x64():
        jt, state, port = raw_pair()
        raw = raw_batch(5)
        (state, want, jouts), d = recorded(jt._gen_update_raw, state, *raw,
                                           jax.random.PRNGKey(3))
        got, (outs, ia, ib) = port.gen_update_raw(
            *raw, noise=dict(zip(("gen", "a2b", "b2a"), d)))
        check_metrics(got, want, "gen_update_raw")
        check_params(port, state, ("gen", "map", "dis"), "gen_update_raw")
        for g, w in zip(outs, jouts[0]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-10)
        met, none = port.gen_update_raw(*raw, with_viz=False)
        assert none is None and np.isfinite(float(met["gen_total_loss"]))


def test_post_update_raw_lockstep_modes_0_1_3_4():
    keys = {0: ["vae_a"], 1: ["vae_b"], 3: ["gen", "vae_a"],
            4: ["gen", "vae_a", "vae_b"]}
    with enable_x64():
        jt, state, port = raw_pair()
        for k, mode in enumerate((0, 1, 3, 4)):
            raw = raw_batch(10 + k, u16=mode == 3)
            (state, want, jouts), d = recorded(
                jt._post_update_raw, state, *raw, jax.random.PRNGKey(k),
                mode=mode)
            assert len(d) == len(keys[mode])
            got, (outs, ia, ib) = port.post_update_raw(
                *raw, mode=mode, noise=dict(zip(keys[mode], d)))
            what = f"post_update_raw mode {mode}"
            check_metrics(got, want, what)
            check_params(port, state, ("dis",), what)
            for g, w in zip(outs, jouts[0]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=0, atol=1e-10)
            assert np.array_equal(ia.numpy(), np.asarray(jouts[1]))


def test_train_map_decode_runs_without_dropout():
    """res_dropout_ratio 0.5 and train_map on: every dropout of the joint,
    a2b and b2a passes takes the JAX mask; the two train_map decodes
    (dis and gen update) draw none, as ``decode(train=False)`` in JAX."""
    with enable_x64():
        jt, state, port = pair(train_map=True,
                               gen={"res_dropout_ratio": 0.5})
        for k in range(2):
            data = batch(40 + k)
            (state, want, _), d, masks = recorded_with_masks(
                jt._pretrain_update, state, *data, jax.random.PRNGKey(k))
            assert masks, "the JAX step drew no dropout mask"
            with injected_dropout(masks):
                got, _ = port.pretrain_update(
                    *data, noise=pretrain_noise(d, True))
            what = f"dropout 0.5 train_map step {k}"
            check_metrics(got, want, what)
            check_params(port, state, ("dis", "gen", "map"), what)


def test_decode_train_flag():
    """``decode`` is dropout-free by default and with ``train=False``;
    ``train=True`` in training mode draws masks."""
    from lsps_tpu_torch.models.shared_gen import SharedResGen
    from torch_lockstep import hyp

    cfg = dict(hyp()["gen"], res_dropout_ratio=0.5)
    gen = SharedResGen(cfg).double().train()
    z = torch.randn(2, 32, 32, 16, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    a = gen.decode(z, generator=g)
    b = gen.decode(z, generator=g, train=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    state = g.get_state()
    c = gen.decode(z, generator=g, train=True)
    assert not torch.equal(g.get_state(), state)
    assert not torch.equal(a[0], c[0])
