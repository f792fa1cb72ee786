"""The port's loader of the reference's released PyTorch checkpoints
(``lsps_tpu_torch.train.torch_convert``) against the JAX package's.

No released checkpoint is in the repository, so the checkpoints are the
state_dicts of the reference-layout torch nets that
``tests/test_full_model_torch_parity.py`` composes (the reference's module
names, wrapper ``model`` Sequentials included), seeded, written with
``torch.save`` as ``.pkl`` files, as the reference saves them.

1. Each net's file loads strictly into the port's module, and both give
   the same forwards in float64 (to 1e-12: the same operations, summed in
   the same library).
2. The same float32 file through the JAX package's ``convert_state_dict``
   and ``from_jax_params`` gives the port's loaded tensors bit for bit.
3. A stray or a missing key, or a shape that differs, raises and names
   it (``load_state_dict(strict=True)``'s ``RuntimeError``); two keys that
   map to one name raise; a pickled whole module needs
   ``weights_only=False``.
4. ``to_state_dict(like=)`` writes the port's weights back in the
   reference's spelling, which its net loads strictly.
"""

import re

import numpy as np
import pytest
import torch

import jax

from lsps_tpu.models import build_model as jax_build
from lsps_tpu.train.torch_convert import convert_state_dict as jax_convert
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.train import torch_convert as T
from lsps_tpu_torch.weights import from_jax_params
from test_full_model_torch_parity import (CH, HYP, TorchMapping,
                                          TorchPoseVAE, TorchSharedDis,
                                          TorchSharedResGen)

torch.set_num_threads(1)

TOL = 1e-12


def _reference(net):
    """The reference-layout torch net behind HYP[net], seeded."""
    torch.manual_seed({"vae": 0, "dis": 1, "gen": 2, "map": 3}[net])
    if net == "vae":
        v = HYP["vae"]
        return TorchPoseVAE(v["input_dim"], v["z_dim"], v["h_dim"]).eval()
    if net == "dis":
        d = HYP["dis"]
        return TorchSharedDis(CH, d["n_front_layer"], d["n_shared_layer"],
                              d["post_dim"]).eval()
    if net == "gen":
        g = HYP["gen"]
        return TorchSharedResGen(CH, g["n_enc_front_blk"], g["n_enc_res_blk"],
                                 g["n_enc_shared_blk"], g["n_gen_shared_blk"],
                                 g["n_gen_res_blk"],
                                 g["n_gen_front_blk"]).eval()
    return TorchMapping(HYP["map"]["input_dim"], HYP["map"]["output_ch"]
                        ).eval()


def _pkl(tmp_path, net, dtype):
    ref = _reference(net).to(dtype)
    path = str(tmp_path / f"{net}.pkl")
    torch.save(ref.state_dict(), path)
    return ref, path


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _forwards(net, ref, port):
    """Pairs of (reference output, port output) over the net's public
    forwards, float64, no gradients; the port in eval mode."""
    g = torch.Generator().manual_seed(5)
    rand = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    with torch.no_grad():
        if net == "vae":
            y = rand(4, HYP["vae"]["input_dim"]) * 0.4
            mu, sd = ref.encode(y)
            _, pmu, psd = port.encode(y)
            return [(mu, pmu), (sd, psd), (ref.decode(mu), port.decode(mu))]
        if net == "dis":
            xa, xb = rand(2, 1, 128, 128) * 0.3, rand(2, 1, 128, 128) * 0.3
            da, db, fa, fb = ref(xa, xb)
            pda, pdb, pfa, pfb = port(_nhwc(xa), _nhwc(xb))
            return [(da, pda), (db, pdb), (_nhwc(fa), pfa), (_nhwc(fb), pfb),
                    (ref.regress_a(xa), port.regress_a(_nhwc(xa))[1]),
                    (ref.regress_b(xb), port.regress_b(_nhwc(xb))[1])]
        if net == "gen":
            xa, xb = rand(2, 1, 32, 32) * 0.3, rand(2, 1, 32, 32) * 0.3
            outs = ref(xa, xb)
            pouts = port(_nhwc(xa), _nhwc(xb))
            dec, pdec = ref.decode(outs[4]), port.decode(_nhwc(outs[4]))
            a2b, pa2b = ref.forward_a2b(xa), port.forward_a2b(_nhwc(xa))
            return ([(_nhwc(o), p) for o, p in zip(outs, pouts)]
                    + [(_nhwc(d), p) for d, p in zip(dec, pdec)]
                    + [(_nhwc(o), p) for o, p in zip(a2b, pa2b)])
        z = rand(3, HYP["map"]["input_dim"]) * 0.5
        return [(_nhwc(ref(z)), port(z))]


@pytest.mark.parametrize("net", ["vae", "dis", "gen", "map"])
def test_reference_pkl_loads_strictly_same_forward(tmp_path, net):
    ref, path = _pkl(tmp_path, net, torch.float64)
    port = build_model(HYP[net]).double().eval()
    assert T.load_torch_checkpoint(path, port) is port
    for i, (want, got) in enumerate(_forwards(net, ref, port)):
        assert got.shape == want.shape, i
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL,
                                   msg=f"{net} output {i}")


@pytest.mark.parametrize("net", ["vae", "dis", "gen", "map"])
def test_same_tensors_as_jax_converter(tmp_path, net):
    _, path = _pkl(tmp_path, net, torch.float32)
    port = T.load_torch_checkpoint(path, build_model(HYP[net]))
    sd = torch.load(path, weights_only=True)
    tree = jax_convert(sd, jax_build(HYP[net]).init(jax.random.PRNGKey(0)))
    via_jax = from_jax_params(tree)
    got = port.state_dict()
    assert set(via_jax) == set(got)
    for k, v in via_jax.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fault", ["stray", "missing", "shape"])
def test_bad_checkpoints_raise_and_name_the_key(tmp_path, fault):
    ref = _reference("vae")
    sd = dict(ref.state_dict())
    if fault == "stray":
        sd["de_fc1.model.0.extra"] = torch.zeros(2)
        what, key = "Unexpected key", "de_fc1.0.extra"
    elif fault == "missing":
        del sd["de_fc2.bias"]
        what, key = "Missing key", "de_fc2.bias"
    else:
        sd["en_mu.weight"] = torch.zeros(3, 3)
        what, key = "size mismatch", "en_mu.weight"
    path = str(tmp_path / "bad.pkl")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match=f"{what}.*{re.escape(key)}"):
        T.load_torch_checkpoint(path, build_model(HYP["vae"]))


def test_two_keys_to_one_name_raise():
    sd = {"en_mu.model.weight": torch.zeros(1),
          "en_mu.weight": torch.zeros(1)}
    with pytest.raises(ValueError, match="en_mu.weight"):
        T.convert_state_dict(sd)


def test_whole_module_pickle_needs_weights_only_false(tmp_path):
    ref = _reference("vae").double()
    path = str(tmp_path / "module.pkl")
    torch.save(ref, path)
    port = build_model(HYP["vae"]).double()
    with pytest.raises(Exception, match="[Ww]eights only"):
        T.load_torch_checkpoint(path, port)
    T.load_torch_checkpoint(path, port, weights_only=False)
    for (want, got) in _forwards("vae", ref, port):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("net", ["dis", "gen"])
def test_to_state_dict_back_into_the_reference(net):
    port = build_model(HYP[net])
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    ref = _reference(net)
    back = T.to_state_dict(port, like=ref.state_dict())
    assert set(back) == set(ref.state_dict())
    ref.load_state_dict(back, strict=True)
    again = T.convert_state_dict(ref.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(again[k], v), k
    assert np.all([k.endswith(("weight", "bias")) for k in back])
