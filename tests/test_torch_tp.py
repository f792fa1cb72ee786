"""The port's tensor parallelism (``parallel/mesh.py``) against the JAX
package's ``model`` axis (``lsps_tpu/parallel/mesh.py:26-33,80-111``).

1. ``tp_param_shardings`` places the same tensors as JAX's rule, mapped
   through the weight bridge's names and the torch layouts (dim 0 of a
   ``Conv2d`` kernel, dim 1 of a ``ConvTranspose2d`` kernel, never a 2-D
   ``Linear`` weight): on the JAX test's ``sequential(conv2d(8, 64),
   leaky, conv2d(64, 8))`` at ``min_out_ch=64`` and on a whole
   ``SharedDis`` at the widths of ``exps/nnyu.yaml`` at 512.
2. Gloo ranks (``tests/torch_tp_worker.py``) at ``(1, 2)`` and ``(2, 2)``:
   the sharded forward and every gradient equal the replicated module's
   within 1e-10 in float64, the gathered state dict is bit-equal, each
   rank holds its share of the split tensors, and the JAX TP forward of
   its own test on its 4 x 2 CPU mesh equals the port's within 1e-5 in
   float32.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_dist import run_ranks

from lsps_tpu.config import default_hyperparameters
from lsps_tpu.models import build_model as jax_build
from lsps_tpu.ops import layers as JL
from lsps_tpu.parallel import make_mesh as jax_mesh
from lsps_tpu.parallel import shard_state_tp as jax_shard
from lsps_tpu.parallel import tp_param_shardings as jax_rule
from lsps_tpu_torch.config import default_hyperparameters as port_hyp
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.ops import layers as PL
from lsps_tpu_torch.parallel import tp_param_shardings
from lsps_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5


def _jax_placement(mesh, params, min_out_ch):
    """JAX's shardings as {port parameter name: split dim or None}."""
    sh = jax_rule(mesh, params, min_out_ch)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            sh, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaf = keys[-1]
        name = ".".join(keys[:-1] + ["bias" if leaf == "b" else "weight"])
        spec = s.spec
        if spec == P():
            out[name] = None
        elif spec == P("model"):
            out[name] = 0
        elif spec == P(None, None, None, "model"):
            out[name] = 1 if leaf == "wt" else 0
        else:
            raise AssertionError(f"unexpected spec {spec} at {name}")
    return out


def test_placement_matches_jax_on_the_jax_tests_net():
    mesh = jax_mesh(n_data=4, n_model=2)
    net = JL.sequential(JL.conv2d(8, 64, 3, 1, 1), JL.leaky_relu_layer(),
                        JL.conv2d(64, 8, 3, 1, 1))
    params = net.init(jax.random.PRNGKey(0))
    port = torch.nn.Sequential(PL.Conv2d(8, 64, 3, 1, 1), PL.LeakyReLU(),
                               PL.Conv2d(64, 8, 3, 1, 1))
    port.load_state_dict(from_jax_params(params), strict=True)
    got = tp_param_shardings(SimpleNamespace(shape={"data": 4, "model": 2}),
                             port, min_out_ch=64)
    assert got == _jax_placement(mesh, params, 64)
    assert got == {"0.weight": 0, "0.bias": 0, "2.weight": None,
                   "2.bias": None}


def test_placement_matches_jax_on_nnyu_shared_dis():
    mesh = jax_mesh(n_data=4, n_model=2)
    params = jax_build(default_hyperparameters()["dis"]).init(
        jax.random.PRNGKey(0))
    port = build_model(port_hyp()["dis"])
    port.load_state_dict(from_jax_params(params), strict=True)
    got = tp_param_shardings(SimpleNamespace(shape={"data": 4, "model": 2}),
                             port)
    assert got == _jax_placement(mesh, params, 512)
    split = {k for k, d in got.items() if d is not None}
    assert split == {f"model_S.{i}.0.{n}" for i in range(1, 4)
                     for n in ("weight", "bias")}
    nbytes = sum(p.numel() * 4 for k, p in port.named_parameters()
                 if k in split and k.endswith("weight"))
    assert 98e6 < nbytes < 100e6   # the three wide convs, ~99 MB float32


def test_placement_in_torch_layouts():
    mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    m = torch.nn.Sequential(PL.ConvTranspose2d(16, 64, 3, 2, 1, 1),
                            PL.ConvTranspose2d(64, 16, 3, 2, 1, 1),
                            PL.Linear(8, 64), PL.Conv2d(8, 66, 1),
                            PL.Conv2d(8, 62, 1))
    assert tp_param_shardings(mesh, m, 64) == {
        "0.weight": 1, "0.bias": 0,        # IOHW: the output dim is 1
        "1.weight": None, "1.bias": None,  # 64 inputs, 16 outputs
        "2.weight": None, "2.bias": 0,     # a Linear weight never splits
        "3.weight": 0, "3.bias": 0, "4.weight": None, "4.bias": None}
    # a state dict of moments keyed alike, read as Conv2d kernels
    moments = {k: torch.zeros_like(v) for k, v in m.state_dict().items()}
    got = tp_param_shardings(mesh, moments, 64)
    assert got["3.weight"] == 0 and got["2.bias"] == 0
    assert got["2.weight"] is None
    one = SimpleNamespace(shape={"data": 4, "model": 1})
    assert set(tp_param_shardings(one, m, 1).values()) == {None}


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """The JAX test's TP forward on the 4 x 2 CPU mesh (float32)."""
    mesh = jax_mesh(n_data=4, n_model=2)
    net = JL.sequential(JL.conv2d(8, 64, 3, 1, 1), JL.leaky_relu_layer(),
                        JL.conv2d(64, 8, 3, 1, 1))
    params = net.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(4, 16, 16, 8).astype(np.float32)
    y = jax.jit(net.apply)(jax_shard(mesh, params, min_out_ch=64),
                           jnp.asarray(x))
    path = tmp_path_factory.mktemp("jax_tp") / "tp.npz"
    np.savez(path, x=np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
             y_tp=np.ascontiguousarray(np.asarray(y).transpose(0, 3, 1, 2)),
             **{f"sd/{k}": v.numpy()
                for k, v in from_jax_params(params).items()})
    return str(path)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)],
                         ids=["1x2", "2x2"])
def test_tp_ranks_equal_the_replicated_modules(n_data, n_model, jax_tp,
                                               tmp_path):
    world = n_data * n_model
    ranks = run_ranks(["tests/torch_tp_worker.py", str(tmp_path),
                       str(n_data), str(n_model), jax_tp], world=world,
                      timeout=240)
    for r, rk in enumerate(ranks):
        assert rk.returncode == 0, f"rank {r}:\n{rk.stderr[-4000:]}"
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]
    for r, o in enumerate(outs):
        assert (o["data_index"], o["model_index"]) == divmod(r, n_model)
        cases = ["tpnet"] + (["shared_dis"] if n_data == 1 else [])
        for case in cases:
            c = o[case]
            assert c["state_bit_equal"], (r, case)
            assert c["forward"] <= F64_TOL, (r, case, c)
            assert c["grad_rel"] <= F64_TOL, (r, case, c)
        assert outs[r]["tpnet"]["split"] == [
            "body.2.bias", "body.2.weight", "body.3.bias", "body.3.weight",
            "body.4.bias", "body.6.bias", "body.6.weight", "head.bias"]
        if n_data == 1:
            sd = o["shared_dis"]
            assert len(sd["split"]) == 6
            # each rank keeps half of the ~24.8 M split parameters
            assert sd["params"] - sd["local_params"] == pytest.approx(
                24.77e6 / 2, rel=0.01)
        j = o["jax_f32"]
        assert j["forward"] <= F32_TOL * max(1.0, j["scale"]), (r, j)
