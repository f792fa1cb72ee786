"""The port has every public name of the JAX package, and the last small
ones behave as the JAX package's.

``test_no_public_name_is_missing`` parses both packages (``ast``, nothing
imported) and lists, module by module, the public top-level names of
``lsps_tpu`` (functions, classes, assignments without a leading
underscore) that the port's module of the same path neither defines nor
imports.  What is left must be exactly the JAX-only machinery named in
``JAX_ONLY_MODULES`` and ``JAX_ONLY_NAMES``, each with the reason it has
no counterpart of that name: a name the port gains leaves the list stale,
and a name the JAX package gains and the port lacks fails, so the surface
stays whole.

Then ``utils.logging.StepTimer``, ``config.SettingConfig`` and
``registry.registered`` beside the JAX package's (the JAX behaviour is
``tests/test_aux_subsystems.py::test_step_timer``).
"""

import ast
import os
import time

import pytest

from lsps_tpu import config as jconfig
from lsps_tpu import registry as jregistry
from lsps_tpu.utils import logging as jlogging
from lsps_tpu_torch import config as pconfig
from lsps_tpu_torch import registry as pregistry
from lsps_tpu_torch.utils import logging as plogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX modules with no module of the same path in the port
JAX_ONLY_MODULES = {
    "ops/pallas/__init__.py": "Pallas TPU kernels; the port's CUDA kernels "
                              "and their plain versions are ops/kernels/",
    "ops/pallas/norm_act.py": "Pallas InstanceNorm kernels; the port's are "
                              "ops/kernels/norm_act.py (csrc/norm_act.cu)",
    "ops/pallas/warp.py": "the Pallas crop warp; the port's is "
                          "ops/kernels/warp.py (csrc/warp.cu)",
    "serve/detect_jax.py": "XLA device detection; the port's is "
                           "serve/detect.py",
    "serve/preprocess_jax.py": "XLA crop math; the port's is "
                               "serve/preprocess.py and ops/kernels/warp.py",
    "data/augment_jax.py": "the XLA training augment; the port's is "
                           "data/augment.py",
    "utils/benchutil.py": "TPU v5e peak FLOP/s and XLA cost analysis",
}

_FUNCTIONAL_LAYERS = (
    "GaussianVAE2DHead", "GaussianVAEHead", "Layer", "batch_norm_layer",
    "bias2d", "conv2d", "conv2d_transpose", "dropout_layer",
    "fused_in_layer", "fused_in_lrelu_layer", "gaussian_conv_init",
    "gaussian_noise_layer", "gaussian_smoother", "ins_res_block",
    "instance_norm_layer", "leaky_ins_res_block", "leaky_ins_resnext_block",
    "leaky_relu_bn_conv2d", "leaky_relu_bn_conv_transpose2d",
    "leaky_relu_bn_linear", "leaky_relu_bnns_conv2d",
    "leaky_relu_bnns_conv_transpose2d", "leaky_relu_bnns_res_block",
    "leaky_relu_conv2d", "leaky_relu_conv_transpose2d",
    "leaky_relu_ins_conv2d", "leaky_relu_ins_conv_transpose2d",
    "leaky_relu_layer", "leaky_relu_linear", "leaky_relu_res_block",
    "linear", "noop_layer", "relu_ins_conv2d", "relu_ins_conv_transpose2d",
    "relu_layer", "residual", "sequential", "tanh_layer",
    "torch_uniform_init")

# names of a module both packages have: (names, why the port has none)
JAX_ONLY_NAMES = {
    "ops/layers.py": (_FUNCTIONAL_LAYERS,
                      "init/apply builders over parameter pytrees; the "
                      "port's layers are torch.nn modules (Conv2d, "
                      "LeakyINSResBlock, ...)"),
    "serve/export.py": (("MAGIC",),
                        "the header of the JAX package's own artifact "
                        "format; the port's artifacts are torch.export "
                        "programs"),
    "parallel/mesh.py": (("batch_sharding", "pjit_update", "replicated",
                          "shard_batch", "shard_state"),
                         "jax.sharding and pjit over one process's devices;"
                         " the port's ranks are processes (DataMesh)"),
    "parallel/multihost.py": (("global_batch_from_host_shards",),
                              "a global jax.Array from per-host shards; "
                              "each port rank takes its rows of the global "
                              "batch (local_rows)"),
    "train/checkpoint.py": (("CheckpointManager", "OrbaxStateStore",
                             "Pytree", "load_pytree", "save_pytree"),
                            "pytree files and orbax; the port's are module "
                            "functions (save, resume, load_vae) and "
                            "FullStateStore"),
    "train/optim.py": (("adam_multistep",),
                       "an optax chain; the port's is AdamMultiStep"),
    "train/trainer.py": (("Pytree", "TrainState", "cast_tree",
                          "zeroed_subtrees"),
                         "functional train-state pytrees; the port's "
                         "trainer holds modules and updates in place"),
    "cli/common.py": (("fold_chain", "host_fold_in"),
                      "jax.random key folding; the port draws from the "
                      "trainer's torch.Generator"),
}


def _public(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _bound(path):
    """Every name a module binds at top level, imports included."""
    names = _public(path)
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _missing():
    jax_root = os.path.join(REPO, "lsps_tpu")
    modules, names = set(), {}
    for dirpath, _, files in os.walk(jax_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jax_root)
            port = os.path.join(REPO, "lsps_tpu_torch", rel)
            if not os.path.isfile(port):
                modules.add(rel)
                continue
            gone = _public(os.path.join(jax_root, rel)) - _bound(port)
            if gone:
                names[rel] = gone
    return modules, names


def test_no_public_name_is_missing():
    modules, names = _missing()
    assert modules == set(JAX_ONLY_MODULES)
    assert names == {k: set(v) for k, (v, _) in JAX_ONLY_NAMES.items()}


@pytest.mark.parametrize("mod", [jlogging, plogging], ids=["jax", "port"])
def test_step_timer(mod, monkeypatch):
    clock = iter([100.0, 102.0, 102.0, 103.0, 103.0])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    t = mod.StepTimer()
    t.tick(10)
    assert t.window() == (2.0, 5.0)
    assert t.steps == 0
    t.tick()
    t.tick(2)
    assert t.window() == (1.0, 3.0)


def test_step_timer_without_time_passing(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 7.0)
    for mod in (jlogging, plogging):
        t = mod.StepTimer()
        t.tick(4)
        assert t.window() == (0.0, 0.0)


def test_setting_config_is_net_config():
    path = os.path.join(REPO, "exps", "synth.yaml")
    got, want = pconfig.SettingConfig(path), jconfig.SettingConfig(path)
    assert issubclass(pconfig.SettingConfig, pconfig.NetConfig)
    assert isinstance(got, pconfig.NetConfig)
    assert got.hyperparameters == want.hyperparameters
    assert got.datasets == want.datasets
    for k in ("snapshot_prefix", "snapshot_save_iterations",
              "image_save_iterations", "image_display_iterations",
              "display"):
        assert getattr(got, k) == getattr(want, k)


def test_registered_lists_each_table_as_jax_does():
    import lsps_tpu.data.datasets  # noqa: F401
    import lsps_tpu.data.synthetic  # noqa: F401
    import lsps_tpu.models  # noqa: F401
    import lsps_tpu.train.trainer  # noqa: F401
    import lsps_tpu_torch.data.datasets  # noqa: F401
    import lsps_tpu_torch.data.synthetic  # noqa: F401
    import lsps_tpu_torch.models  # noqa: F401
    import lsps_tpu_torch.train.trainer  # noqa: F401

    for kind in ("model", "dataset", "importer", "trainer"):
        got = pregistry.registered(kind)
        assert got and set(got) == set(jregistry.registered(kind))
        assert all(pregistry.lookup(kind, k) is v for k, v in got.items())
        got.clear()  # a copy: the table keeps its entries
        assert pregistry.registered(kind)
    assert pregistry.registered("no such kind") == {}
