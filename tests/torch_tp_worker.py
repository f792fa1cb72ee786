"""One CPU rank of ``tests/test_torch_tp.py``, started by
``torch_dist.run_ranks``.

    python tests/torch_tp_worker.py OUT_DIR N_DATA N_MODEL [JAX_NPZ]

On a ``(N_DATA, N_MODEL)`` mesh over gloo it holds the port's tensor
parallelism against the replicated modules, each rank taking its data
row's block of a global batch:

* ``TPNet`` (float64, ``min_out_ch=64``): a conv whose kernel splits on
  dim 0, a transposed conv that splits on dim 1 (its dim 0 is too narrow),
  a BatchNorm and a Bias2d whose vectors are gathered before use, a
  replicated conv and a Linear whose bias alone splits.  The replicated
  module runs on each data row's block, so BatchNorm takes that block's
  statistics, as each data rank's does;
* with ``N_DATA == 1``, ``SharedDis`` at the widths of ``exps/nnyu.yaml``
  (float64, ``min_out_ch=512``): ``regress_b`` at batch 2;
* with ``JAX_NPZ``, the JAX package's TP forward of its own test's net on
  its 4 x 2 mesh (float32), against the port's.

For each: the gathered state dict bit for bit the replicated one, the
forward and, after the data ranks' mean, every gradient (the rank's block
of a split tensor), each gap over the module's largest gradient, within
1e-10 of the replicated module's.  Writes
``rank<r>.json``.
"""

import copy
import json
import os
import sys

import numpy as np
import torch
from torch import nn

from lsps_tpu_torch.ops import common_net as C
from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.parallel import (gather_state_dict, initialize,
                                     local_rows, make_mesh, shard_state_tp)

F64_TOL = 1e-10


class TPNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(
            L.Conv2d(8, 16, 3, 1, 1), L.LeakyReLU(),
            L.ConvTranspose2d(16, 64, 3, 2, 1, 1),
            C.BatchNorm(64), C.Bias2d(64), L.LeakyReLU(),
            L.Conv2d(64, 64, 3, 1, 1), L.LeakyReLU(),
            L.Conv2d(64, 8, 3, 1, 1))
        self.head = L.Linear(8, 64)

    def forward(self, x):
        y = self.body(x)
        return y, self.head(y.mean((2, 3)))


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int64 if a.element_size() == 8 else torch.int32),
        b.view(torch.int64 if b.element_size() == 8 else torch.int32))


def _block(t, dim, mesh):
    size = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_index * size, size)


def _worst(got, want):
    return float((got - want).detach().abs().max()) if got.numel() else 0.0


def check(mesh, ref, run, x, min_out_ch):
    """Shard a copy of ``ref``; returns the worst gaps of the forward and
    the gradients, whether the gathered state is bit-equal, and the split
    names."""
    tp = copy.deepcopy(ref)
    dims = shard_state_tp(mesh, tp, min_out_ch)
    full = gather_state_dict(mesh, tp)
    same = all(_bits_equal(full[k], v) for k, v in ref.state_dict().items())
    # the replicated module on each data row's block (BatchNorm takes the
    # block's statistics, as each data rank's does), its losses averaged
    n_data = mesh.shape["data"]
    wants = [run(ref, local_rows(x, d, n_data)) for d in range(n_data)]
    got = run(tp, mesh.data.local_rows(x))
    fwd = max(_worst(g, w) for g, w in zip(got, wants[mesh.data_index]))
    (sum(w.square().mean() for ws in wants for w in ws) / n_data).backward()
    sum(g.square().mean() for g in got).backward()
    grads = [p.grad for p in tp.parameters()]
    mesh.data.allreduce_mean_(grads)
    want_g = dict(ref.named_parameters())
    # gaps over the largest gradient of the module: a bias that feeds a
    # BatchNorm has a gradient of rounding size, which no relative
    # measure of its own can hold
    scale = max(float(p.grad.abs().max()) for p in ref.parameters()
                if p.grad is not None)
    gap = 0.0
    for k, p in tp.named_parameters():
        w = want_g[k].grad
        if w is None:      # a head the forward does not reach
            assert p.grad is None, k
            continue
        if dims[k] is not None:
            w = _block(w, dims[k], mesh)
        gap = max(gap, _worst(p.grad, w) / scale)
    return {"forward": fwd, "grad_rel": gap, "state_bit_equal": same,
            "split": sorted(k for k, d in dims.items() if d is not None),
            "local_params": sum(p.numel() for p in tp.parameters()),
            "params": sum(p.numel() for p in ref.parameters())}


def main(out_dir, n_data, n_model, jax_npz=None):
    torch.set_num_threads(1)
    ok, reason = initialize(backend="gloo", on_cuda=False)
    if not ok:
        raise RuntimeError(reason)
    mesh = make_mesh(int(n_data), int(n_model), device="cpu")
    out = {"rank": mesh.rank, "data_index": mesh.data_index,
           "model_index": mesh.model_index}

    torch.manual_seed(0)
    ref = TPNet().double()
    L.reset_parameters(ref, torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 8, 6, 6))
    out["tpnet"] = check(mesh, ref, lambda m, xx: m(xx), x, 64)

    if mesh.shape["data"] == 1:
        from lsps_tpu_torch.config import load_config
        from lsps_tpu_torch.models import build_model

        hyp = load_config(os.path.join(os.path.dirname(__file__), "..",
                                       "exps", "nnyu.yaml")).hyperparameters
        dis = build_model(hyp["dis"]).double()
        L.reset_parameters(dis, torch.Generator().manual_seed(3))
        xb = torch.from_numpy(np.random.RandomState(4).uniform(
            -1, 1, (2, 128, 128, 1)))
        out["shared_dis"] = check(mesh, dis,
                                  lambda m, xx: m.regress_b(xx)[:1], xb, 512)

    if jax_npz:
        z = np.load(jax_npz)
        net = nn.Sequential(L.Conv2d(8, 64, 3, 1, 1), L.LeakyReLU(),
                            L.Conv2d(64, 8, 3, 1, 1))
        net.load_state_dict({k[len("sd/"):]: torch.from_numpy(z[k])
                             for k in z.files if k.startswith("sd/")},
                            strict=True)
        shard_state_tp(mesh, net, 64)
        xj = torch.from_numpy(z["x"])
        with torch.no_grad():
            y = net(mesh.data.local_rows(xj))
        want = mesh.data.local_rows(torch.from_numpy(z["y_tp"]))
        out["jax_f32"] = {"forward": _worst(y, want),
                          "scale": float(want.abs().max())}

    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
