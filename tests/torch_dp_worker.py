"""One rank of the port's trainer-level data-parallel tests.

    python tests/torch_dp_worker.py SPEC OUT_DIR

run as a rank (``torch_dist.run_ranks``): builds the gloo group from the
environment, and for each case of ``SPEC`` (a ``torch.save``d dict written
by the test) builds an ``LSPSTrainer`` on the CPU with this rank's
``DataMesh`` and runs the case's actions (``run_case``), then writes what
it saw to ``OUT_DIR/rank<r>.pt``.  The tests run the same actions through
``run_case`` without a mesh, in one process, as the reference.  Imports
only torch and the port.
"""

import hashlib
import sys

import torch

from lsps_tpu_torch.train import LSPSTrainer
from lsps_tpu_torch.train.checkpoint import FullStateStore


def digest(trainer) -> str:
    """sha256 over the bytes of every parameter of the four nets."""
    h = hashlib.sha256()
    for v in trainer.nets.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_case(case: dict, mesh=None) -> dict:
    """Build the case's trainer (``hyp``, ``state_dict``, ``seed``,
    ``sch_interval``) and run its ``actions``, each ``(name, args,
    kwargs)``: a trainer method, or ``store_save`` / ``store_restore`` of
    a ``FullStateStore`` at ``args[0]``.  Returns, per action, the
    metrics (floats; None for a save or load) and the parameters' digest,
    and the final parameters."""
    torch.manual_seed(0)
    trainer = LSPSTrainer(case["hyp"], case["state_dict"],
                          sch_interval=case.get("sch_interval", 1000),
                          device="cpu", seed=case.get("seed", 0), mesh=mesh)
    rows = []
    for name, args, kw in case["actions"]:
        met = None
        if name == "store_save":
            FullStateStore(args[0]).save(trainer, *args[1:])
        elif name == "store_restore":
            FullStateStore(args[0]).restore(trainer)
        else:
            out = getattr(trainer, name)(*args, **kw)
            if isinstance(out, tuple) and isinstance(out[0], dict):
                met = {k: float(v) for k, v in out[0].items()}
        rows.append({"metrics": met, "digest": digest(trainer)})
    return {"actions": rows,
            "params": {k: v.detach().clone()
                       for k, v in trainer.nets.state_dict().items()}}


def main(spec_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from lsps_tpu_torch.parallel import DataMesh, initialize

    torch.set_num_threads(1)
    ok, reason = initialize(on_cuda=False)
    if not ok:
        raise RuntimeError(f"process group: {reason}")
    mesh = DataMesh.from_group("cpu")
    spec = torch.load(spec_path, weights_only=False)
    try:
        results = {name: run_case(case, mesh) for name, case in spec.items()}
        torch.save(results, f"{out_dir}/rank{mesh.rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
