"""One-command +-0.5 mm parity gate against the reference's released
checkpoints, on the port.

    python -m lsps_tpu_torch.scripts.parity_gate --config exps/nnyu.yaml \\
        --dis <pre_dis_*.pkl> --vae <pre_vae_*.pkl> [--expect <mm>]

The counterpart of ``scripts/parity_gate.py``: loads the released torch
``.pkl`` state_dicts strictly into the port's nets
(``train/torch_convert.load_torch_checkpoint``), runs the depth CLI's
test-set evaluation in mode 3 (``cli.depth_train.evaluate_estimation``,
reference depth_train.py:185-253, with the NYU 14-joint protocol when the
config is NYU) over the config's test dataset, and prints the mean mm
error.  With ``--expect`` (the reference's published number) it returns 0
when |ours - expected| <= ``--tolerance`` mm, else 1.

When a checkpoint or the dataset is missing, or the dataset fails to
load, it prints what is needed and returns 2: the released files are not
in the repository, and the same command runs the real gate the day they
are there.  Runs on CUDA device 0; ``--device cpu`` for the CPU.  The
evaluation's video and images go to ``./outputs/parity_gate``.
"""

from __future__ import annotations

import argparse
import os
import sys

from lsps_tpu_torch.cli import common as C
from lsps_tpu_torch.cli.depth_train import evaluate_estimation
from lsps_tpu_torch.config import NetConfig
from lsps_tpu_torch.data.loader import get_data_loader, get_dataset
from lsps_tpu_torch.train.torch_convert import load_torch_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--dis", required=True,
                   help="released pre_dis_*.pkl (or pre_est_dis_*.pkl)")
    p.add_argument("--vae", required=True,
                   help="released pre_vae_<frac>_*.pkl")
    p.add_argument("--gen", default=None,
                   help="optional pre_gen_*.pkl (not needed for eval)")
    p.add_argument("--expect", type=float, default=None,
                   help="reference mean mm error; gate = +-0.5 mm")
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    opts = p.parse_args(argv)

    missing = [f for f in (opts.dis, opts.vae, opts.gen)
               if f and not os.path.isfile(f)]
    if missing:
        print("MISSING checkpoints:\n  " + "\n  ".join(missing))
        print("Provide the released .pkl files "
              "(reference lsps_trainer.py:307-323 naming).")
        return 2

    device = C.device_of(opts)
    Evaluation, color_idx, bones = C.select_eval(opts.config)
    config = NetConfig(opts.config)

    test_spec = config.datasets.get("test_b")
    root = test_spec.get("root", "") if test_spec else ""
    if not root or not os.path.isdir(root):
        print(f"MISSING dataset: test_b root {root!r} does not exist.\n"
              "Point exps/*.yaml root: at the real NYU/ICVL layout "
              "(docs/REALDATA.md §1).")
        return 2

    try:
        dataset_test = get_dataset(test_spec)
    except Exception as e:
        print(f"Dataset load failed: {type(e).__name__}: {e}\n"
              "Check the layout against docs/REALDATA.md §1.")
        return 2

    trainer = C.make_trainer(config, sch_interval=1000, device=device,
                             init_seed=0, seed=0)
    load_torch_checkpoint(opts.dis, trainer.dis)
    load_torch_checkpoint(opts.vae, trainer.vae)
    if opts.gen:
        load_torch_checkpoint(opts.gen, trainer.gen)

    test_loader = get_data_loader(dataset_test, opts.batch_size,
                                  shuffle=False, device=device)
    image_dir = "./outputs/parity_gate"
    os.makedirs(image_dir, exist_ok=True)
    err, acc = evaluate_estimation(
        trainer, test_loader, dataset_test.di, Evaluation, color_idx, bones,
        image_dir, mode_idx=3, nyu_protocol="nyu" in opts.config)
    print(f"parity_gate: mean err {err:.4f} mm, {acc:.2f}% within 40 mm")

    if opts.expect is not None:
        delta = abs(err - opts.expect)
        ok = delta <= opts.tolerance
        print(f"parity_gate: |{err:.4f} - {opts.expect:.4f}| = "
              f"{delta:.4f} mm -> {'PASS' if ok else 'FAIL'} "
              f"(tolerance {opts.tolerance} mm)")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
