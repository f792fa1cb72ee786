"""Typed config parsed from the reference YAML schema.

The port's own copy of ``lsps_tpu/config.py`` (yaml only): the YAML layout
is the one of ``exps/nnyu.yaml``; ``default_hyperparameters`` gives the
same dicts as the JAX package, so one hyperparameter dict builds both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import yaml


@dataclasses.dataclass
class DatasetSpec:
    seed: int = 23455
    class_name: str = ""
    root: str = ""
    subset: str = ""
    joint_subset: str = ""
    sample_poses: int = 0
    augment: bool = False
    docom: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetSpec":
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kw = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        return cls(extra=extra, **kw)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d


class NetConfig:
    """Mirrors the reference ``NetConfig`` attribute surface.

    Attributes mirror the keys of the ``train:`` YAML section:
    ``hyperparameters`` (dict), ``datasets`` (dict of DatasetSpec dicts),
    ``snapshot_prefix``, ``snapshot_save_iterations``,
    ``image_save_iterations``, ``image_display_iterations``, ``display``.
    """

    # defaults (cadences from reference exps/nnyu.yaml:4-7)
    snapshot_save_iterations: int = 25000
    image_save_iterations: int = 2500
    image_display_iterations: int = 100
    display: int = 10
    snapshot_prefix: str = "./outputs/exp/pre"

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, dict):
            doc = path_or_dict
        else:
            with open(path_or_dict, "r") as f:
                doc = yaml.safe_load(f)
        train = doc.get("train", doc)
        for k, v in train.items():
            setattr(self, k, v)
        if not hasattr(self, "hyperparameters"):
            raise ValueError("config missing 'hyperparameters'")
        self.hyperparameters = dict(self.hyperparameters)
        self.datasets = {
            k: DatasetSpec.from_dict(v).as_dict()
            for k, v in getattr(self, "datasets", {}).items()
        }

    @property
    def hyp(self) -> Dict[str, Any]:
        return self.hyperparameters


def load_config(path: str) -> NetConfig:
    return NetConfig(path)


class SettingConfig(NetConfig):
    """The reference's second name for ``NetConfig`` (net_config.py:29-40,
    the same class body), kept for its API surface."""


# ---------------------------------------------------------------------------
# Default hyperparameters (reference exps/nnyu.yaml:9-60); used by tests and
# synthetic runs so the framework works stand-alone without dataset files.
# ---------------------------------------------------------------------------

def default_hyperparameters(
    reg_dim: int = 108,
    ch: int = 64,
    small: bool = False,
) -> Dict[str, Any]:
    """Hyperparameter dict matching the reference's shipped YAMLs.

    ``small=True`` shrinks channel counts for fast tests (same topology).
    """
    if small:
        ch = 8
    return {
        "trainer": "LSPSTrainer",
        "lr": 0.0001,
        "ll_direct_link_w": 100,
        "kl_direct_link_w": 0.1,
        "ll_cycle_link_w": 100,
        "kl_cycle_link_w": 0.1,
        "ll_map_w": 1000,
        "ll_map_z_w": 1000,
        "gan_w": 10.0,
        "reg_w": 10.0,
        "feature_w": 0.001,
        "feature_w_reg": 10.0,
        "batch_size": 32,
        "train_map": False,
        "ll_loss_vae": 100,
        "kl_loss_vae": 0.1,
        "batch_size_pose": 64,
        "max_iterations": 500000,
        "map": {
            "name": "Mapping",
            "input_dim": 20,
            "output_dim": 32,
            "output_ch": 4 * ch,
        },
        "vae": {
            "name": "poseVAE",
            "input_dim": reg_dim,
            "z_dim": 20,
            "h_dim": 50,
        },
        "gen": {
            "name": "SharedResGen",
            "ch": ch,
            "input_dim_a": 1,
            "input_dim_b": 1,
            "n_enc_front_blk": 3,
            "n_enc_res_blk": 3,
            "n_enc_shared_blk": 1,
            "n_gen_shared_blk": 1,
            "n_gen_res_blk": 3,
            "n_gen_front_blk": 3,
        },
        "dis": {
            "name": "SharedDis",
            "ch": ch,
            "input_dim_a": 1,
            "input_dim_b": 1,
            "n_front_layer": 2,
            "n_shared_layer": 4,
            "reg_dim": reg_dim,
            "post_dim": 20,
        },
    }
