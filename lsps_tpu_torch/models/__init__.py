from lsps_tpu_torch.models.pose_vae import PoseVAE  # noqa: F401
from lsps_tpu_torch.models.shared_dis import SharedDis  # noqa: F401

from lsps_tpu_torch.registry import lookup as _lookup


def build_model(cfg: dict):
    """Instantiate a model from a config dict with a ``name`` key."""
    return _lookup("model", cfg["name"])(cfg)
