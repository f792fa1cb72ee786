"""Evaluation metrics of the port."""
from lsps_tpu_torch.eval.handpose_evaluation import (  # noqa: F401
    HandposeEvaluation, ICVLHandposeEvaluation, MSRAHandposeEvaluation,
    NYUHandposeEvaluation,
)
