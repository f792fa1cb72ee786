"""Data parallelism over ``torch.distributed`` (one process per rank)."""

from lsps_tpu_torch.parallel.mesh import DataMesh, RowDraws  # noqa: F401
from lsps_tpu_torch.parallel.multihost import (  # noqa: F401
    choose_backend, initialize, local_rows, rank_device)
