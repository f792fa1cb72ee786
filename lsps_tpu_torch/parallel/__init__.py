"""Data and tensor parallelism over ``torch.distributed`` (one process
per rank)."""

from lsps_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, Mesh, RowDraws, gather_state_dict, make_mesh, shard_state_tp,
    tp_param_shardings)
from lsps_tpu_torch.parallel.multihost import (  # noqa: F401
    choose_backend, initialize, local_rows, rank_device)
