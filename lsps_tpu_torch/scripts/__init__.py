"""The system's own tools on the port: the counterparts of the repository's
``scripts/realtime_demo.py``, ``scripts/eval_checkpoints.py`` and
``scripts/parity_gate.py``, each run as ``python -m
lsps_tpu_torch.scripts.<name>`` on CUDA device 0 (``--device cpu`` for the
CPU)."""
