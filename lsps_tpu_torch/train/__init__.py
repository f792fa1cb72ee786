from lsps_tpu_torch.train.trainer import LSPSTrainer  # noqa: F401
