"""The plain reference of the LSPS benchmark: the nets (``nets``), the
pretrain iteration (``train_step``) and the serving chain (``serve``) in
plain PyTorch.  It imports nothing of the system under test, nor JAX."""
