"""LSPS in PyTorch and CUDA for an NVIDIA H100: depth -> pose serving and
the VAE-GAN training updates.

A second implementation of ``lsps_tpu`` (the JAX reference) that imports
neither JAX nor ``lsps_tpu``.  Public functions keep the reference's
layouts: crops ``(B, 128, 128, 1)`` NHWC, frames ``(B, H, W)``, joints
``(B, J, 3)``.  Every TPU kernel of the reference is a CUDA kernel
written for ``sm_90a`` (``csrc/``), with a plain PyTorch version beside it
that runs only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    With no CUDA device and none named this raises, so that a missing card
    never turns into a silent run on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
