"""Shared discriminator + posterior regressor.

Counterpart of ``lsps_tpu/models/shared_dis.py``.  Per-domain conv fronts
(7x7 s2 + stride-2 convs), a shared trunk of stride-2 convs, and two
heads: ``D`` (1x1 conv real/fake logits) and ``Post`` (2x2 conv ->
posterior code).  ``regress_a``/``regress_b`` are the deployed encoder.

Public methods take and return NHWC, as the JAX package does; the modules
run NCHW inside, and flattened outputs follow the NHWC order.
"""

from __future__ import annotations

import torch
from torch import nn

from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.registry import register


def _front_net(ch, input_dim, n_layer):
    lays = [L.LeakyReLUConv2d(input_dim, ch, 7, 2, 3)]
    tch = ch
    for _ in range(1, n_layer):
        lays.append(L.LeakyReLUConv2d(tch, tch * 2, 3, 2, 1))
        tch *= 2
    return nn.Sequential(*lays), tch


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _flat_nhwc(x: torch.Tensor) -> torch.Tensor:
    return _nhwc(x).reshape(x.shape[0], -1)


@register("model", "SharedDis")
class SharedDis(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch = cfg["ch"]
        n_front = cfg["n_front_layer"]
        n_expand = cfg.get("n_expand_layer", 0)
        n_shared = cfg["n_shared_layer"]
        self.post_dim = cfg["post_dim"]
        self.reg_dim = cfg["reg_dim"]

        self.model_A, tch = _front_net(ch, cfg["input_dim_a"], n_front)
        self.model_B, _ = _front_net(ch, cfg["input_dim_b"], n_front)

        shared = []
        for _ in range(n_expand):
            shared.append(L.LeakyReLUConv2d(tch, tch * 2, 3, 1, 1))
            tch *= 2
        for _ in range(n_shared):
            shared.append(L.LeakyReLUConv2d(tch, tch * 2, 3, 2, 1))
            tch *= 2
        self.model_S = nn.Sequential(*shared)
        self.D = L.Conv2d(tch, 1, 1, 1, 0)
        self.Post = L.Conv2d(tch, self.post_dim, 2, 1, 0)

    def _regress(self, front: nn.Module, x: torch.Tensor):
        post = _flat_nhwc(self.Post(self.model_S(front(_nchw(x)))))
        return post, post, post

    def regress_a(self, x_a: torch.Tensor):
        """Posterior code from domain-A crops (B, H, W, 1).
        Returns (post, post, post) for API parity."""
        return self._regress(self.model_A, x_a)

    def regress_b(self, x_b: torch.Tensor):
        """Posterior code from domain-B crops (B, H, W, 1)."""
        return self._regress(self.model_B, x_b)

    def _trunk(self, x_a: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
        f = torch.cat([self.model_A(_nchw(x_a)), self.model_B(_nchw(x_b))])
        return self.model_S(f)

    def feats(self, x_aa, x_ba, x_ab, x_bb):
        """Shared-trunk feature taps (NHWC) for feature matching.
        Returns 4 equal batch splits."""
        f = _nhwc(self._trunk(torch.cat([x_aa, x_ba]),
                              torch.cat([x_ab, x_bb])))
        n = f.shape[0] // 4
        return f[:n], f[n:2 * n], f[2 * n:3 * n], f[3 * n:]

    def forward(self, x_A: torch.Tensor, x_B: torch.Tensor):
        """Joint discriminator pass.
        Returns (out_D_A flat, out_D_B flat, feats_A, feats_B)."""
        f = self._trunk(x_A, x_B)
        out_d = _flat_nhwc(self.D(f))
        n = f.shape[0] // 2
        f = _nhwc(f)
        return (out_d[:n].reshape(-1), out_d[n:].reshape(-1), f[:n], f[n:])
