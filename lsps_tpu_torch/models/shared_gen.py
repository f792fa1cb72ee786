"""UNIT-style dual-domain VAE-GAN generators with a shared latent space.

Counterpart of ``lsps_tpu/models/shared_gen.py``.  Per-domain conv
encoders feed shared residual blocks; additive N(0, 1) noise closes
``enc_shared`` in training; per-domain deconv decoders reconstruct both
domains.  ``SharedResGen`` is built from ``LeakyINSResBlock``s (whose
IN + LeakyReLU is the CUDA kernel pair on the card), ``SharedResXGen``
from ``LeakyINSResNeXtBlock``s.

Public tensors are NHWC, as in the JAX package; the modules run NCHW
inside.  Every ``noise`` argument is a standard-normal draw of the shared
code's NHWC shape; where it is None (in training) it is drawn from
``generator``.  Noise and dropout are active only in training mode
(``module.train()``), as ``train=True`` makes them in the JAX package;
``decode`` takes the JAX signature's ``train`` flag, off by default, and
runs without dropout unless it is set.  Dropout masks
(``res_dropout_ratio > 0``) are always drawn from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.registry import register


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _enc_front(input_dim, ch, n_front):
    lays = [L.LeakyReLUConv2d(input_dim, ch, 7, 1, 3)]
    tch = ch
    for _ in range(1, n_front):
        lays.append(L.LeakyReLUConv2d(tch, tch * 2, 3, 2, 1))
        tch *= 2
    return lays, tch


class _SharedGenBase(nn.Module):
    """Common structure; a subclass picks the residual block."""

    def _res_block(self, tch, dropout):
        raise NotImplementedError

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = dict(cfg)
        ch = cfg["ch"]
        dropout = cfg.get("res_dropout_ratio", 0)
        in_a, in_b = cfg["input_dim_a"], cfg["input_dim_b"]
        n_enc_front = cfg["n_enc_front_blk"]

        enc_a, tch = _enc_front(in_a, ch, n_enc_front)
        enc_b, _ = _enc_front(in_b, ch, n_enc_front)
        for _ in range(cfg["n_enc_res_blk"]):
            enc_a.append(self._res_block(tch, dropout))
            enc_b.append(self._res_block(tch, dropout))
        enc_shared = [self._res_block(tch, dropout)
                      for _ in range(cfg["n_enc_shared_blk"])]
        enc_shared.append(L.GaussianNoise())
        dec_shared = [self._res_block(tch, dropout)
                      for _ in range(cfg["n_gen_shared_blk"])]
        dec_a, dec_b = [], []
        for _ in range(cfg["n_gen_res_blk"]):
            dec_a.append(self._res_block(tch, dropout))
            dec_b.append(self._res_block(tch, dropout))
        for _ in range(1, cfg["n_gen_front_blk"]):
            dec_a.append(L.LeakyReLUConvTranspose2d(tch, tch // 2, 3, 2, 1,
                                                    output_padding=1))
            dec_b.append(L.LeakyReLUConvTranspose2d(tch, tch // 2, 3, 2, 1,
                                                    output_padding=1))
            tch //= 2
        dec_a += [L.ConvTranspose2d(tch, in_a, 1, 1, 0), nn.Tanh()]
        dec_b += [L.ConvTranspose2d(tch, in_b, 1, 1, 0), nn.Tanh()]

        self.encode_A = nn.Sequential(*enc_a)
        self.encode_B = nn.Sequential(*enc_b)
        self.enc_shared = nn.Sequential(*enc_shared)
        self.dec_shared = nn.Sequential(*dec_shared)
        self.decode_A = nn.Sequential(*dec_a)
        self.decode_B = nn.Sequential(*dec_b)
        self.latent_ch = ch * (2 ** (n_enc_front - 1))

    @staticmethod
    def _run(seq: nn.Sequential, x: torch.Tensor, noise=None,
             generator=None, dropout: bool = True) -> torch.Tensor:
        """NCHW through ``seq``; residual blocks take the generator (for
        dropout, unless ``dropout`` is False), the noise layer the draw
        (NHWC) or the generator."""
        for m in seq:
            if isinstance(m, L.GaussianNoise):
                x = m(x, None if noise is None else _nchw(noise), generator)
            elif isinstance(m, L.ResidualBody):
                x = m(x, generator, dropout=dropout)
            else:
                x = m(x)
        return x

    def _shared(self, h, noise, generator):
        return self._run(self.enc_shared, h, noise, generator)

    def _decode(self, seq, out, generator, dropout=True):
        return _nhwc(self._run(seq, out, generator=generator,
                               dropout=dropout))

    def decode(self, z: torch.Tensor, generator=None, train: bool = False):
        """Shared latent (B, h, w, C) -> (out_a, out_b) images.  Dropout
        runs only with ``train`` (and in training mode), as in the JAX
        package, whose trainer decodes with ``train=False``."""
        out = self._run(self.dec_shared, _nchw(z), generator=generator,
                        dropout=train)
        return (self._decode(self.decode_A, out, generator, train),
                self._decode(self.decode_B, out, generator, train))

    def encode(self, x_a: torch.Tensor, x_b: torch.Tensor,
               noise_a: Optional[torch.Tensor] = None,
               noise_b: Optional[torch.Tensor] = None, generator=None):
        """Each domain through its encoder and ``enc_shared`` on its own:
        (shared_a, shared_b), NHWC."""
        out_a = self._shared(
            self._run(self.encode_A, _nchw(x_a), generator=generator),
            noise_a, generator)
        out_b = self._shared(
            self._run(self.encode_B, _nchw(x_b), generator=generator),
            noise_b, generator)
        return _nhwc(out_a), _nhwc(out_b)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor,
                noise: Optional[torch.Tensor] = None, generator=None):
        """Joint pass over both domains concatenated on batch; ``noise``
        covers the concatenated batch.  Returns (x_aa, x_ba, x_ab, x_bb,
        shared)."""
        n = x_a.shape[0]
        out = torch.cat([
            self._run(self.encode_A, _nchw(x_a), generator=generator),
            self._run(self.encode_B, _nchw(x_b), generator=generator)])
        shared = self._shared(out, noise, generator)
        out = self._run(self.dec_shared, shared, generator=generator)
        out_a = self._decode(self.decode_A, out, generator)
        out_b = self._decode(self.decode_B, out, generator)
        return out_a[:n], out_a[n:], out_b[:n], out_b[n:], _nhwc(shared)

    def _translate(self, enc, dec, x, noise, generator):
        shared = self._shared(self._run(enc, _nchw(x), generator=generator),
                              noise, generator)
        out = self._run(self.dec_shared, shared, generator=generator)
        return self._decode(dec, out, generator), _nhwc(shared)

    def forward_a2b(self, x_a: torch.Tensor,
                    noise: Optional[torch.Tensor] = None, generator=None):
        """A -> shared -> B: (x_ab, shared)."""
        return self._translate(self.encode_A, self.decode_B, x_a, noise,
                               generator)

    def forward_b2a(self, x_b: torch.Tensor,
                    noise: Optional[torch.Tensor] = None, generator=None):
        """B -> shared -> A: (x_ba, shared)."""
        return self._translate(self.encode_B, self.decode_A, x_b, noise,
                               generator)


@register("model", "SharedResGen")
class SharedResGen(_SharedGenBase):
    """LeakyINSResBlock variant."""

    def _res_block(self, tch, dropout):
        return L.LeakyINSResBlock(tch, tch, dropout=dropout)


@register("model", "SharedResXGen")
class SharedResXGen(_SharedGenBase):
    """ResNeXt-block variant."""

    def __init__(self, cfg: dict):
        self._k = cfg.get("n_resnext_k", 1)
        self._c = cfg.get("n_resnext_c", 4)
        super().__init__(cfg)

    def _res_block(self, tch, dropout):
        return L.LeakyINSResNeXtBlock(tch, tch, k=self._k,
                                      cardinality=self._c, dropout=dropout)
