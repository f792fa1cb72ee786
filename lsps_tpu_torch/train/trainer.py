"""LSPS trainer: the update rules of the VAE-GAN, in PyTorch.

Counterpart of ``lsps_tpu/train/trainer.py``: the same losses, loss
weights, optimizer groups (dis; gen + map in one Adam; vae with lr x10)
and metric names.  Where the JAX trainer is a pure function of a state
pytree, this one owns its four nets and three optimizers and updates them
in place; each update returns ``(metrics, outputs)``.

Gradients are taken with ``torch.autograd.grad(..., allow_unused=True)``
over the updated group only, so a head the loss does not reach comes back
as None (no decay, moments still updated: ``optim.AdamMultiStep``) and no
net ever accumulates ``.grad``.  Nets that an update does not train run
under ``torch.no_grad``.

Every random draw can be injected through ``noise``, a dict keyed by call
site (standard-normal draws in the JAX package's layout: NHWC for the
generator's shared code, (B, z_dim) for the pose VAE).  A draw that is not
given comes from the trainer's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from lsps_tpu_torch import resolve_device
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.registry import register
from lsps_tpu_torch.train import optim

NoiseDict = Optional[Mapping[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    """At least float32: bf16 is promoted, float64 stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def l1_loss(a, b=0.0):
    """Mean absolute difference (torch.nn.L1Loss)."""
    return torch.mean(torch.abs(_f32(a) - (b if isinstance(b, float)
                                           else _f32(b))))


def l2_loss(a, b):
    """Mean squared difference."""
    return torch.mean(torch.square(_f32(a) - _f32(b)))


def kl_loss(mu, sd=None):
    """With sd: sum(mu^2 + sd^2 - log sd^2) / B; without: mean(mu^2)."""
    mu2 = torch.square(_f32(mu))
    if sd is None:
        return torch.mean(mu2)
    sd2 = torch.square(_f32(sd))
    return torch.sum(mu2 + sd2 - torch.log(sd2)) / mu.shape[0]


def bce_logits_vs_ones(logits):
    """BCE(sigmoid(x), 1) in stable logit form."""
    return torch.mean(L.softplus(-_f32(logits)))


def bce_logits_vs_zeros(logits):
    """BCE(sigmoid(x), 0) in stable logit form."""
    return torch.mean(L.softplus(_f32(logits)))


def true_acc(logits):
    """Fraction classified real (logit >= 0)."""
    return torch.mean((logits >= 0).to(torch.float32))


def fake_acc(logits):
    """Fraction classified fake (logit <= 0)."""
    return torch.mean((logits <= 0).to(torch.float32))


def _split(t: torch.Tensor, n: int):
    m = t.shape[0] // n
    return [t[i * m:(i + 1) * m] for i in range(n)]


# ---------------------------------------------------------------------------
@register("trainer", "LSPSTrainer")
class LSPSTrainer:
    """Owns the four nets (``dis``, ``gen``, ``vae``, ``map``) and three
    optimizers, and updates them in place.

    ``state_dict`` holds ``dis.* gen.* vae.* map.*`` (for example
    ``weights.from_jax_params({"dis": ..., "gen": ..., "vae": ...,
    "map": ...})``) and is loaded strictly; the nets take its floating
    dtype.  ``sch_interval`` is the loop's scheduler cadence (1000 in
    pretrain/pose modes, 100 in estimate modes).  ``device`` is cuda
    unless one is named.  Draws that are not injected come from
    ``self.generator``, seeded with ``seed``.

    Not ported: ``compute_dtype: bfloat16``, ``remat``, ``axis_name``,
    the fused-augment ``*_raw`` steps and the ``*_scan`` variants.  With
    ``res_dropout_ratio > 0`` (no shipped config sets it) the train_map
    decode keeps dropout on, where the JAX trainer decodes with it off.
    """

    def __init__(self, hyperparameters: Dict[str, Any],
                 state_dict: Mapping[str, torch.Tensor],
                 sch_interval: int = 1000, device=None, seed: int = 0):
        hyp = dict(hyperparameters)
        if (str(hyp.get("compute_dtype", "float32")).lower()
                not in ("float32", "f32", "none") or hyp.get("remat")):
            raise NotImplementedError("compute_dtype other than float32 "
                                      "and remat are not ported")
        self.hyp = hyp
        self.device = resolve_device(device)
        self.nets = nn.ModuleDict({k: build_model(hyp[k])
                                   for k in ("dis", "gen", "vae", "map")})
        dtype = next(v.dtype for v in state_dict.values()
                     if v.is_floating_point())
        self.nets.to(device=self.device, dtype=dtype)
        self.nets.load_state_dict(state_dict, strict=True)
        self.dis, self.gen = self.nets["dis"], self.nets["gen"]
        self.vae, self.map = self.nets["vae"], self.nets["map"]
        self.nets.train()

        lr = hyp["lr"]
        self.dis_opt = optim.dis_optimizer(self.dis.parameters(), lr,
                                           sch_interval)
        self.gen_opt = optim.gen_optimizer(
            [*self.gen.parameters(), *self.map.parameters()], lr,
            sch_interval)
        self.vae_opt = optim.vae_optimizer(self.vae.parameters(), lr,
                                           sch_interval)
        self.train_map = bool(hyp.get("train_map", False))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0

    # ------------------------------------------------------------------
    def _to(self, x) -> torch.Tensor:
        dtype = self.dis.D.weight.dtype
        return torch.as_tensor(x, device=self.device).to(dtype)

    def _encode_pose(self, labels, noise):
        """Noisy pose codes of the VAE encoder (no grad)."""
        with torch.no_grad():
            z, _, _ = self.vae.encode(labels, noise=noise,
                                      generator=self.generator)
        return z

    def _apply(self, opt: optim.AdamMultiStep, loss: torch.Tensor) -> None:
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        opt.step(grads)

    # ------------------------------------------------------------------
    # VAE update
    # ------------------------------------------------------------------
    def vae_update(self, y, noise: Optional[torch.Tensor] = None):
        """One pose-VAE step on poses y (B, D); ``noise`` (B, z_dim).
        Returns (metrics, recons)."""
        hyp = self.hyp
        y = self._to(y)
        lr = self.vae_opt.current_lr()
        dec, _, mu, sd = self.vae(y, noise=noise, generator=self.generator)
        enc_loss = kl_loss(mu, sd)
        ll_loss = l1_loss(dec, y)
        total = hyp["kl_loss_vae"] * enc_loss + hyp["ll_loss_vae"] * ll_loss
        self._apply(self.vae_opt, total)
        self.step += 1
        return ({"vae_total_loss": total.detach(),
                 "vae_enc_loss": enc_loss.detach(),
                 "vae_ll_loss": ll_loss.detach(), "vae_lr": lr},
                dec.detach())

    # ------------------------------------------------------------------
    # generator update
    # ------------------------------------------------------------------
    def gen_update(self, images_a, labels_a, images_b, labels_b,
                   noise: NoiseDict = None):
        """One gen + map step.  ``noise`` keys: ``gen`` (joint pass,
        (2B, h, w, C)), ``a2b``, ``b2a`` ((B, h, w, C) each) and, with
        train_map, ``vae`` ((2B, z_dim)).  Returns (metrics, the eight
        output images)."""
        hyp = self.hyp
        noise = noise or {}
        gen, g = self.gen, self.generator
        xa, xb = self._to(images_a), self._to(images_b)
        lr = self.gen_opt.current_lr()

        x_aa, x_ba, x_ab, x_bb, shared = gen(xa, xb, noise=noise.get("gen"),
                                             generator=g)
        x_bab, shared_bab = gen.forward_a2b(x_ba, noise=noise.get("a2b"),
                                            generator=g)
        x_aba, shared_aba = gen.forward_b2a(x_ab, noise=noise.get("b2a"),
                                            generator=g)
        zero = xa.new_zeros(())
        if self.train_map:
            labels = torch.cat([self._to(labels_a), self._to(labels_b)])
            z_p2d = self.map(self._encode_pose(labels, noise.get("vae")))
            dec_a_full, dec_b_full = gen.decode(z_p2d, generator=g)
            half = dec_a_full.shape[0] // 2
            decode_a, decode_b = dec_a_full[:half], dec_b_full[half:]
            data_a = torch.cat([x_ba, decode_a])
            data_b = torch.cat([x_ab, decode_b])
            matching_z = l2_loss(shared, z_p2d)
            matching_a = l1_loss(decode_a, xa)
            matching_b = l1_loss(decode_b, xb)
        else:
            data_a, decode_a = x_ba, x_ba
            data_b, decode_b = x_ab, x_ab
            matching_z = matching_a = matching_b = zero

        outs_a, outs_b, _, _ = self.dis(data_a, data_b)
        ad_loss_a = bce_logits_vs_ones(outs_a)
        ad_loss_b = bce_logits_vs_ones(outs_b)
        enc_loss = kl_loss(shared)
        enc_bab = kl_loss(shared_bab)
        enc_aba = kl_loss(shared_aba)
        ll_a = l1_loss(x_aa, xa)
        ll_b = l1_loss(x_bb, xb)
        ll_aba = l1_loss(x_aba, xa)
        ll_bab = l1_loss(x_bab, xb)
        total = (hyp["gan_w"] * (ad_loss_a + ad_loss_b)
                 + hyp["ll_direct_link_w"] * (ll_a + ll_b)
                 + hyp["ll_cycle_link_w"] * (ll_aba + ll_bab)
                 + hyp["kl_direct_link_w"] * (enc_loss + enc_loss)
                 + hyp["kl_cycle_link_w"] * (enc_bab + enc_aba)
                 + hyp["ll_map_z_w"] * matching_z
                 + hyp["ll_map_w"] * (matching_a + matching_b))
        self._apply(self.gen_opt, total)
        metrics = {
            "gen_enc_loss": enc_loss,
            "gen_enc_loss2": enc_aba + enc_bab,
            "gen_ad_loss": ad_loss_a + ad_loss_b,
            "gen_ll_loss": ll_a + ll_b,
            "gen_ll_loss2": ll_bab + ll_aba,
            "gen_map_loss": matching_z,
            "gen_map_loss2": matching_a + matching_b,
            "gen_total_loss": total,
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["gen_lr"] = lr
        outs = (x_aa, x_ba, x_ab, x_bb, x_aba, x_bab, decode_a, decode_b)
        return metrics, tuple(o.detach() for o in outs)

    # ------------------------------------------------------------------
    # discriminator update
    # ------------------------------------------------------------------
    def dis_update(self, images_a, labels_a, images_b, labels_b,
                   feat_mat: bool = True, noise: NoiseDict = None):
        """One dis step against the frozen generator (train mode, noise
        on).  ``noise`` keys: ``gen`` ((2B, h, w, C)) and, with train_map,
        ``vae`` ((2B, z_dim)).  Returns (metrics, None)."""
        hyp = self.hyp
        noise = noise or {}
        gen, g = self.gen, self.generator
        xa, xb = self._to(images_a), self._to(images_b)
        lr = self.dis_opt.current_lr()

        with torch.no_grad():
            x_aa, x_ba, x_ab, x_bb, _ = gen(xa, xb, noise=noise.get("gen"),
                                            generator=g)
            if self.train_map:
                labels = torch.cat([self._to(labels_a), self._to(labels_b)])
                z_p2d = self.map(self._encode_pose(labels, noise.get("vae")))
                dec_a_full, dec_b_full = gen.decode(z_p2d, generator=g)
                half = dec_a_full.shape[0] // 2
                data_a = torch.cat([xa, x_ba, x_aa, dec_a_full[:half]])
                data_b = torch.cat([xb, x_ab, x_bb, dec_b_full[half:]])
                ndiv = 4
            elif feat_mat:
                data_a = torch.cat([xa, x_ba, x_aa])
                data_b = torch.cat([xb, x_ab, x_bb])
                ndiv = 3
            else:
                data_a = torch.cat([xa, x_ba])
                data_b = torch.cat([xb, x_ab])
                ndiv = 2

        res_a, res_b, feats_a, feats_b = self.dis(data_a, data_b)
        zero = res_a.new_zeros(())
        feature_loss_a = feature_loss_b = zero
        if feat_mat:
            fa, fb = _split(feats_a, ndiv), _split(feats_b, ndiv)
            feature_loss_a = l1_loss(fb[1] - fa[2])
            feature_loss_b = l1_loss(fa[1] - fb[2])
        ra, rb = _split(res_a, ndiv), _split(res_b, ndiv)
        ad_dec_a = ad_dec_b = zero
        if self.train_map:
            ad_dec_a = bce_logits_vs_zeros(ra[3])
            ad_dec_b = bce_logits_vs_zeros(rb[3])
        ad_loss_a = (bce_logits_vs_ones(ra[0]) + bce_logits_vs_zeros(ra[1])
                     + ad_dec_a)
        ad_loss_b = (bce_logits_vs_ones(rb[0]) + bce_logits_vs_zeros(rb[1])
                     + ad_dec_b)
        loss = (hyp["gan_w"] * (ad_loss_a + ad_loss_b)
                + hyp["feature_w"] * (feature_loss_a + feature_loss_b))
        self._apply(self.dis_opt, loss)
        metrics = {
            "dis_ad_loss": (ad_loss_a + ad_loss_b).detach(),
            "dis_feat_loss": (feature_loss_a + feature_loss_b).detach(),
            "dis_loss": loss.detach(),
            "dis_true_acc": 0.5 * (true_acc(ra[0]) + true_acc(rb[0])),
            "dis_fake_acc": 0.5 * (fake_acc(ra[1]) + fake_acc(rb[1])),
            "dis_lr": lr,
        }
        return metrics, None

    # ------------------------------------------------------------------
    def pretrain_update(self, images_a, labels_a, images_b, labels_b,
                        feat_mat: bool = True, with_viz: bool = True,
                        noise: Optional[Mapping[str, Mapping]] = None):
        """``dis_update`` then ``gen_update``; ``noise`` keys ``dis`` and
        ``gen`` hold their noise dicts.  Returns (metrics, the gen
        outputs or None without ``with_viz``)."""
        noise = noise or {}
        dmet, _ = self.dis_update(images_a, labels_a, images_b, labels_b,
                                  feat_mat=feat_mat, noise=noise.get("dis"))
        gmet, outs = self.gen_update(images_a, labels_a, images_b, labels_b,
                                     noise=noise.get("gen"))
        return {**dmet, **gmet}, outs if with_viz else None

    # ------------------------------------------------------------------
    # posterior-regression update
    # modes: 0 synth-only, 1 real-only, 4 semi-supervised; any other mode
    # (3, 5) synth + feature alignment on unlabeled real
    # ------------------------------------------------------------------
    def post_update(self, images_a, labels_a, images_b, labels_b,
                    mode: int = 3, with_viz: bool = True,
                    noise: NoiseDict = None):
        """One posterior-regression step of the dis.  ``noise`` keys:
        ``gen`` ((8, h, w, C), modes other than 0 and 1), ``vae_a`` and
        ``vae_b`` ((B, z_dim)).  Returns (metrics, outputs or None)."""
        hyp = self.hyp
        noise = noise or {}
        dis = self.dis
        xa, xb = self._to(images_a), self._to(images_b)
        lr = self.dis_opt.current_lr()
        zero = xa.new_zeros(())
        reg_loss_a = reg_loss_b = zero
        feature_loss_a = feature_loss_b = zero
        images = (xa, xa, xb, xb)

        def regress(regress_fn, x, labels, key):
            _, pred, _ = regress_fn(x)
            return l2_loss(pred, self._encode_pose(self._to(labels),
                                                   noise.get(key)))

        if mode == 0:
            reg_loss_a = regress(dis.regress_a, xa, labels_a, "vae_a")
        elif mode == 1:
            reg_loss_b = regress(dis.regress_b, xb, labels_b, "vae_b")
        else:
            with torch.no_grad():
                x_aa, x_ba, x_ab, x_bb, _ = self.gen(
                    xa[0:4], xb[0:4], noise=noise.get("gen"),
                    generator=self.generator)
            f_aa, f_ba, f_ab, f_bb = dis.feats(x_aa, x_ba, x_ab, x_bb)
            feature_loss_a = l1_loss(f_ab - f_aa)
            feature_loss_b = l1_loss(f_ba - f_bb)
            images = (x_aa, x_ba, x_ab, x_bb)
            reg_loss_a = regress(dis.regress_a, xa, labels_a, "vae_a")
            if mode == 4:
                reg_loss_b = regress(dis.regress_b, xb, labels_b, "vae_b")

        total = (hyp["reg_w"] * (reg_loss_a + reg_loss_b)
                 + hyp["feature_w_reg"] * (feature_loss_a + feature_loss_b))
        self._apply(self.dis_opt, total)
        metrics = {"dis_reg_loss": (reg_loss_a + reg_loss_b).detach(),
                   "dis_total_loss": total.detach(), "dis_lr": lr}
        if not with_viz:
            return metrics, None
        x_aa, x_ba, x_ab, x_bb = images
        return metrics, (x_aa, x_ba, x_ab, x_bb, x_aa, x_bb, x_aa, x_bb)
