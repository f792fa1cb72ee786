"""The VAE-GAN pretrain iteration in plain PyTorch: augment, the
discriminator step, then the generator step, each with Adam.

What one iteration of ``cli/depth_train.py --mode pretrain`` computes with
the augment fused into the step, written from the published update rules
(masabdi/LSPS ``lsps_trainer.py``):

* the augment's image half: each raw crop (whole-mm depths, uint16 codes
  with code 1 meaning the crop's clamp value ``vstar``) goes through the
  clamp/normalize chain, then a nearest-neighbour warp by its 3x3
  destination -> source transform, each product and sum of the source
  coordinate rounded on its own in float32 and ``floor(x + 0.5)``;
* the discriminator step on real, translated and reconstructed images of
  both domains, with feature matching, against a frozen generator;
* the generator step: the joint pass, the two cycles, the adversarial,
  reconstruction and KL terms, with the updated discriminator;
* Adam with coupled weight decay (b1 0.5, b2 0.999, eps 1e-8), one count
  per optimizer; a parameter that gets no gradient is stepped with a zero
  gradient and no decay.

The draws of the generator's noise are inputs (NHWC, as the system takes
them).  Every function works in the dtype of its inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference import nets as N

NV_VAL = 32000.0
PAD_VALUE = 0.0
B1, B2, ADAM_EPS = 0.5, 0.999, 1e-8
WD = {"dis": 1e-4, "gen": 1e-4}
MILESTONES, GAMMA = (200, 300, 400, 450), 0.5


def f32(x: float) -> float:
    return torch.tensor(x, dtype=torch.float32).item()


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------

def _chain(v, com_z, cube_z, premax, zstart, zend):
    far = com_z + cube_z * 0.5
    near = com_z - cube_z * 0.5
    v = torch.where((v - NV_VAL).abs() <= f32(1e-5 * NV_VAL),
                    f32(PAD_VALUE), v)
    v = torch.where((v != 0.0) & (v < zstart), zstart, v)
    v = torch.where((v != 0.0) & (v > zend), 0.0, v)
    v = torch.where((v == premax) | (v == 0.0), far, v)
    v = torch.clamp(v, near, far)
    return (v - com_z) / (cube_z * 0.5)


def augment(raw, device) -> torch.Tensor:
    """A raw tuple (src, minv, com_z, cube_z, premax, zstart, zend, vstar)
    of numpy arrays -> (B, H, W) float32 normalized crops."""
    src, minv, com_z, cube_z, premax, zstart, zend, vstar = (
        torch.as_tensor(a).to(device) for a in raw)
    s = src.to(torch.float32)
    s = torch.where(s == 1.0, vstar.to(torch.float32)[:, None, None], s)
    b, h, w = s.shape
    cz, qz, pm, zs, ze = (t.to(torch.float32)[:, None, None]
                          for t in (com_z, cube_z, premax, zstart, zend))
    sn = _chain(s, cz, qz, pm, zs, ze)
    pad = _chain(torch.full_like(cz, f32(PAD_VALUE)), cz, qz, pm, zs, ze)
    m = minv.to(torch.float32)[:, :, :, None, None]
    ox = torch.arange(w, dtype=torch.float32, device=device)[None, None]
    oy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]

    def row(r):
        return m[:, r, 0] * ox + m[:, r, 1] * oy + m[:, r, 2]

    den = row(2)
    fx = torch.floor(row(0) / den + 0.5)
    fy = torch.floor(row(1) / den + 0.5)
    inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    iy = torch.where(inside, fy, 0.0).long()
    ix = torch.where(inside, fx, 0.0).long()
    v = torch.gather(sn.reshape(b, h * w), 1, (iy * w + ix).reshape(b, -1))
    return torch.where(inside, v.reshape(b, h, w), pad)


# ---------------------------------------------------------------------------
# losses and Adam
# ---------------------------------------------------------------------------

def l1(a, b=None):
    return torch.mean(torch.abs(a if b is None else a - b))


def kl(mu):
    return torch.mean(mu.square())


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def bce_ones(x):
    return torch.mean(softplus(-x))


def bce_zeros(x):
    return torch.mean(softplus(x))


def lr_at(base: float, count: int, interval: int) -> float:
    epochs = (count + 1) // interval
    return base * GAMMA ** sum(epochs >= m for m in MILESTONES)


class Adam:
    """Adam with coupled weight decay over named parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: float,
                 lr: float, interval: int):
        self.params = params
        self.wd, self.lr, self.interval = wd, lr, interval
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]):
        n = self.count + 1
        bc1, bc2 = 1 - B1 ** n, 1 - B2 ** n
        lr = lr_at(self.lr, self.count, self.interval)
        full = {}
        for k, p in self.params.items():
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g + self.wd * p
            full[k] = g
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * (g * g) + B2 * self.nu[k]
            p -= lr * ((self.mu[k] / bc1)
                       / (torch.sqrt(self.nu[k] / bc2) + ADAM_EPS))
        if self.first_grads is None:
            self.first_grads = full
        self.count = n


def _grads(loss, params: Dict[str, torch.Tensor]):
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys],
                             allow_unused=True)
    return dict(zip(keys, gs))


def _split(t, n):
    m = t.shape[0] // n
    return [t[i * m:(i + 1) * m] for i in range(n)]


# ---------------------------------------------------------------------------
# the pretrain iteration
# ---------------------------------------------------------------------------

class Pretrain:
    """The trainer's state (parameters of all four nets and the dis and
    gen + map optimizers), stepped one pretrain iteration at a time."""

    def __init__(self, hyp: dict, params: Dict[str, torch.Tensor],
                 interval: int = 1000):
        self.hyp = hyp
        self.p = {k: v.clone().requires_grad_(v.is_floating_point())
                  for k, v in params.items()}
        dis = {k: v for k, v in self.p.items() if k.startswith("dis.")}
        gen = {k: v for k, v in self.p.items()
               if k.startswith(("gen.", "map."))}
        self.dis_opt = Adam(dis, WD["dis"], hyp["lr"], interval)
        self.gen_opt = Adam(gen, WD["gen"], hyp["lr"], interval)

    def step(self, xa, xb, noise) -> Dict[str, torch.Tensor]:
        """One iteration on NHWC images ``xa``, ``xb`` with the NHWC noise
        dict ``{"dis": {"gen"}, "gen": {"gen", "a2b", "b2a"}}``; returns
        the discriminator's and the generator's total losses (tensors)."""
        h, p = self.hyp, self.p
        g, d = h["gen"], h["dis"]
        xa, xb = N.nchw(xa), N.nchw(xb)

        with torch.no_grad():
            x_aa, x_ba, x_ab, x_bb, _ = N.gen_joint(p, g, xa, xb,
                                                    noise["dis"]["gen"])
        ra, rb, fa, fb = N.dis_forward(p, d, torch.cat([xa, x_ba, x_aa]),
                                       torch.cat([xb, x_ab, x_bb]))
        fa, fb = _split(fa, 3), _split(fb, 3)
        ra, rb = _split(ra, 3), _split(rb, 3)
        feat = l1(fb[1] - fa[2]) + l1(fa[1] - fb[2])
        ad = (bce_ones(ra[0]) + bce_zeros(ra[1]) + bce_ones(rb[0])
              + bce_zeros(rb[1]))
        dis_loss = h["gan_w"] * ad + h["feature_w"] * feat
        self.dis_opt.step(_grads(dis_loss, self.dis_opt.params))

        nz = noise["gen"]
        x_aa, x_ba, x_ab, x_bb, shared = N.gen_joint(p, g, xa, xb, nz["gen"])
        x_bab, shared_bab = N.translate(p, g, "A", "B", x_ba, nz["a2b"])
        x_aba, shared_aba = N.translate(p, g, "B", "A", x_ab, nz["b2a"])
        outs_a, outs_b, _, _ = N.dis_forward(p, d, x_ba, x_ab)
        total = (h["gan_w"] * (bce_ones(outs_a) + bce_ones(outs_b))
                 + h["ll_direct_link_w"] * (l1(x_aa, xa) + l1(x_bb, xb))
                 + h["ll_cycle_link_w"] * (l1(x_aba, xa) + l1(x_bab, xb))
                 + h["kl_direct_link_w"] * 2 * kl(shared)
                 + h["kl_cycle_link_w"] * (kl(shared_bab) + kl(shared_aba)))
        self.gen_opt.step(_grads(total, self.gen_opt.params))
        return {"dis_loss": dis_loss.detach(),
                "gen_total_loss": total.detach()}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The gradients the optimizers took at the first step, weight
        decay included (what Adam's first moment holds)."""
        return {**self.dis_opt.first_grads, **self.gen_opt.first_grads}


def step_flops(hyp: dict, batch: int, hw: int = 128) -> int:
    """Matmul and conv FLOPs of one pretrain iteration at ``batch``
    (forward and backward, counted by ``FlopCounterMode`` on the meta
    device)."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {s.key: torch.empty(s.shape, device="meta")
              for s in N.param_specs(hyp)}
    ref = Pretrain(hyp, params)
    lc = N.latent_ch(hyp["gen"])
    side = hw // 2 ** (hyp["gen"]["n_enc_front_blk"] - 1)

    def z(n):
        return torch.empty((n, side, side, lc), device="meta")

    x = torch.empty((batch, hw, hw, 1), device="meta")
    noise = {"dis": {"gen": z(2 * batch)},
             "gen": {"gen": z(2 * batch), "a2b": z(batch), "b2a": z(batch)}}
    with FlopCounterMode(display=False) as fc:
        ref.step(x, x, noise)
    return int(fc.get_total_flops())
