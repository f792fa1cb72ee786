"""The LSPS nets as plain functions of a parameter dict.

SharedResGen, SharedDis, poseVAE and Mapping as published in
masabdi/LSPS (``exps/nnyu.yaml``, ``exps/nicvl.yaml``), written from the
layer equations with ``torch.nn.functional`` only: no kernel, no cache,
no module of the system under test.  Tensors are NCHW inside; the public
functions take and return NHWC where the system's do (crops, noise,
shared codes), so that the same inputs go to both.

Parameter names are the state-dict keys of the published nets (the JAX
pytree paths), so that one seeded dict of weights loads into the system
and drives this reference alike.  ``param_specs`` lists them with their
shapes and initial distributions:

* conv and transposed-conv kernels N(0, 0.02);
* linear weights and every bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), with
  fan_in = in * k * k for a conv and out * k * k for a transposed conv;
* the pose VAE's mu and sigma heads N(0, 0.002).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

SLOPE = 0.01
EPS = 1e-5
NOISE_STD = 0.05


class Spec(NamedTuple):
    key: str
    shape: tuple
    dist: str       # "normal" (scale = std) or "uniform" (scale = bound)
    scale: float


def _conv(specs, key, n_out, n_in, k):
    specs.append(Spec(key + ".weight", (n_out, n_in, k, k), "normal", 0.02))
    specs.append(Spec(key + ".bias", (n_out,), "uniform",
                      1.0 / math.sqrt(n_in * k * k)))


def _convt(specs, key, n_in, n_out, k):
    specs.append(Spec(key + ".weight", (n_in, n_out, k, k), "normal", 0.02))
    specs.append(Spec(key + ".bias", (n_out,), "uniform",
                      1.0 / math.sqrt(n_out * k * k)))


def _linear(specs, key, n_in, n_out, preset=False):
    if preset:
        specs.append(Spec(key + ".weight", (n_out, n_in), "normal", 0.002))
        specs.append(Spec(key + ".bias", (n_out,), "normal", 0.002))
        return
    bound = 1.0 / math.sqrt(n_in)
    specs.append(Spec(key + ".weight", (n_out, n_in), "uniform", bound))
    specs.append(Spec(key + ".bias", (n_out,), "uniform", bound))


def _res(specs, key, ch):
    _conv(specs, key + ".0", ch, ch, 3)
    _conv(specs, key + ".3", ch, ch, 3)


def latent_ch(gen: dict) -> int:
    return gen["ch"] * 2 ** (gen["n_enc_front_blk"] - 1)


def gen_specs(g: dict) -> List[Spec]:
    s: List[Spec] = []
    nf, tch = g["n_enc_front_blk"], latent_ch(g)
    for dom in "AB":
        c = g["ch"]
        _conv(s, f"gen.encode_{dom}.0.0", c, g[f"input_dim_{dom.lower()}"], 7)
        for j in range(1, nf):
            _conv(s, f"gen.encode_{dom}.{j}.0", 2 * c, c, 3)
            c *= 2
        for r in range(g["n_enc_res_blk"]):
            _res(s, f"gen.encode_{dom}.{nf + r}", tch)
    for r in range(g["n_enc_shared_blk"]):
        _res(s, f"gen.enc_shared.{r}", tch)
    for r in range(g["n_gen_shared_blk"]):
        _res(s, f"gen.dec_shared.{r}", tch)
    nr, nb = g["n_gen_res_blk"], g["n_gen_front_blk"]
    for dom in "AB":
        for r in range(nr):
            _res(s, f"gen.decode_{dom}.{r}", tch)
        c = tch
        for j in range(1, nb):
            _convt(s, f"gen.decode_{dom}.{nr + j - 1}.0", c, c // 2, 3)
            c //= 2
        _convt(s, f"gen.decode_{dom}.{nr + nb - 1}", c,
               g[f"input_dim_{dom.lower()}"], 1)
    return s


def dis_specs(d: dict) -> List[Spec]:
    s: List[Spec] = []
    for dom in "AB":
        c = d["ch"]
        _conv(s, f"dis.model_{dom}.0.0", c, d[f"input_dim_{dom.lower()}"], 7)
        for j in range(1, d["n_front_layer"]):
            _conv(s, f"dis.model_{dom}.{j}.0", 2 * c, c, 3)
            c *= 2
    n_expand = d.get("n_expand_layer", 0)
    for i in range(n_expand + d["n_shared_layer"]):
        _conv(s, f"dis.model_S.{i}.0", 2 * c, c, 3)
        c *= 2
    _conv(s, "dis.D", 1, c, 1)
    _conv(s, "dis.Post", d["post_dim"], c, 2)
    return s


def vae_specs(v: dict) -> List[Spec]:
    s: List[Spec] = []
    _linear(s, "vae.en_fc1", v["input_dim"], v["h_dim"])
    _linear(s, "vae.en_mu", v["h_dim"], v["z_dim"], preset=True)
    _linear(s, "vae.en_sigma", v["h_dim"], v["z_dim"], preset=True)
    _linear(s, "vae.de_fc1.0", v["z_dim"], v["h_dim"])
    _linear(s, "vae.de_fc2", v["h_dim"], v["input_dim"])
    return s


def map_specs(m: dict) -> List[Spec]:
    s: List[Spec] = []
    ch = m["output_ch"]
    _convt(s, "map.0.0", m["input_dim"], 4 * ch, 4)
    _convt(s, "map.1.0", 4 * ch, 4 * ch, 4)
    _convt(s, "map.2.0", 4 * ch, 2 * ch, 4)
    _convt(s, "map.3", 2 * ch, ch, 4)
    return s


SPECS = {"dis": dis_specs, "gen": gen_specs, "vae": vae_specs,
         "map": map_specs}


def param_specs(hyp: dict, nets=("dis", "gen", "vae", "map")) -> List[Spec]:
    return [s for n in nets for s in SPECS[n](hyp[n])]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

P = Dict[str, torch.Tensor]


def leaky(x):
    return torch.where(x >= 0, x, SLOPE * x)


def inorm(x):
    """InstanceNorm2d without affine: biased variance, eps 1e-5."""
    m = x.mean((2, 3), keepdim=True)
    v = (x - m).square().mean((2, 3), keepdim=True)
    return (x - m) * torch.rsqrt(v + EPS)


def conv(p: P, key, x, stride, pad):
    return F.conv2d(x, p[key + ".weight"], p[key + ".bias"], stride, pad)


def convt(p: P, key, x, stride, pad, out_pad=0):
    return F.conv_transpose2d(x, p[key + ".weight"], p[key + ".bias"],
                              stride, pad, out_pad)


def linear(p: P, key, x):
    return F.linear(x, p[key + ".weight"], p[key + ".bias"])


def res_block(p: P, key, x):
    h = leaky(inorm(conv(p, key + ".0", x, 1, 1)))
    return x + inorm(conv(p, key + ".3", h, 1, 1))


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SharedResGen
# ---------------------------------------------------------------------------

def encode(p: P, g: dict, dom: str, x):
    """NCHW images -> NCHW codes before the shared blocks."""
    nf = g["n_enc_front_blk"]
    x = leaky(conv(p, f"gen.encode_{dom}.0.0", x, 1, 3))
    for j in range(1, nf):
        x = leaky(conv(p, f"gen.encode_{dom}.{j}.0", x, 2, 1))
    for r in range(g["n_enc_res_blk"]):
        x = res_block(p, f"gen.encode_{dom}.{nf + r}", x)
    return x


def enc_shared(p: P, g: dict, h, noise_nhwc):
    """The shared encoder blocks, then the additive N(0, 1) noise of
    training (a draw of the code's NHWC shape)."""
    for r in range(g["n_enc_shared_blk"]):
        h = res_block(p, f"gen.enc_shared.{r}", h)
    return h + nchw(noise_nhwc).to(h.dtype)


def dec_shared(p: P, g: dict, h):
    for r in range(g["n_gen_shared_blk"]):
        h = res_block(p, f"gen.dec_shared.{r}", h)
    return h


def decode(p: P, g: dict, dom: str, h):
    nr, nb = g["n_gen_res_blk"], g["n_gen_front_blk"]
    for r in range(nr):
        h = res_block(p, f"gen.decode_{dom}.{r}", h)
    for j in range(1, nb):
        h = leaky(convt(p, f"gen.decode_{dom}.{nr + j - 1}.0", h, 2, 1, 1))
    return torch.tanh(convt(p, f"gen.decode_{dom}.{nr + nb - 1}", h, 1, 0))


def gen_joint(p: P, g: dict, xa, xb, noise):
    """Both domains through one pass (NCHW in and out): (x_aa, x_ba,
    x_ab, x_bb, shared)."""
    n = xa.shape[0]
    shared = enc_shared(p, g, torch.cat([encode(p, g, "A", xa),
                                         encode(p, g, "B", xb)]), noise)
    out = dec_shared(p, g, shared)
    out_a, out_b = decode(p, g, "A", out), decode(p, g, "B", out)
    return out_a[:n], out_a[n:], out_b[:n], out_b[n:], shared


def translate(p: P, g: dict, src: str, dst: str, x, noise):
    """src -> shared -> dst: (image, shared), NCHW."""
    shared = enc_shared(p, g, encode(p, g, src, x), noise)
    return decode(p, g, dst, dec_shared(p, g, shared)), shared


# ---------------------------------------------------------------------------
# SharedDis and poseVAE
# ---------------------------------------------------------------------------

def dis_front(p: P, d: dict, dom: str, x):
    x = leaky(conv(p, f"dis.model_{dom}.0.0", x, 2, 3))
    for j in range(1, d["n_front_layer"]):
        x = leaky(conv(p, f"dis.model_{dom}.{j}.0", x, 2, 1))
    return x


def dis_trunk(p: P, d: dict, f):
    n_expand = d.get("n_expand_layer", 0)
    for i in range(n_expand + d["n_shared_layer"]):
        f = leaky(conv(p, f"dis.model_S.{i}.0", f, 1 if i < n_expand else 2,
                       1))
    return f


def dis_forward(p: P, d: dict, xa, xb):
    """Real/fake logits of both domains (flat) and the trunk's features
    (NCHW)."""
    f = dis_trunk(p, d, torch.cat([dis_front(p, d, "A", xa),
                                   dis_front(p, d, "B", xb)]))
    logits = nhwc(conv(p, "dis.D", f, 1, 0)).reshape(f.shape[0], -1)
    n = f.shape[0] // 2
    return logits[:n].reshape(-1), logits[n:].reshape(-1), f[:n], f[n:]


def regress(p: P, d: dict, dom: str, x):
    """NCHW crops -> (B, post_dim) posterior codes."""
    post = conv(p, "dis.Post", dis_trunk(p, d, dis_front(p, d, dom, x)), 1, 0)
    return nhwc(post).reshape(x.shape[0], -1)


def vae_decode(p: P, z):
    return linear(p, "vae.de_fc2", leaky(linear(p, "vae.de_fc1.0", z)))
