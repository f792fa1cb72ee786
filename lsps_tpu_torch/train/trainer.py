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

With ``mesh`` (a ``parallel.DataMesh``) the trainer is one rank of a
data-parallel group, the counterpart of the JAX trainer's ``axis_name``
under ``pjit``: each update takes the global batch and the global-shaped
draws, computes on this rank's rows, and averages the gradients over the
ranks before the optimizer step (``_apply``), so that N ranks take the
step one process takes on the global batch.

Under a recording profiler an update opens the spans ``lsps.augment`` (the
fused-augment updates' two raw batches), ``lsps.dis`` / ``lsps.gen`` (the
whole discriminator or generator update) and, in each, ``lsps.backward``
and ``lsps.optim`` (``utils/logging.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lsps_tpu_torch import resolve_device
from lsps_tpu_torch.data import augment
from lsps_tpu_torch.models import build_model
from lsps_tpu_torch.ops import layers as L
from lsps_tpu_torch.parallel.mesh import DataMesh, RowDraws
from lsps_tpu_torch.registry import register
from lsps_tpu_torch.train import checkpoint as ckpt
from lsps_tpu_torch.train import optim
from lsps_tpu_torch.utils.logging import span

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


def _compute_dtype(hyp) -> Optional[torch.dtype]:
    cd = str(hyp.get("compute_dtype", "float32")).lower()
    if cd in ("bfloat16", "bf16"):
        return torch.bfloat16
    if cd in ("float32", "f32", "none"):
        return None
    raise ValueError(f"unsupported compute_dtype {cd!r}")


def _step_slice(x, i: int):
    """Step ``i`` of a K-stacked input: a raw tuple leaf by leaf."""
    if isinstance(x, tuple):
        return tuple(leaf[i] for leaf in x)
    return x[i]


def _head(x, n: int = 4):
    """The first ``n`` rows of a batch (a raw tuple leaf by leaf)."""
    if isinstance(x, tuple):
        return tuple(leaf[:n] for leaf in x)
    return x[:n]


def fresh_state_dict(hyp: Mapping[str, Any], seed: int
                     ) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights of the four nets (``dis.* gen.* vae.*
    map.*``, on the CPU) for ``LSPSTrainer``: each net built from ``hyp``
    and drawn by ``ops.layers.reset_parameters`` from one generator
    seeded with ``seed``, in the order dis, gen, vae, map.  The
    distributions are the JAX package's ``init_state``; the draws are
    not."""
    g = torch.Generator().manual_seed(int(seed))
    nets = nn.ModuleDict({k: build_model(hyp[k])
                          for k in ("dis", "gen", "vae", "map")})
    for net in nets.values():
        L.reset_parameters(net, g)
    return nets.state_dict()


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

    ``compute_dtype: bfloat16`` runs the gen, dis and map forwards of the
    image updates on bfloat16 copies of the nets, refreshed from the
    parameters at the start of each update; their gradients are cast back
    to the parameters' dtype.  Parameters and optimizer state stay at
    rest in their own dtype, losses and reductions in at least float32,
    the pose-VAE update in its own dtype, and the outputs handed back are
    float32.  ``remat: true`` recomputes the generator's joint pass in the
    backward (``torch.utils.checkpoint``); its draws come from a generator
    restored to the state it had when the pass began, so the recompute
    draws the same noise and dropout masks.

    ``mesh`` (a ``parallel.DataMesh``) makes the trainer one rank of a
    data-parallel group on the mesh's device.  Every update then takes the
    global batch (a raw tuple leaf by leaf) and global-shaped injected
    noise, and computes on the rank's contiguous rows: the joint pass's
    draws for a and b concatenated as two blocks, each sliced on its own;
    ``post_update``'s feature alignment on the global batch's first four
    rows on every rank.  Draws that are not injected are made at the global
    shape from ``generator`` (seeded alike on every rank) and sliced
    (``parallel.mesh.RowDraws``).  The gradients, cast to the parameters'
    dtype, are averaged over the ranks in one collective per optimizer
    step, and so are the step's metrics, so that every rank logs the global
    losses.  The ranks must start equal: construction copies rank 0's
    parameters to every rank and raises if any held others
    (``sync_replicas``).  Snapshots are written by rank 0 and read by every
    rank after a barrier.
    """

    def __init__(self, hyperparameters: Dict[str, Any],
                 state_dict: Mapping[str, torch.Tensor],
                 sch_interval: int = 1000, device=None, seed: int = 0,
                 mesh: Optional[DataMesh] = None):
        hyp = dict(hyperparameters)
        self.hyp = hyp
        self.compute_dtype = _compute_dtype(hyp)
        self.remat = bool(hyp.get("remat", False))
        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.nets = nn.ModuleDict({k: build_model(hyp[k])
                                   for k in ("dis", "gen", "vae", "map")})
        dtype = next(v.dtype for v in state_dict.values()
                     if v.is_floating_point())
        self.nets.to(device=self.device, dtype=dtype)
        self.nets.load_state_dict(state_dict, strict=True)
        self.dis, self.gen = self.nets["dis"], self.nets["gen"]
        self.vae, self.map = self.nets["vae"], self.nets["map"]
        self.nets.train()
        self._cast: Optional[nn.ModuleDict] = None
        if self.compute_dtype is not None:
            self._cast = copy.deepcopy(nn.ModuleDict(
                {k: self.nets[k] for k in ("dis", "gen", "map")})).to(
                    self.compute_dtype)

        lr = hyp["lr"]
        self.dis_opt = optim.dis_optimizer(self.dis.parameters(), lr,
                                           sch_interval)
        self.gen_opt = optim.gen_optimizer(
            [*self.gen.parameters(), *self.map.parameters()], lr,
            sch_interval)
        self.vae_opt = optim.vae_optimizer(self.vae.parameters(), lr,
                                           sch_interval)
        # each optimizer's nets, in its order: the trees of its state
        self.dis_opt_nets = ((None, self.dis),)
        self.gen_opt_nets = (("gen", self.gen), ("map", self.map))
        self.train_map = bool(hyp.get("train_map", False))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0
        self.sync_replicas()

    # ------------------------------------------------------------------
    # the data-parallel rank (no-ops without a mesh)
    # ------------------------------------------------------------------
    def sync_replicas(self) -> None:
        """Under a mesh: copy rank 0's parameters, optimizer moments and
        counts and draw generator into every rank, and raise if any rank
        held others (the ranks must build the trainer from the same seed
        and read the same snapshots)."""
        if self.mesh is None:
            return
        opts = (self.dis_opt, self.gen_opt, self.vae_opt)
        counts = torch.tensor([[o.count, o.sched_count] for o in opts],
                              dtype=torch.float64, device=self.device)
        gen_state = self.generator.get_state().to(self.device)
        same = self.mesh.broadcast_params_(
            [*self.nets.parameters(), *(t for o in opts for t in o.mu),
             *(t for o in opts for t in o.nu), counts, gen_state])
        if not same:
            raise RuntimeError(
                "the ranks hold different parameters, optimizer states or "
                "draw generators: every rank must build the trainer from "
                "the same seed and read the same snapshots")

    def _rows(self, x):
        """This rank's rows of a global batch (a raw tuple leaf by leaf);
        the batch itself without a mesh."""
        if self.mesh is None:
            return x
        if isinstance(x, tuple):
            return tuple(self._rows(v) for v in x)
        return self.mesh.local_rows(x)

    def _batch(self, *xs):
        """This rank's rows of the global inputs, on the device."""
        return tuple(self._to(self._rows(x)) for x in xs)

    def _local_noise(self, noise, rows: int, keep: Sequence[str] = ()):
        """Injected global-shaped draws (a tensor, or a dict of them) ->
        this rank's: a draw of k * rows * world rows holds k blocks (the
        joint pass's a and b), each sliced on its own.  Keys in ``keep``
        are the same on every rank."""
        if self.mesh is None or noise is None:
            return noise
        if isinstance(noise, torch.Tensor):
            return self.mesh.local_rows(
                noise, segments=max(1, noise.shape[0]
                                    // (rows * self.mesh.world)))
        return {k: v if k in keep else self._local_noise(v, rows)
                for k, v in noise.items()}

    def _draws(self, rows: int, generator: Optional[torch.Generator] = None):
        """The draw source of a pass over ``rows`` local rows: the
        generator, or under a mesh its global draws sliced to this
        rank."""
        g = self.generator if generator is None else generator
        return g if self.mesh is None else RowDraws(g, self.mesh, rows)

    def _reduced(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Under a mesh, the step's tensor metrics averaged over the ranks
        in one collective: every rank logs the global losses, and the
        collapse guard takes the same decision on each."""
        if self.mesh is None:
            return metrics
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        vec = torch.stack([metrics[k].to(torch.float64) for k in keys])
        self.mesh.allreduce_mean_([vec])
        return {**metrics, **{k: vec[i].to(metrics[k].dtype)
                              for i, k in enumerate(keys)}}

    def _writes(self) -> bool:
        """Whether this process writes files: rank 0, or no mesh."""
        return self.mesh is None or self.mesh.is_main

    def barrier(self) -> None:
        """Under a mesh, wait until every rank is here."""
        if self.mesh is not None:
            self.mesh.barrier()

    # ------------------------------------------------------------------
    def _to(self, x) -> torch.Tensor:
        dtype = self.dis.D.weight.dtype
        if isinstance(x, np.ndarray):
            # one layout whatever view the caller hands over (a transposed
            # loader batch, a slice of a stacked chunk): the convs' CPU
            # algorithm, and so its rounding, follows the strides, even
            # those of the size-1 channel dimension, which numpy's
            # contiguity ignores; a copy has the canonical ones
            x = np.array(x, order="C")
        return torch.as_tensor(x, device=self.device).to(dtype)

    def _cd(self, x: torch.Tensor) -> torch.Tensor:
        """x in the compute dtype."""
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """An output handed back: float32 under a compute dtype."""
        x = x.detach()
        return x if self.compute_dtype is None else x.float()

    def _compute_nets(self):
        """(gen, dis, map) for the image updates' forwards: the nets, or
        under a compute dtype their copies, refreshed from the
        parameters."""
        if self._cast is None:
            return self.gen, self.dis, self.map
        with torch.no_grad():
            for k, cast in self._cast.items():
                for c, p in zip(cast.parameters(),
                                self.nets[k].parameters()):
                    c.copy_(p)
        return self._cast["gen"], self._cast["dis"], self._cast["map"]

    def _encode_pose(self, labels, noise, rows: int):
        """Noisy pose codes of the VAE encoder (no grad); ``rows`` is the
        rank's batch (``labels`` may hold a's and b's, two blocks)."""
        with torch.no_grad():
            z, _, _ = self.vae.encode(labels, noise=noise,
                                      generator=self._draws(rows))
        return z

    def _apply(self, opt: optim.AdamMultiStep, loss: torch.Tensor,
               wrt: Sequence[torch.Tensor]) -> None:
        """One step of ``opt`` with the gradients of ``loss`` by ``wrt``
        (the optimizer's parameters or their compute-dtype copies, in
        its order), cast to the parameters' dtype and, under a mesh,
        averaged over the ranks."""
        with span("backward"):
            grads = torch.autograd.grad(loss, list(wrt), allow_unused=True)
        with span("optim"):
            grads = [None if g is None else g.to(p.dtype)
                     for g, p in zip(grads, opt.params)]
            if self.mesh is not None:
                self.mesh.allreduce_mean_(grads)
            opt.step(grads)

    def _gen_fwd(self, gen, xa, xb, noise):
        """The generator's joint pass, (x_aa, x_ba, x_ab, x_bb, shared).
        Under remat (and with grad on) it is recomputed in the backward:
        it then draws from a copy of ``self.generator`` taken before it,
        which each run restores, and ``self.generator`` moves on to where
        the first run left the copy."""
        rows = xa.shape[0]
        if not (self.remat and torch.is_grad_enabled()):
            return gen(xa, xb, noise=noise, generator=self._draws(rows))
        start, ends = self.generator.get_state(), []

        def region(xa, xb, noise):
            g = torch.Generator(device=self.device)
            g.set_state(start)
            out = gen(xa, xb, noise=noise, generator=self._draws(rows, g))
            ends.append(g.get_state())
            return out

        out = checkpoint(region, xa, xb, noise, use_reentrant=False)
        self.generator.set_state(ends[0])
        return out

    # ------------------------------------------------------------------
    # VAE update
    # ------------------------------------------------------------------
    def vae_update(self, y, noise: Optional[torch.Tensor] = None):
        """One pose-VAE step on poses y (B, D); ``noise`` (B, z_dim).
        Returns (metrics, recons)."""
        hyp = self.hyp
        (y,) = self._batch(y)
        lr = self.vae_opt.current_lr()
        dec, _, mu, sd = self.vae(
            y, noise=self._local_noise(noise, y.shape[0]),
            generator=self._draws(y.shape[0]))
        enc_loss = kl_loss(mu, sd)
        ll_loss = l1_loss(dec, y)
        total = hyp["kl_loss_vae"] * enc_loss + hyp["ll_loss_vae"] * ll_loss
        self._apply(self.vae_opt, total, self.vae_opt.params)
        self.step += 1
        return (self._reduced({"vae_total_loss": total.detach(),
                               "vae_enc_loss": enc_loss.detach(),
                               "vae_ll_loss": ll_loss.detach(),
                               "vae_lr": lr}),
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
        met, outs = self._gen(*self._batch(images_a, labels_a, images_b,
                                           labels_b), noise=noise)
        return self._reduced(met), outs

    def _gen(self, xa, la, xb, lb, noise: NoiseDict = None):
        """``gen_update`` on this rank's rows (tensors on the device);
        the metrics are the rank's."""
        with span("gen"):
            hyp = self.hyp
            noise = self._local_noise(noise or {}, xa.shape[0])
            g = self._draws(xa.shape[0])
            gen, dis, mp = self._compute_nets()
            lr = self.gen_opt.current_lr()

            x_aa, x_ba, x_ab, x_bb, shared = self._gen_fwd(
                gen, self._cd(xa), self._cd(xb), noise.get("gen"))
            x_bab, shared_bab = gen.forward_a2b(x_ba, noise=noise.get("a2b"),
                                                generator=g)
            x_aba, shared_aba = gen.forward_b2a(x_ab, noise=noise.get("b2a"),
                                                generator=g)
            zero = xa.new_zeros(())
            if self.train_map:
                labels = torch.cat([la, lb])
                z_p2d = mp(self._cd(self._encode_pose(labels, noise.get("vae"),
                                                      xa.shape[0])))
                dec_a_full, dec_b_full = gen.decode(z_p2d)
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

            outs_a, outs_b, _, _ = dis(data_a, data_b)
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
            self._apply(self.gen_opt, total,
                        [*gen.parameters(), *mp.parameters()])
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
            return metrics, tuple(self._out(o) for o in outs)

    # ------------------------------------------------------------------
    # discriminator update
    # ------------------------------------------------------------------
    def dis_update(self, images_a, labels_a, images_b, labels_b,
                   feat_mat: bool = True, noise: NoiseDict = None):
        """One dis step against the frozen generator (train mode, noise
        on).  ``noise`` keys: ``gen`` ((2B, h, w, C)) and, with train_map,
        ``vae`` ((2B, z_dim)).  Returns (metrics, None)."""
        met, _ = self._dis(*self._batch(images_a, labels_a, images_b,
                                        labels_b), feat_mat, noise)
        return self._reduced(met), None

    def _dis(self, xa, la, xb, lb, feat_mat: bool = True,
             noise: NoiseDict = None):
        """``dis_update`` on this rank's rows; the metrics are the
        rank's."""
        with span("dis"):
            hyp = self.hyp
            noise = self._local_noise(noise or {}, xa.shape[0])
            gen, dis, mp = self._compute_nets()
            xa, xb = self._cd(xa), self._cd(xb)
            lr = self.dis_opt.current_lr()

            with torch.no_grad():
                x_aa, x_ba, x_ab, x_bb, _ = self._gen_fwd(gen, xa, xb,
                                                          noise.get("gen"))
                if self.train_map:
                    labels = torch.cat([la, lb])
                    z_p2d = mp(self._cd(self._encode_pose(
                        labels, noise.get("vae"), xa.shape[0])))
                    dec_a_full, dec_b_full = gen.decode(z_p2d)
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

            res_a, res_b, feats_a, feats_b = dis(data_a, data_b)
            zero = _f32(res_a.new_zeros(()))
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
            self._apply(self.dis_opt, loss, list(dis.parameters()))
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
        met, outs = self._pretrain(*self._batch(images_a, labels_a, images_b,
                                                labels_b), feat_mat=feat_mat,
                                   with_viz=with_viz, noise=noise)
        return self._reduced(met), outs

    def _pretrain(self, xa, la, xb, lb, feat_mat: bool = True,
                  with_viz: bool = True, noise=None):
        noise = noise or {}
        dmet, _ = self._dis(xa, la, xb, lb, feat_mat=feat_mat,
                            noise=noise.get("dis"))
        gmet, outs = self._gen(xa, la, xb, lb, noise=noise.get("gen"))
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
        ``vae_b`` ((B, z_dim)).  Returns (metrics, outputs or None).
        Under a mesh the feature alignment runs on the global batch's first
        four rows on every rank (``gen`` noise unsliced), the regression on
        the rank's rows."""
        heads = None
        if self.mesh is not None and mode not in (0, 1):
            heads = (self._to(_head(images_a)), self._to(_head(images_b)))
        met, outs = self._post(*self._batch(images_a, labels_a, images_b,
                                            labels_b), mode=mode,
                               with_viz=with_viz, noise=noise, heads=heads)
        return self._reduced(met), outs

    def _post(self, xa, la, xb, lb, mode: int = 3, with_viz: bool = True,
              noise: NoiseDict = None, heads=None):
        """``post_update`` on this rank's rows; ``heads`` are the global
        batch's first four rows of a and b (None: ``xa[0:4]``,
        ``xb[0:4]``).  The metrics are the rank's."""
        hyp = self.hyp
        noise = self._local_noise(noise or {}, xa.shape[0], keep=("gen",))
        gen, dis, _ = self._compute_nets()
        ca, cb = self._cd(xa), self._cd(xb)
        lr = self.dis_opt.current_lr()
        zero = xa.new_zeros(())
        reg_loss_a = reg_loss_b = zero
        feature_loss_a = feature_loss_b = zero
        images = (xa, xa, xb, xb)

        def regress(regress_fn, x, labels, key):
            _, pred, _ = regress_fn(x)
            return l2_loss(pred, self._encode_pose(labels, noise.get(key),
                                                   x.shape[0]))

        if mode == 0:
            reg_loss_a = regress(dis.regress_a, ca, la, "vae_a")
        elif mode == 1:
            reg_loss_b = regress(dis.regress_b, cb, lb, "vae_b")
        else:
            head_a, head_b = heads or (xa[0:4], xb[0:4])
            with torch.no_grad():
                # the same four global rows and draws on every rank
                x_aa, x_ba, x_ab, x_bb, _ = gen(
                    self._cd(head_a), self._cd(head_b),
                    noise=noise.get("gen"), generator=self.generator)
            f_aa, f_ba, f_ab, f_bb = dis.feats(x_aa, x_ba, x_ab, x_bb)
            feature_loss_a = l1_loss(f_ab - f_aa)
            feature_loss_b = l1_loss(f_ba - f_bb)
            images = (x_aa, x_ba, x_ab, x_bb)
            reg_loss_a = regress(dis.regress_a, ca, la, "vae_a")
            if mode == 4:
                reg_loss_b = regress(dis.regress_b, cb, lb, "vae_b")

        total = (hyp["reg_w"] * (reg_loss_a + reg_loss_b)
                 + hyp["feature_w_reg"] * (feature_loss_a + feature_loss_b))
        self._apply(self.dis_opt, total, list(dis.parameters()))
        metrics = {"dis_reg_loss": (reg_loss_a + reg_loss_b).detach(),
                   "dis_total_loss": total.detach(), "dis_lr": lr}
        if not with_viz:
            return metrics, None
        x_aa, x_ba, x_ab, x_bb = (self._out(i) for i in images)
        return metrics, (x_aa, x_ba, x_ab, x_bb, x_aa, x_bb, x_aa, x_bb)

    # ------------------------------------------------------------------
    # fused-augment steps: the image half of the augment (warp, sentinels,
    # z-clamp, normalize: data/augment.py) on the trainer's device, then
    # the image step.  The raw tuples are FastAugmenter.raw_batch's, numpy
    # or tensors; a uint16 src crosses to the device at half width.  Under
    # a mesh each rank augments only its rows of the global tuples.
    # ------------------------------------------------------------------
    def _augment(self, raw) -> torch.Tensor:
        """A raw tuple -> (B, H, W, 1) float32 crops on the device."""
        return augment.recrop_normalize_batch(*raw,
                                              device=self.device)[..., None]

    def _raw(self, update: Callable, raw_a, labels_a, raw_b, labels_b,
             viz: bool, **kw):
        """``update`` (a rank-local step) on the augmented rows of the raw
        tuples; returns the reduced metrics and, with ``viz``, (outputs,
        the rank's images_a, images_b)."""
        with span("augment"):
            images_a = self._augment(self._rows(raw_a))
            images_b = self._augment(self._rows(raw_b))
        la, lb = self._batch(labels_a, labels_b)
        met, outs = update(self._to(images_a), la, self._to(images_b), lb,
                           **kw)
        if not viz:
            return self._reduced(met), None
        return self._reduced(met), (outs, images_a, images_b)

    def pretrain_update_raw(self, raw_a, labels_a, raw_b, labels_b,
                            feat_mat: bool = True, with_viz: bool = True,
                            noise=None):
        """``pretrain_update`` on augmented raw batches.  Returns (metrics,
        (gen outputs, images_a, images_b) or None)."""
        return self._raw(self._pretrain, raw_a, labels_a, raw_b,
                         labels_b, with_viz, feat_mat=feat_mat,
                         with_viz=with_viz, noise=noise)

    def gen_update_raw(self, raw_a, labels_a, raw_b, labels_b,
                       with_viz: bool = True, noise: NoiseDict = None):
        """``gen_update`` on augmented raw batches (the collapse rescue's
        generator-only phases)."""
        return self._raw(self._gen, raw_a, labels_a, raw_b, labels_b,
                         with_viz, noise=noise)

    def post_update_raw(self, raw_a, labels_a, raw_b, labels_b,
                        mode: int = 3, with_viz: bool = True,
                        noise: NoiseDict = None):
        """``post_update`` on augmented raw batches."""
        heads = None
        if self.mesh is not None and mode not in (0, 1):
            heads = (self._to(self._augment(_head(raw_a))),
                     self._to(self._augment(_head(raw_b))))
        return self._raw(self._post, raw_a, labels_a, raw_b, labels_b,
                         with_viz, mode=mode, with_viz=with_viz, noise=noise,
                         heads=heads)

    # ------------------------------------------------------------------
    # multi-step variants: K steps per call over inputs stacked on a
    # leading K axis (a raw tuple leaf by leaf).  The JAX trainer runs
    # them as one lax.scan program; here they are a Python loop over the
    # single steps (one CUDA graph of the chunk would be the faster
    # form, not done).  ``noise`` is None or a list of K per-step noise
    # arguments.  Each returns (per-step metrics stacked to (K,) tensors,
    # the last step's outputs).
    # ------------------------------------------------------------------
    def _scan(self, step: Callable, xs: Sequence, noise: Optional[List]):
        first = xs[0][0] if isinstance(xs[0], tuple) else xs[0]
        k = len(first)
        if noise is not None and len(noise) != k:
            raise ValueError(f"{len(noise)} noise entries for {k} steps")
        mets, outs = [], None
        for i in range(k):
            met, outs = step(*(_step_slice(x, i) for x in xs),
                             noise=None if noise is None else noise[i])
            mets.append(met)
        stacked = {key: torch.stack([torch.as_tensor(m[key],
                                                     device=self.device)
                                     for m in mets]) for key in mets[0]}
        return stacked, outs

    def vae_scan(self, labels, noise: Optional[List] = None):
        """K pose-VAE steps on ``labels`` (K, B, D); the outputs are the
        last step's recons."""
        return self._scan(self.vae_update, (labels,), noise)

    def pretrain_scan(self, in_a, labels_a, in_b, labels_b,
                      raw: bool = False, feat_mat: bool = True,
                      with_viz: bool = True, noise: Optional[List] = None):
        """K ``pretrain_update`` (``raw=True``: ``pretrain_update_raw``)
        steps; without ``with_viz`` the outputs are None."""
        upd = self.pretrain_update_raw if raw else self.pretrain_update

        def step(ia, la, ib, lb, noise):
            return upd(ia, la, ib, lb, feat_mat=feat_mat, with_viz=with_viz,
                       noise=noise)

        return self._scan(step, (in_a, labels_a, in_b, labels_b), noise)

    def post_scan(self, in_a, labels_a, in_b, labels_b, raw: bool = False,
                  mode: int = 3, with_viz: bool = True,
                  noise: Optional[List] = None):
        """K posterior-regression steps (``raw=True``: on raw tuples)."""
        upd = self.post_update_raw if raw else self.post_update

        def step(ia, la, ib, lb, noise):
            return upd(ia, la, ib, lb, mode=mode, with_viz=with_viz,
                       noise=noise)

        return self._scan(step, (in_a, labels_a, in_b, labels_b), noise)

    # ------------------------------------------------------------------
    # visualization strip (lsps_trainer.py:264-276)
    # ------------------------------------------------------------------
    @staticmethod
    def assemble_outputs(images_a, images_b, network_outputs
                         ) -> torch.Tensor:
        """10-panel strip of the first sample's images side by side along
        the width (NHWC axis 2), float32 on the CPU; the panels may be
        tensors on any device or numpy arrays."""
        x_aa, x_ba, x_ab, x_bb, x_aba, x_bab, dec_a, dec_b = network_outputs
        panels = [images_a, x_aa, x_ab, x_aba, dec_a, dec_b,
                  images_b, x_bb, x_ba, x_bab]
        return torch.cat([torch.as_tensor(p)[0:1, :, :, 0:3].detach()
                          .to("cpu", torch.float32) for p in panels], dim=2)

    # ------------------------------------------------------------------
    # checkpoints: the JAX package's .npz files (train/checkpoint.py)
    # ------------------------------------------------------------------
    def save(self, snapshot_prefix: str, iterations: int,
             save_opt: bool = True) -> None:
        """gen/dis/map and the gen and dis optimizers, numbered
        ``iterations + 1``.  Under a mesh rank 0 writes and every rank
        waits for it."""
        if self._writes():
            ckpt.save(self, snapshot_prefix, iterations, save_opt)
        self.barrier()

    def save_vae(self, snapshot_prefix: str, iterations: int,
                 frac: float) -> None:
        if self._writes():
            ckpt.save_vae(self, snapshot_prefix, iterations, frac)
        self.barrier()

    def resume(self, snapshot_prefix: str, idx: int = -1,
               load_opt: bool = False, est: bool = False) -> int:
        """Load the latest snapshot set; returns its iteration (0 if
        none).  A resume with ``load_opt`` that finds no optimizer files
        of the same save still continues the LR schedule from that
        iteration, while Adam starts afresh, as the JAX trainer does."""
        iterations, opt_loaded = ckpt.resume(self, snapshot_prefix, idx,
                                             load_opt, est)
        if load_opt and iterations > 0 and not opt_loaded:
            self.gen_opt.sched_count = iterations
            self.dis_opt.sched_count = iterations
        return iterations

    def load_vae(self, snapshot_prefix: str, frac: float) -> bool:
        return ckpt.load_vae(self, snapshot_prefix, frac)
