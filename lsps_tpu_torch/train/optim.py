"""Adam with coupled weight decay and a MultiStepLR, written out by hand.

Counterpart of ``lsps_tpu/train/optim.py`` (the optax chain
``add_decayed_weights(wd) -> scale_by_adam(0.5, 0.999, 1e-8) ->
scale_by_schedule(-lr(count))``).  ``torch.optim.Adam`` is not used: it
keeps a step count per parameter and skips a parameter whose grad is
None, while the JAX package keeps one count per optimizer and updates the
moments of every leaf on every step.  Here a parameter whose grad is None
gets a zero grad and no decay, and its moments are still updated: what
``zeroed_subtrees`` gives the JAX trainer.  The update runs in place on
the parameters and the moments.

As in the optax chain, Adam's bias correction and the schedule count
apart (``count`` and ``sched_count``, the chain's slots 1 and 2): both
move by one per step, but a resume without optimizer files sets only the
schedule's, so that the LR goes on while Adam starts afresh.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import torch

DIS_GEN_MILESTONES = (200, 300, 400, 450)
DIS_GEN_GAMMA = 0.5
VAE_MILESTONES = (125, 175)
VAE_GAMMA = 0.1


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 sch_interval: int) -> Callable[[int], float]:
    """LR of the update with optimizer count ``count``: the scheduler
    epoch is ``(count + 1) // sch_interval`` and the LR
    ``base * gamma ** #{m : epoch >= m}``."""

    def schedule(count: int) -> float:
        epochs = (count + 1) // sch_interval
        return base_lr * gamma ** sum(epochs >= m for m in milestones)

    return schedule


class AdamMultiStep:
    """Coupled weight decay -> Adam -> ``-lr(sched_count)`` over a fixed
    list of parameters, with one ``count`` (Adam's) and one
    ``sched_count`` (the schedule's) for all of them."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Callable[[int], float], weight_decay: float,
                 b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.sched_count = 0

    def current_lr(self) -> float:
        """The LR the next ``step`` applies."""
        return self.lr(self.sched_count)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update in place; ``grads[i]`` belongs to ``params[i]``."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} grads for {len(self.params)} "
                             f"parameters")
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        bc1 = 1 - b1 ** count_inc
        bc2 = 1 - b2 ** count_inc
        step_size = -self.lr(self.sched_count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if g is None:
                g = torch.zeros_like(p)
            else:
                g = g + self.weight_decay * p
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            p.add_(step_size * ((mu / bc1) / (torch.sqrt(nu / bc2)
                                               + self.eps)))
        self.count = count_inc
        self.sched_count += 1


def dis_optimizer(params, lr: float, sch_interval: int = 1000):
    """Discriminator: lr, wd 1e-4."""
    return AdamMultiStep(params, multistep_lr(lr, DIS_GEN_MILESTONES,
                                              DIS_GEN_GAMMA, sch_interval),
                         1e-4)


def gen_optimizer(params, lr: float, sch_interval: int = 1000):
    """Generator + mapping: lr, wd 1e-4."""
    return AdamMultiStep(params, multistep_lr(lr, DIS_GEN_MILESTONES,
                                              DIS_GEN_GAMMA, sch_interval),
                         1e-4)


def vae_optimizer(params, lr: float, sch_interval: int = 1000):
    """Pose VAE: lr x10, wd 1e-3."""
    return AdamMultiStep(params, multistep_lr(lr * 10.0, VAE_MILESTONES,
                                              VAE_GAMMA, sch_interval),
                         1e-3)
