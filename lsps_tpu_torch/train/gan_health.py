"""GAN-basin health: advisory notes + an online collapse guard.

The port's copy of ``lsps_tpu/train/gan_health.py`` (plain Python, no
framework).  The reference logs discriminator accuracies every display window
(src/trainers/lsps_trainer.py:194-199) but never acts on them.  Our
measured full-size chains (docs/BENCHMARKS.md "fused-step accuracy
A/B", a 2x2 seed/backend study) showed the accuracies PREDICT the
outcome: pretrain runs whose windowed dis_fake_acc stayed >= ~0.95 (the
generator almost never fools the discriminator) produced latent spaces
that opened the estimate stage at ~2x the error of healthy runs — and
the basin is visible in the acc tail thousands of iterations before the
run ends.  This module turns that signal into:

* :func:`gan_health_note` — the end-of-run advisory (printed by
  ``depth_train --mode pretrain`` since round 3);
* :class:`CollapseGuard` — an online detector; with
  ``depth_train --reseed-on-collapse N`` a dominant-basin pretrain is
  aborted at the detection point and restarted with a fresh seed
  instead of burning the remaining ~85% of the schedule on a run that
  is already known to be weak;
* :func:`overfit_note` — the estimate-mode analogue: test error rising
  while training continues (the reference only keeps best-so-far
  bookkeeping, src/depth_train.py:248-253).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

# Separates the measured basins: healthy arms ended <= 0.85 tail fake
# acc, weak (discriminator-dominant) arms >= 0.95.
FAKE_ACC_DOMINANT = 0.92

# The 2x2 study's dominant runs were distinguishable by ~3-4k
# iterations of the 20k schedule; checking from 3k keeps ~85% of the
# schedule recoverable on a reseed.
COLLAPSE_CHECK_ITER = 3000

# The reseed ACTION is confined to the first half of the schedule.
# Measured trigger points: true NYU collapse basins were detected at
# 4.4-7.6k of 20k (22-38%) and produced ~2x estimate error, while the
# ICVL record basin tripped the (NYU-calibrated) threshold only at
# 18.2k of 20k (91%) yet delivered the 8.52 mm record — late
# borderline dominance is a different, benign signature
# (docs/BENCHMARKS.md, round-4 ICVL re-run).  Past this fraction the
# guard stays advisory even with --reseed-on-collapse budget: a reseed
# there discards more work than it could save.
RESEED_WINDOW_FRAC = 0.5


def gan_health_note(acc_tail, threshold: float = None) -> Optional[str]:
    """Return an advisory string when pretrain ended discriminator-
    dominant (mean tail fake acc above ``threshold``), else None.
    ``acc_tail`` is an iterable of (dis_true_acc, dis_fake_acc) from
    the last display windows."""
    if threshold is None:
        threshold = FAKE_ACC_DOMINANT
    accs = list(acc_tail)
    if not accs:
        return None
    fake = sum(a[1] for a in accs) / len(accs)
    if fake < threshold:
        return None
    true = sum(a[0] for a in accs) / len(accs)
    return (f"NOTE: pretrain ended discriminator-dominant (tail "
            f"true/fake acc {true:.2f}/{fake:.2f}).  Measured chains in "
            f"this regime produced weak latent spaces (estimate-mode "
            f"error ~2x worse, docs/BENCHMARKS.md).  Consider re-running "
            f"pretrain with a different --seed before the estimate "
            f"stage.")


class CollapseGuard:
    """Online discriminator-dominance detector.

    Feed it the (true, fake) accuracy pair at every display window via
    :meth:`observe`; from ``check_iter`` onwards, once the window is
    full and its mean fake accuracy reaches ``threshold``, observe
    returns True exactly once (``triggered_at``/``triggered_fake``
    record the point).  The caller decides the action — depth_train
    restarts pretrain with a fresh seed when ``--reseed-on-collapse``
    budget remains.
    """

    def __init__(self, threshold: float = None,
                 check_iter: int = COLLAPSE_CHECK_ITER,
                 window: int = 5):
        self.threshold = (FAKE_ACC_DOMINANT if threshold is None
                          else threshold)
        self.check_iter = check_iter
        self.window = window
        self._tail = deque(maxlen=window)
        self.triggered_at: Optional[int] = None
        self.triggered_fake: Optional[float] = None

    def observe(self, iteration: int, true_acc: float,
                fake_acc: float) -> bool:
        """Record a display-window accuracy pair; True (once) when the
        run is detected dominant at/after ``check_iter``."""
        self._tail.append((float(true_acc), float(fake_acc)))
        if self.triggered_at is not None:
            return False
        if iteration < self.check_iter or len(self._tail) < self.window:
            return False
        fake = sum(a[1] for a in self._tail) / len(self._tail)
        if fake < self.threshold:
            return False
        self.triggered_at = iteration
        self.triggered_fake = fake
        return True

    @property
    def tail(self) -> List[Tuple[float, float]]:
        return list(self._tail)

    def reset(self) -> None:
        """Re-arm after an intervention: clear the trigger AND the
        window, so the guard needs ``window`` fresh post-intervention
        display cadences before it can fire again (hysteresis — stale
        pre-rescue accuracies must not retrigger instantly)."""
        self._tail.clear()
        self.triggered_at = None
        self.triggered_fake = None


class RescueController:
    """Detect-and-RESCUE companion to :class:`CollapseGuard`.

    The guard's reseed action (``--reseed-on-collapse``) burns every
    iteration spent so far and rolls a new seed; this controller tries
    the cheap fix first: when dominance is detected inside the early
    window, FREEZE the discriminator and run generator-only updates for
    ``phase_iters`` iterations (the limiting form of "temporarily
    reduce the dis LR while fake acc is dominant" — dis LR 0), then
    resume normal alternation with a re-armed guard.  The generator
    gets ``phase_iters`` uncontested steps to climb back to where the
    discriminator can be fooled at all; if dominance recurs after all
    ``budget`` phases, the caller falls through to its reseed/advisory
    behavior.  Opt-in (``--rescue-on-collapse N``); the parity default
    (0) leaves the reference's two-player schedule untouched
    (reference alternation: depth_train.py:153-161).

    Measured A/B vs the reseed action on the persistently
    collapse-prone seed-777 family: docs/BENCHMARKS.md ("collapse
    rescue A/B").
    """

    def __init__(self, budget: int, phase_iters: int = 500):
        self.budget = int(budget)
        self.phase_iters = int(phase_iters)
        self.phases_used = 0
        self._phase_end: Optional[int] = None
        self.history: List[Tuple[int, float]] = []  # (trigger_it, fake)

    @property
    def exhausted(self) -> bool:
        return self.phases_used >= self.budget

    def in_phase(self, iteration: int) -> bool:
        """True while ``iteration`` should run a generator-only step."""
        if self._phase_end is None:
            return False
        if iteration > self._phase_end:
            self._phase_end = None
            return False
        return True

    def start(self, guard: CollapseGuard, iteration: int) -> int:
        """Begin a gen-only phase at the trigger point; re-arms the
        guard.  Returns the last iteration of the phase."""
        self.phases_used += 1
        self._phase_end = iteration + self.phase_iters
        self.history.append((iteration, guard.triggered_fake))
        guard.reset()
        return self._phase_end


def overfit_note(err_history, rise_ratio: float = 1.15,
                 min_evals_past_best: int = 2) -> Optional[str]:
    """Advisory when estimate-mode test error is RISING while training
    continues: the latest eval sits ``rise_ratio`` above the best, and
    the best is at least ``min_evals_past_best`` evals old.  The
    measured estimate3 small-data chain showed exactly this (16.6 ->
    20.8 mm while train loss kept falling, docs/BENCHMARKS.md);
    best-so-far bookkeeping masks it.  ``err_history`` is a list of
    (iteration, mean_err_mm)."""
    hist = list(err_history)
    if len(hist) < min_evals_past_best + 1:
        return None
    best_idx = min(range(len(hist)), key=lambda i: hist[i][1])
    best_it, best_err = hist[best_idx]
    last_it, last_err = hist[-1]
    if (len(hist) - 1 - best_idx) < min_evals_past_best:
        return None
    if last_err < best_err * rise_ratio:
        return None
    return (f"NOTE: test error is rising while training continues "
            f"(best {best_err:.2f} mm at iteration {best_it}, latest "
            f"{last_err:.2f} mm at iteration {last_it}).  The snapshot "
            f"nearest the best eval is the one to keep; with small "
            f"--frac this is the measured overfit regime "
            f"(docs/BENCHMARKS.md) — consider stopping early.")
