"""The open-loop stream's clock, driven by a fake clock."""

import pytest

from harness.clock import wait_until


class FakeClock:
    """A clock that each reading moves on by ``tick``."""

    def __init__(self, t, tick):
        self.t, self.tick, self.readings = t, tick, 0

    def now(self):
        self.readings += 1
        self.t += self.tick
        return self.t


@pytest.mark.parametrize("tick", [1e-7, 1e-5])
@pytest.mark.parametrize("ahead", [1e-6, 5e-4, 1e-3, 0.02, 1 / 30])
def test_never_before_due_and_within_a_reading_of_it(tick, ahead):
    clk = FakeClock(10.0, tick)
    due = 10.0 + ahead
    t = wait_until(due, clk.now)
    assert t >= due and clk.t == t
    assert t - due <= tick + 1e-12


@pytest.mark.parametrize("ahead", [-0.01, 0.0])
def test_a_frame_already_due_takes_one_reading(ahead):
    clk = FakeClock(5.0, 1e-6)
    assert wait_until(5.0 + ahead, clk.now) == pytest.approx(5.0 + 1e-6)
    assert clk.readings == 1
