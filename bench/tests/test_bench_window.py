"""The measured window's closing rule and the rates taken over it."""
from bench import harness as H


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_closes_at_the_first_step_boundary_after_its_seconds():
    clock = Clock()
    win = H.Window(1.0, clock)
    steps = 0
    while win.more():
        clock.t += 0.3          # a step of 0.3 s
        steps += 1
    assert steps == 4           # 0.9 s is inside, the 4th step ends at 1.2
    clock.t += 0.05             # the device finishing after the host
    assert abs(win.close() - 1.25) < 1e-12


def test_a_step_longer_than_the_window_still_runs_once():
    clock = Clock()
    win = H.Window(0.5, clock)
    steps = 0
    while win.more():
        clock.t += 2.0
        steps += 1
    assert steps == 1 and win.close() == 2.0


def test_checks_hold_at_their_limit_and_fail_past_it_or_on_nan():
    assert H.Check("x", 1e-5, 1e-5).ok
    assert not H.Check("x", 1.1e-5, 1e-5).ok
    assert not H.Check("x", float("nan"), 1.0).ok
    assert H.Check("count", 0.0, 0).ok and not H.Check("count", 1.0, 0).ok
    assert H._finite(float("inf")) == 1e300
    assert H._finite(float("nan")) == 1e300
