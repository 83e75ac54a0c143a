"""The wait for the card's fast launch level (``lib/launch.py``), with a
stand-in for the probe graph: the steps go on until a reading is fast, and
no longer than the cap."""

from lib import launch


class StandIn:
    """Reads the slow mode ``slow_reads`` times, then the fast level."""

    fast = 1.0
    slow = launch.Probe.slow

    def __init__(self, slow_reads: int):
        self.left = slow_reads

    def read(self) -> float:
        self.left -= 1
        return 1.18 if self.left >= 0 else 1.004


def test_settle_steps_until_the_fast_level():
    calls = []
    got = launch.settle(lambda: calls.append(1), StandIn(3), cap_s=60.0)
    assert got["fast"] and got["steps"] == 3 * launch.BATCH == len(calls)


def test_settle_takes_no_step_when_fast():
    calls = []
    got = launch.settle(lambda: calls.append(1), StandIn(0), cap_s=60.0)
    assert got["fast"] and got["steps"] == 0 and not calls


def test_settle_stops_at_its_cap():
    got = launch.settle(lambda: None, StandIn(10**9), cap_s=0.05)
    assert not got["fast"] and got["steps"] > 0 and got["wait_s"] >= 0.05
