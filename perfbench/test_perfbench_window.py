"""The measured window runs whole episodes: it reads the clock only where
an episode ends, so a run never stops part way through one."""

from __future__ import annotations

import pytest
import torch

from perfbench.bench import window


class Counter:
    """A driver that only counts its steps and restores."""

    def __init__(self):
        self.steps = self.restores = 0

    def step(self) -> dict:
        self.steps += 1
        return {}

    def restore(self) -> None:
        self.restores += 1


@pytest.mark.parametrize("episode_steps,done", [(1, 0), (3, 0), (7, 0),
                                                (5, 2)])
def test_the_window_ends_where_an_episode_ends(episode_steps, done):
    """With no time to run, the window still finishes the episode it
    starts in: from its start, or ``done`` steps into it."""
    drv = Counter()
    runner = window.Runner(drv, episode_steps)
    for _ in range(done):
        runner.advance()
    res = window.measure(runner, 0.0, torch.device("cpu"))
    assert res["steps"] == len(res["step_times_ms"]) == episode_steps - done
    assert drv.steps == episode_steps and drv.restores == 1
    assert runner.pos == 0
