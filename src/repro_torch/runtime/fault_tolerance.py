"""Fault tolerance: checkpoint/restart loop with failure injection (the
port of ``repro.runtime.fault_tolerance``).

The restart contract: training state is (params, opt_state, step); the
data pipeline is a pure function of step; so restore-latest + resume is
bit-exact with the uninterrupted run. Straggler/hot-spare recovery reuses
the same path: a replacement host restores the latest checkpoint and
regenerates its data shard deterministically. Generic over ``step_fn``: the
PIC engine's own loop is ``runtime/resilience.run_engine``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.sharding.rules import is_dtensor


class SimulatedFailure(RuntimeError):
    """Raised by the failure injector at a step fence (stands in for a
    node loss / preemption in the integration tests)."""


@dataclasses.dataclass
class FailureInjector:
    """Raises once when the loop reaches ``fail_at_step``.

    ``once`` (the default) matches a real node loss: after the restart the
    process is a different one, so resuming *past* the fence must not
    re-raise. Set ``once=False`` for tests that want every pass to trip.
    """

    fail_at_step: int | None = None
    once: bool = True
    fired: bool = False

    def check(self, step: int) -> None:
        if self.fail_at_step is None or (self.once and self.fired):
            return
        if step == self.fail_at_step:
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")


def _floats(tree: Any) -> Any:
    """A metrics dict/list tree with every number a Python float."""
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_floats(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if is_dtensor(tree):
            tree = tree.full_tensor()
        return float(tree.detach().cpu())
    return float(tree)


def run_training(step_fn: Callable, batch_fn: Callable, params: Any,
                 opt_state: Any, *, num_steps: int, ckpt: Checkpointer,
                 ckpt_every: int = 5,
                 injector: FailureInjector | None = None,
                 start_step: int = 0) -> tuple[Any, Any, list]:
    """Run the loop with periodic async checkpoints; raises on injected
    failure AFTER any due checkpoint (like a crash between fences)."""
    metrics_log = []
    for step in range(start_step, num_steps):
        if injector is not None:
            injector.check(step)
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics_log.append(_floats(metrics))
        if (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    ckpt.wait()
    return params, opt_state, metrics_log


def resume_training(step_fn: Callable, batch_fn: Callable, *,
                    num_steps: int, ckpt: Checkpointer, ckpt_every: int = 5,
                    like: Any = None, device=None) -> tuple[Any, Any, list]:
    """Restart-from-latest: the recovery path after SimulatedFailure. The
    state resumes where ``like``'s tensors lie, and its other leaves on
    ``device`` (``Checkpointer.restore``: the card unless the caller asks
    for the CPU)."""
    step, state = ckpt.restore(like=like, device=device)
    return run_training(step_fn, batch_fn, state["params"], state["opt"],
                        num_steps=num_steps, ckpt=ckpt,
                        ckpt_every=ckpt_every, start_step=step)
