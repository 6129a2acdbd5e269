"""Online engine-knob auto-tuner: close the metrics -> knobs loop (the port
of ``repro.obs.autotune``).

The engine's schedule knobs (``async_n``, ``max_migration``, ``max_births``,
``rebalance_every``, ``rebalance_skew``) are compile-time constants chosen
by hand; the metrics stream measures exactly the quantities they exist to
control (overflow counters, queue occupancy skew, step wall time) — but
until now nothing connected the two. This module is that connection: an
online controller that watches a window of step records and retunes the
knobs between steps.

The knobs are fixed when the step function is built, so a retune builds a
new one: ``AutoTuner`` swaps the ``EngineConfig``, carries the live state
across with ``engine.retarget_state`` (exact — in-flight pending rows are
flushed, nothing is dropped) and builds a fresh step function, with its own
CUDA streams and events, after the card has finished every kernel of the
old one. The policy is deliberately conservative: one decision per
``window`` steps, and only when the measurements clearly call for it.

The policy itself is a pure function, ``decide(ecfg, window, policy)`` —
records in, knob changes out — so the control law is unit-testable without
running the engine:

* **overflow -> grow**: any ``*/migration_overflow`` in the window doubles
  ``max_migration`` (capped); ``birth_overflow``/``*/emission_overflow``
  double ``max_births``. Overflowed particles are retried, not lost, but a
  persistent overflow serializes migration across extra steps.
* **calm -> shrink**: no overflow and peak observed traffic under
  ``shrink_frac`` of the budget halves it (floored) — smaller packs mean
  smaller migration packs and pending blocks.
* **skew -> rebalance**: peak queue-occupancy skew above ``skew_frac`` of
  the mean per-queue occupancy arms ``rebalance_skew`` at that threshold
  (the queue-adaptive re-split); if an armed trigger leaves the skew
  unresolved, a periodic ``rebalance_every = window`` is added as backstop.
* **async_n hill-climb** (``tune_async_n=True``, off by default): when the
  measurements are otherwise calm, candidate queue counts (powers of two
  respecting the engine's divisibility constraints) are each given one
  window and scored by median step wall time; the best sticks. Off by
  default because wall time on shared hosts is noisy — the other rules act
  on exact counters.

All knob changes respect the engine's invariants: budgets stay multiples
of ``async_n``, and ``async_n`` candidates must divide the budgets and the
local capacity.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.obs.metrics import MetricsStream, StepMetrics, host_values


@dataclasses.dataclass(frozen=True)
class TunerPolicy:
    """The control law's constants (see module docstring for the rules)."""

    window: int = 8            # steps per decision (and per climb trial)
    skew_frac: float = 0.25    # skew > frac * mean queue occ -> rebalance
    shrink_frac: float = 0.25  # peak traffic < frac * budget -> halve it
    min_budget: int = 64       # floor for shrunk budgets
    max_budget: int = 65536    # cap for grown budgets
    tune_async_n: bool = False
    async_candidates: tuple[int, ...] = (1, 2, 4, 8)
    climb_tolerance: float = 0.05   # a trial must win by 5% to dethrone


def _peak(window: list[StepMetrics], suffixes: tuple[str, ...],
          exact: tuple[str, ...] = ()) -> float:
    vals = [v for m in window for k, v in m.counters.items()
            if k.endswith(suffixes) or k in exact]
    return max(vals, default=0.0)


def _total(window: list[StepMetrics], suffixes: tuple[str, ...],
           exact: tuple[str, ...] = ()) -> float:
    return sum(v for m in window for k, v in m.counters.items()
               if k.endswith(suffixes) or k in exact)


def _round_to(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n (engine divisibility)."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def decide(ecfg, window: list[StepMetrics],
           policy: TunerPolicy) -> dict[str, int]:
    """The pure control law: a window of records -> engine-knob changes.

    Returns a (possibly empty) dict of ``EngineConfig`` field overrides;
    every value already respects the engine's divisibility invariants for
    the CURRENT ``async_n``.
    """
    if not window:
        return {}
    changes: dict[str, int] = {}
    n_q = ecfg.async_n

    # --- migration budget ---
    if _total(window, ("/migration_overflow",)) > 0:
        grown = _round_to(min(ecfg.max_migration * 2, policy.max_budget), n_q)
        if grown > ecfg.max_migration:
            changes["max_migration"] = grown
    else:
        peak = _peak(window, ("/migrated_left", "/migrated_right"))
        if (ecfg.max_migration > policy.min_budget
                and peak < policy.shrink_frac * ecfg.max_migration):
            shrunk = _round_to(max(policy.min_budget,
                                   ecfg.max_migration // 2), n_q)
            if shrunk < ecfg.max_migration:
                changes["max_migration"] = shrunk

    # --- birth/emission budget (only meaningful with MC sources on) ---
    has_births = any(k == "n_ionized" or k.endswith("/emitted")
                     for m in window for k in m.counters)
    if has_births:
        if _total(window, ("/emission_overflow",), ("birth_overflow",)) > 0:
            grown = _round_to(min(ecfg.max_births * 2, policy.max_budget),
                              n_q)
            if grown > ecfg.max_births:
                changes["max_births"] = grown
        else:
            peak = _peak(window, ("/emitted",), ("n_ionized",))
            if (ecfg.max_births > policy.min_budget
                    and peak < policy.shrink_frac * ecfg.max_births):
                shrunk = _round_to(max(policy.min_budget,
                                       ecfg.max_births // 2), n_q)
                if shrunk < ecfg.max_births:
                    changes["max_births"] = shrunk

    # --- queue balance ---
    occ_means = [sum(occ) / max(len(occ), 1)
                 for m in window for occ in m.queues.values()]
    mean_occ = max(occ_means, default=0.0)
    skew = _peak(window, ("/queue_skew",))
    if mean_occ > 0 and skew > policy.skew_frac * mean_occ:
        threshold = max(1, int(policy.skew_frac * mean_occ))
        if ecfg.rebalance_skew == 0 or threshold < ecfg.rebalance_skew:
            changes["rebalance_skew"] = threshold
        elif ecfg.rebalance_every == 0:
            # the armed skew trigger didn't resolve it: periodic backstop
            changes["rebalance_every"] = policy.window
    return changes


def _median_wall(window: list[StepMetrics]) -> float:
    walls = sorted(m.wall_us for m in window)
    return walls[len(walls) // 2] if walls else float("inf")


class AutoTuner:
    """Run the engine step and retune its knobs from the measured stream.

    Drop-in for the plain step loop::

        tuner = AutoTuner(ecfg, stream=stream)
        for _ in range(steps):
            state, diag = tuner.run_step(state)
        ecfg = tuner.ecfg            # the knobs the run converged to

    ``run_step`` times the step (waiting for the diagnostics on the host —
    the metrics record needs their values anyway), records it, and every
    ``policy.window`` steps applies ``decide``. A knob change rebuilds the
    step function and carries the state across with
    ``engine.retarget_state``; ``log`` keeps a human-readable line per
    retune and ``retunes`` counts them.
    """

    def __init__(self, ecfg, *, stream: MetricsStream | None = None,
                 policy: TunerPolicy | None = None):
        from repro_torch.distributed import engine as engine_mod

        self._engine = engine_mod
        self.policy = policy or TunerPolicy()
        # the stream records are the controller's only input; the metrics
        # toggle is diagnostics-only, so enabling it never perturbs physics
        self.ecfg = (ecfg if ecfg.metrics
                     else dataclasses.replace(ecfg, metrics=True))
        self.stream = stream if stream is not None else MetricsStream(
            capacity=max(4 * self.policy.window, 64))
        self.log: list[str] = []
        self.retunes = 0
        self._step = engine_mod.make_engine_step(self.ecfg)
        self._since = 0
        # async_n hill-climb state: remaining candidates and best-so-far
        self._climb_queue: list[int] | None = None
        self._best: tuple[float, int] | None = None   # (median wall, n)

    def run_step(self, state):
        t0 = time.perf_counter()
        state, diag = self._step(state)
        values = host_values(diag)
        self.stream.record(values, wall_us=(time.perf_counter() - t0) * 1e6)
        self._since += 1
        if self._since >= self.policy.window:
            self._since = 0
            state = self._retune(state)
        return state, diag

    # ------------------------------------------------------------ internals

    def _apply(self, state, changes: dict[str, int]):
        new = dataclasses.replace(self.ecfg, **changes)
        dev = state.groups[0].x.device
        if dev.type == "cuda":
            # the new step brings its own streams: nothing of the old
            # step's may still be in flight
            torch.cuda.synchronize(dev)
        state = self._engine.retarget_state(self.ecfg, new, state)
        desc = ", ".join(f"{k}: {getattr(self.ecfg, k)} -> {v}"
                         for k, v in sorted(changes.items()))
        self.ecfg = new
        self._step = self._engine.make_engine_step(new)
        self.retunes += 1
        self.log.append(desc)
        return state

    def _valid_async(self, n: int) -> bool:
        if n < 1 or self.ecfg.max_migration % n:
            return False
        if self.ecfg.pic.ionization is not None and self.ecfg.max_births % n:
            return False
        return all(self.ecfg.local_cap(sc) % n == 0
                   for sc in self.ecfg.pic.species)

    def _retune(self, state):
        window = self.stream.window(self.policy.window)
        changes = decide(self.ecfg, window, self.policy)
        if changes:
            # counter-driven changes win; restart any climb afterwards
            self._climb_queue, self._best = None, None
            return self._apply(state, changes)
        if not self.policy.tune_async_n:
            return state

        # hill-climb: give each valid candidate one window, keep the best
        med = _median_wall(window)
        if self._climb_queue is None:
            self._best = (med, self.ecfg.async_n)
            self._climb_queue = [n for n in self.policy.async_candidates
                                 if n != self.ecfg.async_n
                                 and self._valid_async(n)]
        else:
            best_med, best_n = self._best
            if med < best_med * (1.0 - self.policy.climb_tolerance):
                self._best = (med, self.ecfg.async_n)
        if self._climb_queue:
            nxt = self._climb_queue.pop(0)
            return self._apply(state, {"async_n": nxt})
        best_n = self._best[1]
        if best_n != self.ecfg.async_n:
            return self._apply(state, {"async_n": best_n})
        return state
