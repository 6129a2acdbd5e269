"""Submit/step/poll session API over the ensemble engine (the port of
``repro.serve.service``).

The serving model is an inference engine's over its decode slots: a
fixed-width batch of slots, sessions inserted into free slots, the whole
batch advanced by one step call, finished sessions evicted and their slots
reused. A session is one simulation at one parameter point:

    svc = SimService(cfg, width=8)
    sid = svc.submit({"dt": 0.1, "ionization_rate": 2e-4}, seed=7, steps=50)
    svc.step(50)
    out = svc.poll(sid)        # {'status': 'done', 'diag': {...}, ...}

Where the reference compiles each hot function once per (config, width),
the port builds its CUDA kernels once per checkout: the first launch runs
``nvcc`` on the sources that have no library yet, and nothing builds after
that, whatever a session's parameter point, seed or slot. ``stats()``'s
``compiles`` counts those builds in this process, and the serving contract
is that it does not change after the first step.
``enable_compilation_cache`` points the build root at a directory, so a
new worker process finds the libraries there and builds nothing.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path

import numpy as np

from repro_torch.core import pic
from repro_torch.core.params import RuntimeParams, runtime_params
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.serve import ensemble


def enable_compilation_cache(path: str) -> None:
    """Build and look up the CUDA kernels' libraries under ``path``: a
    later process pointed at the same directory reuses them (the
    counterpart of JAX's persistent compilation cache)."""
    _build.BUILD_ROOT = Path(path)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy()


@dataclasses.dataclass
class Session:
    sid: str
    params: RuntimeParams
    seed: int
    steps: int
    slot: int | None = None
    steps_done: int = 0
    status: str = "queued"      # queued -> running -> done
    result: dict | None = None  # final-step diagnostics, on the host


class SimService:
    """Fixed-width simulation server over one ensemble step.

    ``width`` slots; ``submit`` claims a free slot (or queues), ``step``
    advances every running session, finished sessions free their slot for
    the next queued submission. All sessions share the configuration: a
    submit may vary only runtime parameters (see ``core/params.py``). The
    slots live on ``device`` (the card unless the caller asks for the
    CPU).
    """

    def __init__(self, cfg: pic.PICConfig, width: int = 4,
                 cache_dir: str | None = None, device="cuda"):
        if cache_dir is not None:
            enable_compilation_cache(cache_dir)
        self.cfg = cfg
        self.width = width
        self.device = resolve_device(device)
        self._step = ensemble.make_ensemble_step(cfg)
        self._init_member = ensemble.make_member_init(cfg, self.device)
        self._insert = ensemble.make_member_insert(cfg)
        self._release = ensemble.make_member_release(cfg)
        self.state = ensemble.init_ensemble(cfg, width, self.device)
        self._free: list[int] = list(range(width))
        self._queue: collections.deque[Session] = collections.deque()
        self._sessions: dict[str, Session] = {}
        self._by_slot: dict[int, Session] = {}
        self._last_diag: dict | None = None
        self._count = 0

    # -- session lifecycle ---------------------------------------------------

    def submit(self, overrides: dict | None = None, *,
               params: RuntimeParams | None = None,
               seed: int = 0, steps: int = 1) -> str:
        """Enqueue one simulation; returns its session id.

        ``overrides`` maps runtime-parameter names (dt, ionization_rate,
        emission_yield, b_field, collision_rates) to this session's values;
        pass ``params`` to supply a prebuilt ``RuntimeParams`` instead.
        The session starts at once if a slot is free.
        """
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if params is None:
            ov = dict(overrides or {})
            rates = ov.pop("collision_rates", None)
            params = runtime_params(self.cfg, collision_rates=rates,
                                    device=self.device, **ov)
        sid = f"s{self._count}"
        self._count += 1
        sess = Session(sid=sid, params=params, seed=seed, steps=steps)
        self._sessions[sid] = sess
        self._queue.append(sess)
        self._fill_slots()
        return sid

    def _fill_slots(self) -> None:
        while self._free and self._queue:
            sess = self._queue.popleft()
            slot = self._free.pop(0)
            member = self._init_member(sess.seed)
            self.state = self._insert(self.state, member, sess.params, slot)
            sess.slot = slot
            sess.status = "running"
            self._by_slot[slot] = sess

    def step(self, n: int = 1) -> int:
        """Advance all running sessions by up to ``n`` steps; finished
        sessions keep their final diagnostics, release their slot and pull
        the next queued session in. Returns the steps taken."""
        taken = 0
        for _ in range(n):
            if not self._by_slot:
                break
            self.state, diag = self._step(self.state)
            self._last_diag = diag
            taken += 1
            for slot in sorted(self._by_slot):
                sess = self._by_slot[slot]
                sess.steps_done += 1
                if sess.steps_done >= sess.steps:
                    sess.status = "done"
                    sess.result = {k: _host(v[slot])
                                   for k, v in diag.items()}
                    self.state = self._release(self.state, slot)
                    del self._by_slot[slot]
                    self._free.append(slot)
            self._fill_slots()
        return taken

    def poll(self, sid: str) -> dict:
        """Status and diagnostics of one session: a running session reports
        the latest step's diagnostics of its slot, a done one its final
        step's."""
        sess = self._sessions[sid]
        out = {"status": sess.status, "steps_done": sess.steps_done,
               "steps": sess.steps, "slot": sess.slot}
        if sess.status == "done":
            out["diag"] = sess.result
        elif sess.status == "running" and self._last_diag is not None:
            out["diag"] = {k: _host(v[sess.slot])
                           for k, v in self._last_diag.items()}
        return out

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        """Step until every submitted session has finished."""
        total = 0
        while (self._by_slot or self._queue) and total < max_steps:
            total += self.step(1)
        return total

    def stats(self) -> dict:
        """Server counters. ``compiles`` is the number of kernel builds
        (``nvcc`` runs) of this process: the serving contract is that it
        does not change after the first step."""
        return {
            "width": self.width,
            "running": len(self._by_slot),
            "queued": len(self._queue),
            "free": len(self._free),
            "sessions": len(self._sessions),
            "compiles": _build.builds,
        }
