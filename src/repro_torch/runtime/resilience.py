"""Resilient engine run loop: async checkpoints, restart, elastic restore
(the port of ``repro.runtime.resilience``).

* ``run_engine`` drives ``engine.make_engine_step`` with a
  ``FailureInjector`` fence at the top of every step and an asynchronous
  checkpoint of the full ``EngineState`` every ``ckpt_every`` steps: the
  step loop pays only the copy to host memory; the npz and manifest are
  written on the checkpointer's writer thread. The synchronous cost shows
  up in the metrics stream as ``ckpt/bytes``/``ckpt/fetch_us`` (and the
  off-thread ``ckpt/write_us``).
* ``resume_engine`` restores the newest complete checkpoint. Same layout as
  the save (domains, async_n, budgets) -> a typed restore, bitwise in every
  leaf; a checkpoint the port wrote on the same kind of device also brings
  back each domain's generator state (``meta["torch_rng"]``), so the
  resumed run is bit-identical to the uninterrupted one. Otherwise (a
  reference checkpoint, or one from the other kind of device) the
  generators are seeded from the key rows. Another domain count -> the
  elastic path: ``engine.resplit_host`` + ``engine.elastic_state``
  (deterministic and exactly conservative, with a re-seeded RNG stream).

The files hold the reference's keys, shapes and dtypes, and the manifest's
``meta`` the reference's keys, so each package restores the other's
checkpoints on its typed path when the layouts match.

Checkpoints are labeled with the *next* step to run (save after step k is
labeled k+1), and ``EngineState.step`` carries the same value, so
``run_engine`` resumes from ``state.step`` with no external counter.
"""

from __future__ import annotations

import signal
import time
from typing import Any

import torch

from repro_torch.ckpt.checkpoint import (Checkpointer, _leaves, _path_str,
                                         tensors_from_flat)
from repro_torch.device import resolve_device
from repro_torch.distributed import engine
from repro_torch.obs.metrics import MetricsStream, host_values
from repro_torch.runtime.fault_tolerance import FailureInjector


def save_engine(ckpt: Checkpointer, ecfg: engine.EngineConfig, step: int,
                state: engine.EngineState, blocking: bool = False) -> dict:
    """Checkpoint an EngineState; the manifest records the engine layout
    (the reference's keys) so ``resume_engine`` can decide typed-vs-elastic
    without a config side-channel, and each domain's generator state.
    Returns the ``Checkpointer.save`` info dict."""
    meta = {"kind": "engine", "domains": ecfg.num_domains(),
            "async_n": ecfg.async_n, "nc": ecfg.pic.nc,
            "use_ring": ecfg.use_ring, "step": int(step),
            "torch_rng": {"device": state.gens[0].device.type,
                          "states": [g.get_state().numpy().tobytes().hex()
                                     for g in state.gens]}}
    return ckpt.save(step, engine.state_tree(state), blocking=blocking,
                     meta=meta)


def _stored_matches(flat: dict, like: Any) -> bool:
    """True when the stored leaves match ``like`` key-for-key and
    shape-for-shape — the precondition for a bitwise typed restore."""
    want = {_path_str(p): tuple(ref.shape) for p, ref in _leaves(like)}
    return (set(want) == set(flat)
            and all(want[k] == flat[k].shape for k in want))


def resume_engine(ecfg: engine.EngineConfig, ckpt: Checkpointer,
                  step: int | None = None, device="cuda"
                  ) -> tuple[int, engine.EngineState]:
    """Restore the newest complete engine checkpoint onto ``device``.

    Bitwise when the stored layout matches the current config (same D,
    async_n, budgets); otherwise the elastic re-split path.
    """
    dev = resolve_device(device)
    step, flat, manifest = ckpt.restore_flat(step)
    meta = manifest.get("meta", {}) or {}
    if "pic/key" not in flat:
        raise ValueError(
            f"checkpoint step {step} in {ckpt.dir} is not an engine "
            f"checkpoint (kind={meta.get('kind')!r})")
    like = engine.state_shape(ecfg)
    if _stored_matches(flat, like):
        tree = tensors_from_flat(flat, manifest.get("dtypes", {}), like,
                                 engine.state_shardings(ecfg, dev))
        state = engine.state_from_tree(ecfg, tree, device=dev)
        rng = meta.get("torch_rng") or {}
        if (rng.get("device") == dev.type
                and len(rng.get("states", ())) == len(state.gens)):
            for g, h in zip(state.gens, rng["states"]):
                g.set_state(torch.frombuffer(bytearray.fromhex(h),
                                             dtype=torch.uint8))
        return step, state
    d_old = int(meta.get("domains") or flat["pic/key"].shape[0])
    species, counts = engine.resplit_host(ecfg, flat, d_old=d_old)
    state = engine.elastic_state(ecfg, species, counts, flat["pic/key"][0],
                                 step=int(flat["pic/step"]), device=dev)
    return step, state


def run_engine(ecfg: engine.EngineConfig, state: engine.EngineState, *,
               num_steps: int, ckpt: Checkpointer | None = None,
               ckpt_every: int = 0,
               injector: FailureInjector | None = None,
               stream: MetricsStream | None = None,
               step_fn: Any = None, collect: bool = True,
               handle_sigterm: bool = True
               ) -> tuple[engine.EngineState, list[dict]]:
    """Drive engine steps from ``state.step`` to ``num_steps`` with
    periodic async checkpoints; raises ``SimulatedFailure`` at the
    injector's fence AFTER any due checkpoint (a crash between fences).

    SIGTERM (the preemption signal cluster schedulers send before a kill)
    is handled cooperatively when ``handle_sigterm``: the handler only sets
    a flag, the loop notices it at the next step boundary, stops, and — if
    a checkpointer is attached — writes one final BLOCKING checkpoint
    labeled with the next step to run, so ``resume_engine`` restarts the
    preempted run bitwise. The previous handler is restored on exit, and
    installation is skipped off the main thread (``signal.signal`` raises
    there).

    With ``collect`` or a ``stream`` each step's diag goes to the host
    (one copy, which waits for the step, inside the step's wall time).
    Returns ``(state, diags)`` — one host diag dict per executed step when
    ``collect`` (the bitwise-restart tests compare these too).
    """
    if step_fn is None:
        step_fn = engine.make_engine_step(ecfg)
    start = int(state.step)
    diags: list[dict] = []
    stop = {"seen": False}
    prev_handler: Any = None
    installed = False
    if handle_sigterm:
        def _on_term(signum, frame):
            stop["seen"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
            installed = True
        except ValueError:  # not the main thread; run unprotected
            pass
    done_through = start  # steps completed; label of the next step to run
    last_saved = None
    try:
        for step in range(start, num_steps):
            if stop["seen"]:
                break
            if injector is not None:
                injector.check(step)
            t0 = time.perf_counter()
            state, diag = step_fn(state)
            done_through = step + 1
            if collect or stream is not None:
                diag = host_values(diag)
            extra = None
            if ckpt is not None and ckpt_every > 0 \
                    and (step + 1) % ckpt_every == 0:
                info = save_engine(ckpt, ecfg, step + 1, state)
                last_saved = step + 1
                extra = {"ckpt/bytes": float(info["bytes"]),
                         "ckpt/fetch_us": float(info["fetch_us"]),
                         "ckpt/write_us": float(ckpt.last_write_us)}
            wall_us = (time.perf_counter() - t0) * 1e6
            if collect:
                diags.append(diag)
            if stream is not None:
                stream.record(diag, wall_us=wall_us, step=step, extra=extra)
        if stop["seen"] and ckpt is not None and last_saved != done_through:
            save_engine(ckpt, ecfg, done_through, state, blocking=True)
    finally:
        if installed:
            signal.signal(signal.SIGTERM, prev_handler)
        # flush the in-flight write even when the injector fence fires: the
        # drill simulates a crash *between* fences, after durable I/O — the
        # truly-torn-write case is covered by the Checkpointer's
        # manifest-last protocol (tests/test_torch_resilience.py)
        if ckpt is not None:
            ckpt.wait()
    return state, diags
