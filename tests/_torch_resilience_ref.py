"""The reference side of ``tests/test_torch_resilience.py``'s cross-restore:
runs the JAX package's resilience layer on emulated host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/_torch_resilience_ref.py DIR

``DIR/port`` holds a checkpoint the port wrote at (D, async_n) = (2, 2).
The script restores it with the reference's ``resume_engine`` after
checking that ``_stored_matches`` sends it down the typed path, and writes
the restored leaves to ``DIR/port_restored.npz``. Then it runs the
reference engine ``STEPS`` steps from ``SEED``, checkpoints the state into
``DIR/ref`` with ``save_engine`` and writes the state's leaves to
``DIR/ref_state.npz``.
"""

import os
import sys

import numpy as np

D, ASYNC_N, NC, N, STEPS, SEED = 2, 2, 32, 256, 3, 1
BUDGET = 64                     # max_migration and max_births


def engine_config(configs):
    """The cross-restore's EngineConfig knobs, on either package's
    ``configs.pic_bit1`` (the domain count goes with the caller)."""
    return dict(pic_cfg=configs.make_resilience_config(nc=NC, n=N),
                async_n=ASYNC_N, max_migration=BUDGET, max_births=BUDGET)


def main(root):
    from repro.ckpt import checkpoint
    from repro.ckpt.checkpoint import Checkpointer
    from repro.configs import pic_bit1
    from repro.distributed import engine
    from repro.launch.mesh import make_debug_mesh
    from repro.runtime import resilience

    kw = engine_config(pic_bit1)
    ecfg = pic_bit1.make_engine_config(kw.pop("pic_cfg"), **kw)
    mesh = make_debug_mesh(data=D, model=1)

    port = Checkpointer(os.path.join(root, "port"))
    _, flat, _ = port.restore_flat()
    if not resilience._stored_matches(flat, engine.state_shape(ecfg, mesh)):
        raise SystemExit("the port's checkpoint does not match the "
                         "reference's typed layout")
    _, state = resilience.resume_engine(ecfg, mesh, port)
    np.savez(os.path.join(root, "port_restored.npz"),
             **checkpoint._flatten(state))

    state, _ = resilience.run_engine(
        ecfg, mesh, engine.init_engine_state(ecfg, mesh, SEED),
        num_steps=STEPS)
    resilience.save_engine(Checkpointer(os.path.join(root, "ref")), ecfg,
                           mesh, STEPS, state, blocking=True)
    np.savez(os.path.join(root, "ref_state.npz"),
             **checkpoint._flatten(state))


if __name__ == "__main__":
    main(sys.argv[1])
