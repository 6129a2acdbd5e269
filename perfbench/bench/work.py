"""The least bytes a step's work needs, frozen here so that the same work
reads the same whatever implements it (at the H100's 3.35 TB/s, see
``peaks``).

- each live particle: x and v read and written once, w and alive read
  once: 4 + 4 + 12 + 12 + 4 + 1 = 37 B;
- each grid array of the step, read or written once: 4 B a node;
- each ionization: two rows born (x, v, w, alive: 21 B each) and the
  neutral's alive and w written: 47 B;
- each collided row: its velocity read and written: 24 B;
- each row sent to another domain: read and written once: 42 B.

The fused push + deposit kernel's launches: each slot's x, v, w, alive
read (21 B) and x, v, w, alive and both wall masks written (23 B), E read
once, and with a deposit the charge density written once.
"""

PARTICLE = 37
BIRTH = 47
COLLIDED = 24
MIGRATED = 42
NODE = 4
FUSED_SLOT = 44


def step_bytes(live: float, grid_nodes: float, births: float = 0.0,
               collided_rows: float = 0.0, migrated: float = 0.0) -> float:
    return (PARTICLE * live + NODE * grid_nodes + BIRTH * births
            + COLLIDED * collided_rows + MIGRATED * migrated)


def fused_launch_bytes(slots: int, nodes: int, deposit: bool) -> float:
    return FUSED_SLOT * slots + NODE * nodes * (2 if deposit else 1)
