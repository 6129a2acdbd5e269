"""The frozen byte counts, at shapes worked out by hand."""

from __future__ import annotations

from perfbench.bench import work


def test_step_bytes_by_hand():
    # 10 live particles (37 B), a 5-node grid array (20 B), 2 births
    # (47 B), 3 collided rows (24 B), 1 migrated row (42 B)
    assert work.step_bytes(10, 5, 2, 3, 1) == 370 + 20 + 94 + 72 + 42
    assert work.step_bytes(0, 0) == 0


def test_fused_launch_bytes_by_hand():
    # 3 species x 4 slots at 44 B, E on 9 nodes read (36 B) and, with a
    # deposit, rho on 9 nodes written (36 B)
    assert work.fused_launch_bytes(12, 9, False) == 528 + 36
    assert work.fused_launch_bytes(12, 9, True) == 528 + 72


def test_published_fused_launch_is_the_kernel_tables_bound():
    # PERF.md's kernel table: 0.6613 ms at 3.35 TB/s for (3, 16,777,216)
    ms = work.fused_launch_bytes(3 * 16_777_216, 102_401, False) / 3.35e9
    assert abs(ms - 0.6613) < 1e-3
