# coding=utf-8
"""The work count against hand counts for one tetrahedron and one
triangle, and the least-time rule."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import work  # noqa: E402


def test_tet_counts():
    # rows: the vertex-0 row (3 components x 2 adds) + 4 rows x 3 adds.
    assert work.rows(3) == 18
    # an apply: 9 edge differences, K·S 9 entries x (3 mul + 2 add), rows.
    assert work.apply_ops(3) == 9 + 45 + 18
    # implicit substep, 1 tet, 4 particles, 0 iterations: chain + rows,
    # rhs 4·3·4, 3 applies of (72 + 4·3·4), advection 40·4.
    assert work.implicit_substep_ops(1, 4, 3, 0) == 448 + 48 + 3 * 120 + 160
    # 2 iterations: 7 applies and 2·10·3·4 of vector work.
    assert work.implicit_substep_ops(1, 4, 3, 2) == (448 + 48 + 7 * 120 + 240
                                                     + 160)
    assert work.explicit_substep_ops(1, 4, 3) == 218 + 160
    assert work.frame_ops(1, 4, 3, False, [0, 2]) == 1016 + 1736
    assert work.frame_ops(1, 4, 3, True, [0] * 5) == 5 * 378


def test_triangle_counts():
    assert work.rows(2) == 2 + 6
    assert work.apply_ops(2) == 4 + 12 + 8
    assert work.implicit_substep_ops(1, 3, 2, 1) == (144 + 24 + 5 * 48 + 60
                                                     + 81)
    assert work.explicit_substep_ops(1, 3, 2) == 68 + 81


def test_bytes_read_once_written_once():
    # implicit tet, 10 substeps, one circle: pos, vel, vel_g in (36), mass
    # (4), indices (4), R⁻¹ (9), volume (1), circle (4); out 36 + 2·10.
    assert work.frame_bytes(1, 4, 3, False, 10, 1) == 4 * (58 + 56)
    assert work.frame_bytes(1, 4, 3, True, 50, 1) == 4 * (46 + 24)
    # triangle, explicit, no circle: pos and vel in (12), mass 3, indices
    # 3, R⁻¹ 4, volume 1; out 12.
    assert work.frame_bytes(1, 3, 2, True, 50, 0) == 4 * (23 + 12)


def test_least_seconds_is_the_larger_bound():
    assert work.least_seconds(67e12, 0) == 1.0
    assert work.least_seconds(0, 3.35e12) == 1.0
    assert work.least_seconds(67e9, 3.35e12) == 1.0
