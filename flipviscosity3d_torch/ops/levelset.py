"""Geometric level-set fractions, vectorized and branchless.

"Fraction of a segment / square face / tetrahedron / cube inside phi < 0"
from corner samples, with the semantics of the reference
(levelsetutils.cpp:15-251): every case analysis is a data-parallel select
over all rotations and orderings, written in the same arithmetic order as
the JAX package's ops/levelset.py.
"""

from __future__ import annotations

import torch


def _safe_div(num, den):
    """num/den where den is nonzero in the selected branch; the unselected
    branch divides by 1 so it never produces inf/nan."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def fraction_inside(phi_left, phi_right):
    """1D: fraction of the segment between two samples with phi < 0
    (levelsetutils.cpp:15-27)."""
    phi_left, phi_right = torch.broadcast_tensors(phi_left, phi_right)
    in_l = phi_left < 0
    in_r = phi_right < 0
    frac_l = _safe_div(phi_left, phi_left - phi_right)
    frac_r = _safe_div(phi_right, phi_right - phi_left)
    zero = torch.zeros_like(phi_left)
    return torch.where(
        in_l & in_r, torch.ones_like(phi_left),
        torch.where(in_l, frac_l, torch.where(in_r, frac_r, zero)))


def fraction_inside_quad(phi_bl, phi_br, phi_tl, phi_tr):
    """2D: fraction of a square face inside phi < 0 (marching-squares cases,
    levelsetutils.cpp:38-119). Corners are walked cyclically as
    [bl, br, tr, tl]; every rotation's result is computed and the one the
    reference would stop at is selected arithmetically."""
    l0, l1, l2, l3 = torch.broadcast_tensors(phi_bl, phi_br, phi_tr, phi_tl)
    corners = (l0, l1, l2, l3)
    inside = [c < 0 for c in corners]
    count = sum(i.to(torch.int32) for i in inside)
    rotations = [tuple(corners[(r + s) % 4] for s in range(4))
                 for r in range(4)]
    zero = torch.zeros_like(l0)

    res3 = zero
    for a0, a1, a2, a3 in rotations:
        sel = (a0 >= 0).to(l0.dtype)
        side0 = 1.0 - fraction_inside(a0, a3)
        side1 = 1.0 - fraction_inside(a0, a1)
        res3 = res3 + sel * (1.0 - 0.5 * side0 * side1)

    res1 = zero
    for a0, a1, a2, a3 in rotations:
        sel = (a0 < 0).to(l0.dtype)
        res1 = res1 + sel * (
            0.5 * fraction_inside(a0, a3) * fraction_inside(a0, a1))

    res2_adj = zero
    adjacent = torch.zeros_like(inside[0])
    for a0, a1, a2, a3 in rotations:
        hit = (a0 < 0) & (a1 < 0)
        adjacent = adjacent | hit
        res2_adj = res2_adj + hit.to(l0.dtype) * 0.5 * (
            fraction_inside(a0, a3) + fraction_inside(a1, a2))

    # diagonal case: two rotations qualify with identical results
    mid = 0.25 * (l0 + l1 + l2 + l3)
    res2_diag = zero
    for a0, a1, a2, a3 in rotations:
        sel = ((a0 < 0) & (a1 >= 0) & (a2 < 0) & (a3 >= 0)).to(l0.dtype)
        area_neg = (
            1.0
            - 0.5 * (1.0 - fraction_inside(a0, a3))
            * (1.0 - fraction_inside(a2, a3))
            - 0.5 * (1.0 - fraction_inside(a2, a1))
            * (1.0 - fraction_inside(a0, a1))
        )
        area_pos = 0.5 * fraction_inside(a0, a1) * fraction_inside(a0, a3) + (
            0.5 * fraction_inside(a2, a1) * fraction_inside(a2, a3))
        res2_diag = res2_diag + sel * torch.where(mid < 0, area_neg, area_pos)
    res2_diag = 0.5 * res2_diag

    res2 = torch.where(adjacent, res2_adj, res2_diag)
    one = torch.ones_like(l0)
    return torch.where(
        count == 4, one,
        torch.where(count == 3, res3,
                    torch.where(count == 2, res2,
                                torch.where(count == 1, res1, zero))))


def _sorted_triangle_fraction(phi0, phi1, phi2):
    """Area fraction when phi0 has the lone sign (levelsetutils.h:40-43)."""
    return _safe_div(phi0 * phi0, 2.0 * (phi0 - phi1) * (phi0 - phi2))


def area_fraction_triangle(phi0, phi1, phi2):
    """Fraction of a triangle inside phi < 0 (levelsetutils.cpp:121-145).
    The all-inside triangle gives 0, as the reference's does
    (levelsetutils.cpp:124-126) and the JAX package's."""
    phi0, phi1, phi2 = torch.broadcast_tensors(
        *(torch.as_tensor(p, dtype=torch.float32) for p in (phi0, phi1,
                                                             phi2)))
    n0, n1, n2 = phi0 < 0, phi1 < 0, phi2 < 0
    count = n0.to(torch.int32) + n1.to(torch.int32) + n2.to(torch.int32)
    rot = ((phi0, phi1, phi2), (phi1, phi2, phi0), (phi2, phi0, phi1))
    lone = [_sorted_triangle_fraction(*r) for r in rot]
    # count 1: the lone negative corner's fraction; count 2: one less the
    # lone positive corner's
    c1 = torch.where(n0, lone[0], torch.where(n1, lone[1], lone[2]))
    c2 = torch.where(~n0, 1.0 - lone[0],
                     torch.where(~n1, 1.0 - lone[1], 1.0 - lone[2]))
    zero = torch.zeros_like(phi0)
    return torch.where(count == 3, zero, torch.where(
        count == 2, c2, torch.where(count == 1, c1, zero)))


def area_fraction_quad(phi00, phi10, phi01, phi11):
    """Fraction of a square inside phi < 0 by the centre-point fan of four
    triangles (levelsetutils.cpp:173-179)."""
    mid = 0.25 * (phi00 + phi10 + phi01 + phi11)
    return 0.25 * (area_fraction_triangle(phi00, phi10, mid)
                   + area_fraction_triangle(phi10, phi11, mid)
                   + area_fraction_triangle(phi11, phi01, mid)
                   + area_fraction_triangle(phi01, phi00, mid))


def _sort4(a, b, c, d):
    """Sorting network matching levelsetutils.h:_sort (5 compare-swaps)."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    c, d = torch.minimum(c, d), torch.maximum(c, d)
    a, c = torch.minimum(a, c), torch.maximum(a, c)
    b, d = torch.minimum(b, d), torch.maximum(b, d)
    b, c = torch.minimum(b, c), torch.maximum(b, c)
    return a, b, c, d


def _sorted_tet_fraction(phi0, phi1, phi2, phi3):
    """phi0 lone-signed corner of a tet (levelsetutils.h:45-50)."""
    return _safe_div(
        phi0 * phi0 * phi0, (phi0 - phi1) * (phi0 - phi2) * (phi0 - phi3))


def _sorted_prism_fraction(phi0, phi1, phi2, phi3):
    """phi0,phi1 < 0 <= phi2,phi3 prism case (levelsetutils.h:52-59)."""
    a = _safe_div(phi0, phi0 - phi2)
    b = _safe_div(phi0, phi0 - phi3)
    c = _safe_div(phi1, phi1 - phi3)
    d = _safe_div(phi1, phi1 - phi2)
    return a * b * (1.0 - d) + b * (1.0 - c) * d + c * d


def volume_fraction_tet(phi0, phi1, phi2, phi3):
    """Fraction of a tetrahedron inside phi < 0 (levelsetutils.cpp:189-202)."""
    p0, p1, p2, p3 = _sort4(*torch.broadcast_tensors(phi0, phi1, phi2, phi3))
    zero = torch.zeros_like(p0)
    return torch.where(
        p3 <= 0, torch.ones_like(p0),
        torch.where(
            p2 <= 0, 1.0 - _sorted_tet_fraction(p3, p2, p1, p0),
            torch.where(
                p1 <= 0, _sorted_prism_fraction(p0, p1, p2, p3),
                torch.where(p0 <= 0, _sorted_tet_fraction(p0, p1, p2, p3),
                            zero))))


def volume_fraction_cube(
    phi000, phi100, phi010, phi110, phi001, phi101, phi011, phi111
):
    """Fraction of a cube inside phi < 0: average of the two 5-tet
    decompositions (levelsetutils.cpp:219-235)."""
    return (
        volume_fraction_tet(phi000, phi001, phi101, phi011)
        + volume_fraction_tet(phi000, phi101, phi100, phi110)
        + volume_fraction_tet(phi000, phi010, phi011, phi110)
        + volume_fraction_tet(phi101, phi011, phi111, phi110)
        + 2.0 * volume_fraction_tet(phi000, phi011, phi101, phi110)
        + volume_fraction_tet(phi100, phi101, phi001, phi111)
        + volume_fraction_tet(phi100, phi001, phi000, phi010)
        + volume_fraction_tet(phi100, phi110, phi111, phi010)
        + volume_fraction_tet(phi001, phi111, phi011, phi010)
        + 2.0 * volume_fraction_tet(phi100, phi111, phi001, phi010)
    ) / 12.0
