"""Branch-free closed-form polynomial roots (cubic and quartic), for the
Grunert P3P solver (``geometry/pnp.py::p3p``).

Everything is elementwise over any leading shape: one call solves a whole
batch of RANSAC samples, and ``torch.where`` evaluates both sides of each
branch as ``jnp.where`` does in the JAX package."""

from __future__ import annotations

import torch


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def real_cubic_root(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d (trigonometric method for
    three real roots, Cardano for one)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    # three real roots (discriminant <= 0): Viete
    p_ = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-p_ / 3.0)
    acos_arg = torch.clamp(3.0 * q / (p_ * m), -1.0, 1.0)
    theta = torch.arccos(acos_arg) / 3.0
    root_tri = m * torch.cos(theta) - b / 3.0
    # one real root (discriminant > 0): Cardano
    disc = q * q / 4.0 + p ** 3 / 27.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_car = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq) - b / 3.0
    return torch.where(disc > 0, root_car, root_tri)


def quartic_roots(A4, A3, A2, A1, A0):
    """Real roots of A4 x^4 + A3 x^3 + A2 x^2 + A1 x + A0 (Ferrari).
    Returns (roots [..., 4], valid [..., 4]); invalid slots hold 0.  The
    roots are Newton-polished twice on the original quartic."""
    A4s = torch.where(torch.abs(A4) < 1e-12,
                      torch.sign(A4) * 1e-12 + 1e-12, A4)
    p = A3 / A4s
    q = A2 / A4s
    r = A1 / A4s
    s = A0 / A4s
    al = q - 3.0 * p * p / 8.0
    be = r - p * q / 2.0 + p ** 3 / 8.0
    ga = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p ** 4 / 256.0
    # resolvent cubic 8m^3 + 8 al m^2 + (2 al^2 - 8 ga) m - be^2 = 0
    m = real_cubic_root(al, al * al / 4.0 - ga, -be * be / 8.0)
    m = torch.clamp(m, min=1e-12)
    w = torch.sqrt(2.0 * m)
    # y^2 + w y + (al/2 + m - be/(2w)) = 0 ; y^2 - w y + (al/2 + m + be/(2w))
    c1 = al / 2.0 + m - be / (2.0 * w)
    c2 = al / 2.0 + m + be / (2.0 * w)
    d1 = w * w - 4.0 * c1
    d2 = w * w - 4.0 * c2
    s1 = torch.sqrt(torch.clamp(d1, min=0.0))
    s2 = torch.sqrt(torch.clamp(d2, min=0.0))
    ys = torch.stack([(-w + s1) / 2.0, (-w - s1) / 2.0,
                      (w + s2) / 2.0, (w - s2) / 2.0], dim=-1)
    valid = torch.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], dim=-1)
    roots = ys - p[..., None] / 4.0
    a4, a3, a2, a1, a0 = (x[..., None] for x in (A4, A3, A2, A1, A0))
    for _ in range(2):
        f = (((a4 * roots + a3) * roots + a2) * roots + a1) * roots + a0
        fp = ((4 * a4 * roots + 3 * a3) * roots + 2 * a2) * roots + a1
        roots = roots - f / torch.where(torch.abs(fp) < 1e-9, 1e-9, fp)
    return torch.where(valid, roots, 0.0), valid
