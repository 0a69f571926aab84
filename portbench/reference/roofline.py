"""The yardstick of the kernel metrics: the card's published peaks and the
least time a call could take.  ``bound``, ``nbytes`` and ``ba_bound`` are
frozen copies of ``chip_smoke.py``'s, as of commit
a3f7eac09f6ff61dad4da7d0b34d6b34dca73db2; ``ba_bound`` takes the table's
shape and its live slots as numbers, where the original counted them from
the tensors.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the card's full power
limit of 700 W (a card set lower runs slower under load: every result line
names the card's ``power.limit`` beside them)."""

from __future__ import annotations

# device memory bytes per second
HBM_BYTES_PER_S = 3.35e12
# f32 operations per second outside the tensor cores; every kernel's
# operations, integer ones included, are held to it, so a bound set by
# operations is a floor
CORE_OPS_PER_S = 67e12
PEAK_POWER_W = 700.0


def bound(nbytes, ops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops), bytes=nbytes, ops=ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def ba_bound(name, L, kmax, live, C):
    """The bound of a BA kernel call on a landmark-major table of L rows
    and kmax slots, ``live`` of them with a nonzero weight, and C cameras:
    its inputs read and outputs written once (f32 / int32; K3 with g and x
    given), and its flops on the live slots (K2 ~300 per slot; K3 36 per
    slot and half of the full mode, 18 per landmark for Vinv t)."""
    slots = L * kmax
    if name == "ba_linearize":
        # K, R, t, cam_free; xyz, lm_free; lm_cam, uv, w | W; V, g_lm;
        # U, g_cam; cost
        io = 36 + C * 52 + L * 16 + slots * 16 + slots * 72 + L * 48 \
            + C * 168 + 4
        return bound(io, 300 * live)
    table = slots * (4 + 72)          # lm_cam and W
    io = {"schur_apply": table + L * (36 + 12 + 12) + C * 48,
          "schur_gather": table + L * (36 + 12 + 12) + C * 24,
          "schur_scatter": table + L * 12 + C * 24}[name]
    ops = {"schur_apply": 72 * live + 18 * L, "schur_gather": 36 * live
           + 18 * L, "schur_scatter": 36 * live}[name]
    return bound(io, ops)
