"""K1's cells route never leaves out a feasible pair: a property search
over window centres, radii and target offsets (hypothesis) against the
float64 mirror of the kernel's cell rule in
``sfm_tpu_torch.features.match_pallas``.  The exact boundary pairs are in
tests/test_torch_match.py."""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402
from torch_port_util import cells_visit, f32_d2  # noqa: E402

from sfm_tpu_torch.features import match_pallas as mp  # noqa: E402

# centres anywhere, and on multiples of a small cell side, where a window
# edge meets a cell edge
_coord = st.one_of(st.floats(-1e7, 1e7, allow_nan=False, width=32),
                   st.integers(-4000, 4000).map(lambda k: float(k) / 4))


@settings(max_examples=400, deadline=None, database=None)
@given(cx=_coord, cy=_coord, radius=st.floats(2.0 ** -10, 64.0, width=32),
       angle=st.one_of(st.sampled_from([0.0, np.pi / 2, np.pi,
                                         1.5 * np.pi]),
                       st.floats(0.0, 6.3)),
       scale=st.floats(0.0, 1.0),
       ulps=st.integers(-3, 3))
def test_cells_visit_every_feasible_pair(cx, cy, radius, angle, scale, ulps):
    """No pair whose f32 d2 passes the window lies outside the cells the
    source visits: targets at and around the window's edge, at any
    coordinate magnitude, nudged by a few ulps."""
    max_r2 = mp._f32(radius * radius)
    r = radius * (0.999 + 0.002 * scale)
    tx = np.float32(cx + r * np.cos(angle))
    ty = np.float32(cy + r * np.sin(angle))
    for _ in range(abs(ulps)):
        tx = np.nextafter(tx, np.float32(np.inf if ulps > 0 else -np.inf),
                          dtype=np.float32)
    if f32_d2((cx, cy), (tx, ty)) <= max_r2:
        assert cells_visit((cx, cy), (tx, ty), max_r2)
