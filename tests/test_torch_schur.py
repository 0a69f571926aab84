"""K3's plain versions (``sfm_tpu_torch.ba.schur_pallas``: the full apply
and the gather / scatter modes) against the JAX package's Pallas kernels
``schur_apply_fused``, ``schur_gather`` and ``schur_scatter`` (interpret
mode, tile 16, the f32-exact "highest" precision), and the port's
``SchurOperator`` against the JAX one, at kmax 3 and 16."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import to_np, to_t

from sfm_tpu.ba import schur_pallas as jsp
from sfm_tpu_torch.ba import schur_pallas as sp

CASES = {"kmax3": (7, 41, 3), "kmax16": (20, 30, 16)}
PREC = "highest"


def _problem(name):
    C, L, kmax = CASES[name]
    rng = np.random.default_rng(kmax)
    lm_cam = rng.integers(0, C, (L, kmax)).astype(np.int32)
    W = rng.normal(0, 1, (L, kmax, 6, 3)).astype(np.float32)
    dead = rng.random((L, kmax)) < 0.3
    W[dead] = 0.0          # empty slots carry zero blocks
    lm_cam[dead] = 0
    Vs = rng.normal(0, 1, (L, 3, 3)).astype(np.float32)
    Vinv = np.einsum("lab,lcb->lac", Vs, Vs) + np.eye(3, dtype=np.float32)
    x = rng.normal(0, 1, (C, 6)).astype(np.float32)
    g = rng.normal(0, 1, (L, 3)).astype(np.float32)
    op = jsp.SchurOperator(jnp.asarray(W), jnp.asarray(lm_cam), tile=16,
                           precision=PREC, interpret=True)
    op.set_vinv(jnp.asarray(Vinv))
    Cp = 128
    return dict(lm_cam=lm_cam, W=W, Vinv=Vinv, x=x, g=g, op=op, C=C, L=L,
                kmax=kmax, Cp=Cp, g_t=jsp.pack_lm_tiles(jnp.asarray(g), 16,
                                                        pad_rows=8),
                x_pad=jnp.pad(jnp.asarray(x), ((0, Cp - C), (0, 2))).T)


def _close(a, b):
    """f32 sums in another order: rtol 1e-5, atol 1e-5 of the largest."""
    a, b = to_np(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=1e-5 * max(np.abs(b).max(), 1.0))


def _t(p, *keys):
    return [to_t(p[k]) for k in keys]


@pytest.mark.parametrize("name", list(CASES))
def test_full_apply_matches_pallas(name):
    p = _problem(name)
    op = p["op"]
    z_t, y = jsp.schur_apply_fused(
        op.base_t, op.cams_t, op.wt, op.vinv_t, p["g_t"], p["x_pad"],
        kmax=p["kmax"], window=p["Cp"], pad_width=p["Cp"], precision=PREC,
        interpret=True)
    z, y_t = sp.schur_apply_fused(*_t(p, "lm_cam", "W", "Vinv", "g", "x"))
    _close(z, jsp.unpack_lm_tiles(z_t, p["L"], 3))
    _close(y_t, np.asarray(y).T[:p["C"], :6])


@pytest.mark.parametrize("name", list(CASES))
def test_gather_matches_pallas(name):
    p = _problem(name)
    op = p["op"]
    z_t = jsp.schur_gather(op.cams_t, op.wt, op.vinv_t, p["g_t"], p["x_pad"],
                           kmax=p["kmax"], precision=PREC, interpret=True)
    z = sp.schur_gather(*_t(p, "lm_cam", "W", "Vinv", "g", "x"))
    _close(z, jsp.unpack_lm_tiles(z_t, p["L"], 3))


@pytest.mark.parametrize("name", list(CASES))
def test_scatter_matches_pallas(name):
    p = _problem(name)
    op = p["op"]
    z = p["g"]   # any [L, 3] vector
    y = jsp.schur_scatter(op.cams_t, op.wt,
                          jsp.pack_lm_tiles(jnp.asarray(z), 16, pad_rows=8),
                          kmax=p["kmax"], n_cams_pad=p["Cp"], precision=PREC,
                          interpret=True)
    y_t = sp.schur_scatter(*_t(p, "lm_cam", "W"), to_t(z), p["C"])
    _close(y_t, np.asarray(y).T[:p["C"], :6])


@pytest.mark.parametrize("name", list(CASES))
def test_schur_operator_matches_jax(name):
    p = _problem(name)
    op_j = p["op"]
    op_t = sp.SchurOperator(*_t(p, "W", "lm_cam", "Vinv"))
    x, g = p["x"], p["g"]
    _close(op_t.w_vinv_wt_x(to_t(x)), op_j.w_vinv_wt_x(jnp.asarray(x)))
    _close(op_t.w_vinv_g(to_t(g), p["C"]),
           op_j.w_vinv_g(jnp.asarray(g), p["C"]))
    _close(op_t.back_substitute(to_t(g), to_t(x)),
           op_j.back_substitute(jnp.asarray(g), jnp.asarray(x)))


def test_modes_compose():
    """full == (gather, scatter of the gathered z), and None reads as 0."""
    p = _problem("kmax3")
    lm_cam, W, Vinv, g, x = _t(p, "lm_cam", "W", "Vinv", "g", "x")
    z, y = sp.schur_apply_fused(lm_cam, W, Vinv, g, x)
    assert (z == sp.schur_gather(lm_cam, W, Vinv, g, x)).all()
    assert (y == sp.schur_scatter(lm_cam, W, z, p["C"])).all()
    z0, y0 = sp.schur_apply_fused(lm_cam, W, Vinv, None, x)
    _close(z0, sp.schur_gather(lm_cam, W, Vinv, g * 0, x))
    _, y1 = sp.schur_apply_fused(lm_cam, W, Vinv, g, None, n_cams=p["C"])
    _close(y1, sp.schur_apply_fused(lm_cam, W, Vinv, g, x * 0)[1])
