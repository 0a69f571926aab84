"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU (and nvcc) every test here skips
with a reason.  On a GPU machine run them with
``python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest``
(``tests/conftest.py`` imports JAX, which a GPU machine need not have);
chip_smoke.py repeats the same comparisons at the main path's full
shapes."""

import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, ba_scene, match_case, to_t

from sfm_tpu_torch import native
from sfm_tpu_torch.ba import linearize_pallas as lp
from sfm_tpu_torch.ba import schur_pallas as sp
from sfm_tpu_torch.ba.large import build_lm_tables_device
from sfm_tpu_torch.ba.residuals import Observations
from sfm_tpu_torch.features import match_pallas as mp
from sfm_tpu_torch.features import patches_pallas as pp
from sfm_tpu_torch.geometry.rotations import exp_so3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    native.library()
    return torch.device("cuda")


@pytest.mark.parametrize("B,ns,nt,centers", [
    (1, 512, 512, False), (1, 2048, 512, True), (9, 512, 512, False),
    (2, 17000, 64, False)])
def test_hamming_kernel_equals_plain(cuda, B, ns, nt, centers):
    rng = np.random.default_rng(ns + B)
    cases = [match_case(rng, ns, nt) for _ in range(B)]
    t = [to_t(np.stack([c[i] for c in cases])).to(cuda) for i in range(6)]
    if centers:
        t[1] = t[1] + 1.5
    args = (*t, 1.5 ** 2, 40.0 ** 2, 120.0, 0.9)
    n0 = native.LAUNCHES["hamming_match"]
    out = mp.hamming_match_kernel(*args)
    ref = mp.hamming_match_plain(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hamming_match"] == n0 + 1
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_hamming_kernel_reloc_shape(cuda):
    """Relocalization's windowless global match: all 8192 landmark slots
    (20% live, zero positions) against 512 keypoints, radius 1e9 (1e18
    squared in float32)."""
    rng = np.random.default_rng(8192)
    d0, _, _, d1, xy1, v1 = match_case(rng, 8192, 512)
    v0 = rng.uniform(0, 1, 8192) < 0.2
    t = [to_t(a[None]).to(cuda) for a in (d0, np.zeros((8192, 2), np.float32),
                                          v0, d1, xy1, v1)]
    args = (*t, 0.0, float(np.float32(1e9 * 1e9)), 90.0, 0.8)
    out = mp.hamming_match_kernel(*args)
    ref = mp.hamming_match_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    res = mp.match_features_pallas(*t, min_radius=0.0, max_radius=1e9,
                                   max_distance=90.0, ratio=0.8)
    assert int(res.mask.sum()) > 100


def test_patch_kernel_equals_plain(cuda):
    rng = np.random.default_rng(0)
    canvas = to_t(rng.uniform(0, 255, (480, 1200)).astype(np.float32)).to(cuda)
    cx = to_t(rng.uniform(-20, 1220, 512).astype(np.float32)).to(cuda)
    cy = to_t(rng.uniform(-20, 500, 512).astype(np.float32)).to(cuda)
    out = pp.extract_patches_kernel(canvas, cx, cy)
    ref = pp.extract_patches_plain(canvas, cx, cy)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-3


def test_wrappers_refuse_bad_input(cuda):
    canvas = torch.zeros((8, 8), device=cuda)
    cx = torch.zeros(4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        pp.extract_patches_kernel(canvas, cx, cx)
    with pytest.raises(ValueError):
        pp.extract_patches_kernel(canvas.t(), cx.float(), cx.float())


def _close(a, b):
    """Sums in another order than the plain versions' (which use
    index_add_ atomics): rtol 1e-4, atol 1e-5 of the largest entry."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-5 * max(np.abs(b).max(), 1.0))


def _f64(args):
    """The same inputs in float64 (the exact math on the f32 values)."""
    return [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in args]


def _err_to_largest(a, ref):
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def _lin_args(cuda, C, L, kmax, huber):
    rng = np.random.default_rng(C + kmax)
    _, init, obs = ba_scene(rng, C, L, min(kmax + 2, C), noise_px=0.7,
                            outlier_p=0.1, dead_p=0.1)
    o = Observations(*(to_t(a).to(cuda) for a in obs))
    o = o._replace(cam_idx=o.cam_idx.long(), lm_idx=o.lm_idx.long())
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(o, L, kmax)
    cam_free = torch.ones(C, device=cuda)
    cam_free[0] = 0.0
    lm_free = (torch.arange(L, device=cuda) % 7 != 0).float()
    R = exp_so3(to_t(init["rv"]).to(cuda)).contiguous()
    return (to_t(TEST_K).to(cuda), R, to_t(init["tv"]).to(cuda),
            to_t(init["X"]).to(cuda), lm_free, cam_free, lm_cam, lm_uv,
            lm_w, huber)


# kmax 1 / 6 / 16 / 64, and 2100 cameras (above the ~2000 that a per-block
# shared-memory camera accumulator once allowed)
@pytest.mark.parametrize("C,L,kmax", [(8, 300, 4), (20, 200, 16),
                                      (6, 120, 1), (12, 400, 6),
                                      (40, 150, 64), (2100, 3000, 6)])
def test_linearize_kernel_equals_plain(cuda, C, L, kmax):
    """Each output no farther from the plain version run in float64 (the
    witness) than twice the f32 plain version's distance, and within
    ``_close`` of the f32 plain version.  At 2100 cameras the strafe
    reaches ~2e4 pixels, where f32 keeps ~3 digits of a pixel residual:
    there both f32 results lie 5e-4 to 1.1e-3 of the largest entry from
    the witness and up to 9e-4 from each other, so ``_close`` is held for
    the cost only and the witness is the check for the rest."""
    args = _lin_args(cuda, C, L, kmax, 2.0)
    n0 = native.LAUNCHES["ba_linearize"]
    out = lp.ba_linearize_kernel(*args)
    ref = lp.ba_linearize_plain(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ba_linearize"] == n0 + 1
    ref64 = lp.ba_linearize_plain(*_f64(args))
    for name, a, b, c in zip(("W", "V", "g_lm", "U", "g_cam", "cost"), out,
                             ref, ref64):
        e_kernel, e_plain = _err_to_largest(a, c), _err_to_largest(b, c)
        print(f"K2 C={C} kmax={kmax} {name}: from f64, kernel {e_kernel:.3e}"
              f", f32 plain {e_plain:.3e}; kernel from f32 plain "
              f"{_err_to_largest(a, b):.3e}")
        assert e_kernel <= 2 * e_plain + 1e-6, name
        if C <= 1000 or name == "cost":
            _close(a, b)
    assert float(ref[-1]) > 0


def _schur_args(cuda, C, L, kmax, idle=(), dead_rows=0.0, seed=None):
    """A random coupling: 30% empty slots (zero W, camera 0), the cameras
    in ``idle`` observed by no slot, a share of all-empty landmark rows."""
    rng = np.random.default_rng(kmax if seed is None else seed)
    busy = np.setdiff1d(np.arange(C), idle)
    lm_cam = rng.choice(busy, (L, kmax)).astype(np.int32)
    W = rng.normal(0, 1, (L, kmax, 6, 3)).astype(np.float32)
    empty = rng.random((L, kmax)) < 0.3
    empty[rng.random(L) < dead_rows] = True
    W[empty] = 0.0
    lm_cam[empty] = 0 if 0 not in idle else busy[0]
    Vs = rng.normal(0, 1, (L, 3, 3)).astype(np.float32)
    Vinv = np.einsum("lab,lcb->lac", Vs, Vs) + np.eye(3, dtype=np.float32)
    x = rng.normal(0, 1, (C, 6)).astype(np.float32)
    g = rng.normal(0, 1, (L, 3)).astype(np.float32)
    return [to_t(a).to(cuda) for a in (lm_cam, W, Vinv, x, g)]


def _all_modes(lm_cam, W, Vinv, x, g, C):
    """Every mode (and x / g left out) on the kernel and the plain
    version: a list of (kernel, plain) output pairs."""
    return [
        (sp.schur_kernel("full", lm_cam, W, Vinv, g, x),
         sp.schur_apply_fused_plain(lm_cam, W, Vinv, g, x, C)),
        ((sp.schur_kernel("full", lm_cam, W, Vinv, g, None, n_cams=C)[1],),
         (sp.schur_apply_fused_plain(lm_cam, W, Vinv, g, None, C)[1],)),
        ((sp.schur_kernel("gather", lm_cam, W, Vinv, g, x),),
         (sp.schur_gather_plain(lm_cam, W, Vinv, g, x),)),
        ((sp.schur_kernel("gather", lm_cam, W, Vinv, g, None),),
         (sp.schur_gather_plain(lm_cam, W, Vinv, g, None),)),
        ((sp.schur_kernel("scatter", lm_cam, W, z=g, n_cams=C),),
         (sp.schur_scatter_plain(lm_cam, W, g, C),))]


# kmax 1 / 3 / 6 / 16 / 64, and 5000 cameras in the full mode (above the
# ~4800 that per-block shared-memory camera vectors once allowed)
@pytest.mark.parametrize("C,L,kmax", [(7, 300, 3), (20, 200, 16),
                                      (5, 200, 1), (30, 500, 6),
                                      (9, 100, 64), (5000, 4000, 6)])
def test_schur_kernel_modes_equal_plain(cuda, C, L, kmax):
    lm_cam, W, Vinv, x, g = _schur_args(cuda, C, L, kmax)
    n0 = native.LAUNCHES["schur_apply"]
    for out, ref in _all_modes(lm_cam, W, Vinv, x, g, C):
        for a, b in zip(out, ref):
            _close(a, b)
    torch.cuda.synchronize()
    assert native.LAUNCHES["schur_apply"] == n0 + 2


def test_ba_kernels_on_empty_tables_and_idle_cameras(cuda):
    """An all-empty table gives zero W, U, g_cam, y and cost; cameras that
    no slot observes get zero rows; a table with empty landmark rows (as
    compaction leaves it) equals the plain versions."""
    args = list(_lin_args(cuda, 10, 200, 6, 2.0))
    args[8] = torch.zeros_like(args[8])
    out = lp.ba_linearize_kernel(*args)
    for a, b in zip(out, lp.ba_linearize_plain(*args)):
        _close(a, b)
        assert not a.any()
    lm_cam, W, Vinv, x, g = _schur_args(cuda, 12, 300, 8, idle=(0, 5, 11),
                                        dead_rows=0.5)
    for out, ref in _all_modes(lm_cam, W, Vinv, x, g, 12):
        for a, b in zip(out, ref):
            _close(a, b)
    y = sp.schur_kernel("full", lm_cam, W, Vinv, g, x)[1]
    assert not y[[0, 5, 11]].any() and y[[1, 2]].abs().sum() > 0
    W0 = torch.zeros_like(W)
    z, y = sp.schur_kernel("full", lm_cam, W0, Vinv, g, x)
    _close(z, sp.schur_gather_plain(lm_cam, W0, Vinv, g, x))
    assert not y.any()


def test_ba_kernels_are_bit_identical_across_launches(cuda):
    """No atomics: every camera-side sum runs in a fixed order."""
    args = _lin_args(cuda, 30, 2000, 8, 2.0)
    a, b = lp.ba_linearize_kernel(*args), lp.ba_linearize_kernel(*args)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    lm_cam, W, Vinv, x, g = _schur_args(cuda, 30, 2000, 8)
    for mode, kw in (("full", dict(Vinv=Vinv, g=g, x=x)),
                     ("gather", dict(Vinv=Vinv, g=g, x=x)),
                     ("scatter", dict(z=g, n_cams=30))):
        u = sp.schur_kernel(mode, lm_cam, W, **kw)
        v = sp.schur_kernel(mode, lm_cam, W, **kw)
        for p, q in zip(u if mode == "full" else (u,),
                        v if mode == "full" else (v,)):
            assert torch.equal(p, q), mode


def test_ba_wrappers_refuse_bad_input(cuda):
    args = list(_lin_args(cuda, 8, 100, 4, 0.0))
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(TypeError):
        lp.ba_linearize_kernel(*bad)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()
    with pytest.raises(ValueError):
        lp.ba_linearize_kernel(*bad)
    L, kmax = 50, 4
    lm_cam = torch.zeros((L, kmax), dtype=torch.int32, device=cuda)
    W = torch.zeros((L, kmax, 6, 3), device=cuda)
    Vinv = torch.eye(3, device=cuda).expand(L, 3, 3).contiguous()
    x = torch.zeros((8, 6), device=cuda)
    with pytest.raises(TypeError):
        sp.schur_kernel("full", lm_cam.long(), W, Vinv, None, x)
    with pytest.raises(ValueError):
        sp.schur_kernel("gather", lm_cam, W.transpose(2, 3).contiguous()
                        .transpose(2, 3), Vinv, None, x)
    with pytest.raises(ValueError, match="kmax"):
        sp.schur_kernel("full", torch.zeros((L, 300), dtype=torch.int32,
                                            device=cuda),
                        torch.zeros((L, 300, 6, 3), device=cuda), Vinv, None,
                        x)
