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
    """Sums in another order, U / g_cam / cost / y with shared-memory
    atomics: rtol 1e-4, atol 1e-5 of the largest entry."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-5 * max(np.abs(b).max(), 1.0))


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


@pytest.mark.parametrize("C,L,kmax", [(8, 300, 4), (20, 200, 16)])
def test_linearize_kernel_equals_plain(cuda, C, L, kmax):
    args = _lin_args(cuda, C, L, kmax, 2.0)
    n0 = native.LAUNCHES["ba_linearize"]
    out = lp.ba_linearize_kernel(*args)
    ref = lp.ba_linearize_plain(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ba_linearize"] == n0 + 1
    for a, b in zip(out, ref):
        _close(a, b)
    assert float(ref[-1]) > 0


@pytest.mark.parametrize("C,L,kmax", [(7, 300, 3), (20, 200, 16)])
def test_schur_kernel_modes_equal_plain(cuda, C, L, kmax):
    rng = np.random.default_rng(kmax)
    lm_cam = rng.integers(0, C, (L, kmax)).astype(np.int32)
    W = rng.normal(0, 1, (L, kmax, 6, 3)).astype(np.float32)
    W[rng.random((L, kmax)) < 0.3] = 0.0
    Vs = rng.normal(0, 1, (L, 3, 3)).astype(np.float32)
    Vinv = np.einsum("lab,lcb->lac", Vs, Vs) + np.eye(3, dtype=np.float32)
    x = rng.normal(0, 1, (C, 6)).astype(np.float32)
    g = rng.normal(0, 1, (L, 3)).astype(np.float32)
    lm_cam, W, Vinv, x, g = (to_t(a).to(cuda) for a in (lm_cam, W, Vinv, x,
                                                         g))
    z, y = sp.schur_kernel("full", lm_cam, W, Vinv, g, x)
    z_p, y_p = sp.schur_apply_fused_plain(lm_cam, W, Vinv, g, x, C)
    _close(z, z_p)
    _close(y, y_p)
    _close(sp.schur_kernel("gather", lm_cam, W, Vinv, g, x),
           sp.schur_gather_plain(lm_cam, W, Vinv, g, x))
    _close(sp.schur_kernel("gather", lm_cam, W, Vinv, g, None),
           sp.schur_gather_plain(lm_cam, W, Vinv, g, None))
    _close(sp.schur_kernel("scatter", lm_cam, W, z=g, n_cams=C),
           sp.schur_scatter_plain(lm_cam, W, g, C))
    _, y0 = sp.schur_kernel("full", lm_cam, W, Vinv, g, None, n_cams=C)
    _close(y0, sp.schur_apply_fused_plain(lm_cam, W, Vinv, g, None, C)[1])
    torch.cuda.synchronize()


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
    big = 2100   # C * 112 B of shared memory > 227 KB
    bad = list(args)
    bad[1] = args[1][:1].expand(big, 3, 3).contiguous()
    bad[2] = args[2][:1].expand(big, 3).contiguous()
    bad[5] = torch.ones(big, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
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
    with pytest.raises(ValueError, match="shared memory"):
        sp.schur_kernel("full", lm_cam, W, Vinv, None,
                        torch.zeros((5000, 6), device=cuda))
