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

from torch_port_util import (TEST_K, ba_scene, chip_smoke, far_ba_problem,
                             gradient_distances, match_case, noisy_copies,
                             rand_desc, to_t)

from sfm_tpu_torch import mapstore as ms
from sfm_tpu_torch import native
from sfm_tpu_torch.ba import linearize_pallas as lp
from sfm_tpu_torch.ba import schur_pallas as sp
from sfm_tpu_torch.ba.large import build_lm_tables_device
from sfm_tpu_torch.ba.residuals import Observations
from sfm_tpu_torch.features import match_pallas as mp
from sfm_tpu_torch.features import patches_pallas as pp
from sfm_tpu_torch.geometry.rotations import exp_so3
from sfm_tpu_torch.utils.profiling import RECORDER

pytestmark = pytest.mark.cuda

# chip_smoke.py: the kernel cases of its "sanitize" phase
# (``--sanitize-target``) and its BA problems
SMOKE = chip_smoke()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    native.library()
    return torch.device("cuda")


# (B, Ns, Nt, window centres, min_r, max_r, share of valid sources): the
# main path's five shapes (tracking, widen_tracks, triangulation,
# re-observation, relocalization's windowless match), then a batch past
# 16384 sources, Nt = 1 and an Nt that is no tile multiple
K1_SHAPES = {
    "tracking": (1, 512, 512, False, 1.5, 40.0, 0.9),
    "widen": (1, 2048, 512, True, 0.0, 7.0, 0.9),
    "triangulation": (9, 512, 512, False, 1.5, 120.0, 0.9),
    "reobservation": (16, 2048, 512, True, 0.0, 7.0, 0.9),
    "reloc": (1, 8192, 512, False, 0.0, 1e9, 0.2),
    "17000x64": (2, 17000, 64, False, 0.0, 20.0, 0.9),
    "nt1": (3, 300, 1, False, 0.0, 40.0, 0.9),
    "nt77": (2, 300, 77, True, 0.0, 40.0, 0.9),
}


def _k1_args(cuda, B, ns, nt, centers, rmin, rmax, live, seed=0):
    rng = np.random.default_rng(seed + ns + B)
    cases = [match_case(rng, ns, nt, extent=640.0) for _ in range(B)]
    t = [to_t(np.stack([c[i] for c in cases])).to(cuda) for i in range(6)]
    if centers:
        t[1] = t[1] + 1.5
    t[2] = t[2] & to_t(rng.uniform(0, 1, (B, ns)) < live).to(cuda)
    f = mp._f32
    return (*t, f(rmin * rmin), f(rmax * rmax), 90.0, 0.8)


_K1_OUTPUTS = ("idx", "best", "second", "keys", "res_idx", "res_dist",
               "res_mask")


def _same_as_plain(args, ref):
    """The kernel's raw outputs and MatchResult against ``ref`` (the plain
    versions' outputs, broadcast over the batch axis); one launch counted
    per call.  Returns the route the call's shape selected."""
    n0 = native.LAUNCHES["hamming_match"]
    out = mp.hamming_match_kernel(*args) + mp.match_result_kernel(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hamming_match"] == n0 + 2
    route = mp.k1_route(args[7], *args[0].shape[:2], args[3].shape[1])
    for name, a, b in zip(_K1_OUTPUTS, out, ref):
        assert torch.equal(a, b.expand_as(a)), (route, name)
    return route


def _k1_equal(args, n_match_min=0):
    """The raw outputs and MatchResult equal the plain versions' bit for
    bit through the route the call's shape selects.  Where the window
    admits the cells route, also through both routes by shape: each batch
    element alone (too few pairs: the dense route) and repeated with batch
    stride 0 past ``CELLS_MIN_PAIRS`` pairs (the cells route), against the
    plain outputs of that element.  Returns the routes checked."""
    ref = mp.hamming_match_plain(*args) + mp.match_result_plain(*args)
    assert int(ref[6].sum()) >= n_match_min
    routes = {_same_as_plain(args, ref)}
    B, ns = args[0].shape[:2]
    nt = args[3].shape[1]
    if args[7] <= mp.WINDOW_MAX_RADIUS ** 2 and nt <= mp.MAX_SMEM_TARGETS:
        rep = mp.CELLS_MIN_PAIRS // (ns * nt) + 1
        for b in range(B):
            one = [t[b:b + 1] for t in args[:6]]
            ref_b = [r[b:b + 1] for r in ref]
            routes.add(_same_as_plain((*one, *args[6:]), ref_b))
            routes.add(_same_as_plain(
                (*(t.expand(rep, *t.shape[1:]) for t in one), *args[6:]),
                ref_b))
        assert routes == {"cells", "dense_int"}
    return routes


@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_hamming_kernel_equals_plain(cuda, shape):
    _k1_equal(_k1_args(cuda, *K1_SHAPES[shape]), n_match_min=1)


def test_hamming_kernel_reloc_shape(cuda):
    """Relocalization's windowless global match: all 8192 landmark slots
    (20% live, zero positions) against 512 keypoints, radius 1e9 (1e18
    squared in float32)."""
    rng = np.random.default_rng(8192)
    d0, _, _, d1, xy1, v1 = match_case(rng, 8192, 512)
    v0 = rng.uniform(0, 1, 8192) < 0.2
    t = [to_t(a[None]).to(cuda) for a in (d0, np.zeros((8192, 2), np.float32),
                                          v0, d1, xy1, v1)]
    _k1_equal((*t, 0.0, float(np.float32(1e9 * 1e9)), 90.0, 0.8))
    res = mp.match_features_pallas(*t, min_radius=0.0, max_radius=1e9,
                                   max_distance=90.0, ratio=0.8)
    assert int(res.mask.sum()) > 100


@pytest.mark.parametrize("targets", ["unlinked", "linked"])
def test_hamming_kernel_loop_probe_shape(cuda, targets):
    """The loop probe's two windowless matches (engine/loop.py): all 65536
    landmark slots of the RING preset (20% valid, the old ones; zero
    positions) against the keyframe's 512 keypoints, radius 1e9, the
    targets masked to its unlinked or its linked keypoints."""
    rng = np.random.default_rng(65536)
    d0, _, _, d1, xy1, v1 = match_case(rng, 65536, 512)
    v0 = rng.uniform(0, 1, 65536) < 0.2
    linked = rng.uniform(0, 1, 512) < 0.6
    v1 = v1 & (linked if targets == "linked" else ~linked)
    t = [to_t(a[None]).to(cuda) for a in (
        d0, np.zeros((65536, 2), np.float32), v0, d1, xy1, v1)]
    _k1_equal((*t, 0.0, float(np.float32(1e9 * 1e9)), 90.0, 0.8))
    res = mp.match_features_pallas(*t, min_radius=0.0, max_radius=1e9,
                                   max_distance=90.0, ratio=0.8)
    assert int(res.mask.sum()) > 50
    assert not bool((res.mask & ~t[2]).any())


def test_hamming_kernel_window_edges(cuda):
    """Pairs exactly on d2 == max_r2 and on d2 == min_r2 in f32
    (Pythagorean offsets from centres at several magnitudes), and targets
    on exact multiples of the cells route's cell side and one ulp either
    side, with sources at the window radius from them."""
    rng = np.random.default_rng(11)
    r = 5.0
    offs = np.array([(3, 4), (-4, 3), (5, 0), (0, -5), (4, -3), (-3, -4)],
                    np.float32)
    base = np.array([(0.0, 0.0), (1000.25, 17.5), (-333.5, 640.0),
                     (65536.0, 3.0)], np.float32)
    src = np.repeat(base, len(offs), 0)
    tgt = (src + np.tile(offs, (len(base), 1))).astype(np.float32)
    reach, _ = mp.window_geometry(mp._f32(r * r))
    edge = np.float32(np.arange(-3, 40) * reach)
    edges = np.concatenate([np.nextafter(edge, np.float32(-1e9)), edge,
                            np.nextafter(edge, np.float32(1e9))])
    tgt = np.concatenate([tgt, np.stack([edges, np.zeros_like(edges)], 1)])
    src = np.concatenate([src, np.stack([edges + np.float32(r),
                                         np.zeros_like(edges)], 1)])
    src = src.astype(np.float32)
    ns, nt = len(src), len(tgt)
    d1 = rand_desc(rng, nt)
    pick = rng.integers(0, nt, ns)
    d0 = noisy_copies(rng, d1, pick, flip_p=0.02)
    t = [to_t(a[None]).to(cuda) for a in (d0, src, np.ones(ns, bool), d1,
                                          tgt.astype(np.float32),
                                          np.ones(nt, bool))]
    r2 = mp._f32(r * r)
    for min_r2, max_r2 in ((0.0, r2), (r2, mp._f32(6.0 ** 2))):
        args = (*t, min_r2, max_r2, 512.0, 1.01)
        d2 = ((t[1][0, :, None, :] - t[4][0, None, :, :]) ** 2).sum(-1)
        assert int((d2 == r2).sum()) > 20
        _k1_equal(args)


def test_hamming_kernel_all_invalid_and_infeasible(cuda):
    """No valid source, no valid target, or no target inside any window:
    every row is (idx 0, 1e9, 1e9), no key, no match."""
    rng = np.random.default_rng(12)
    d0, xy0, v0, d1, xy1, v1 = match_case(rng, 700, 300)
    far = (xy1 + 5000.0).astype(np.float32)
    for variant in ((d0, xy0, ~np.ones_like(v0), d1, xy1, v1),
                    (d0, xy0, v0, d1, xy1, ~np.ones_like(v1)),
                    (d0, xy0, v0, d1, far, v1)):
        t = [to_t(a[None]).to(cuda) for a in variant]
        for max_r in (7.0, 120.0):
            args = (*t, 0.0, mp._f32(max_r * max_r), 90.0, 0.8)
            _k1_equal(args)
            idx, best, second, keys = mp.hamming_match_kernel(*args)
            assert not idx.any() and (best == 1e9).all()
            assert (second == 1e9).all()
            assert (keys == torch.iinfo(torch.int64).max).all()


@pytest.mark.parametrize("which", ["targets", "sources"])
def test_hamming_kernel_stride0_operands(cuda, which):
    """Triangulation's expanded targets (x9) and re-observation's expanded
    sources (x16) go in with batch stride 0 and equal the copied
    operands' results."""
    rng = np.random.default_rng(13)
    B = 9 if which == "targets" else 16
    one = [to_t(a).to(cuda) for a in match_case(rng, 512, 512, extent=640.)]
    other = [to_t(np.stack([c[i] for c in (match_case(rng, 512, 512,
                                                      extent=640.)
                                           for _ in range(B))])).to(cuda)
             for i in range(6)]
    if which == "targets":
        t = other[:3] + [a[None].expand(B, *a.shape) for a in one[3:]]
    else:
        t = [a[None].expand(B, *a.shape) for a in one[:3]] + other[3:]
    assert t[3 if which == "targets" else 0].stride(0) == 0
    for max_r in (7.0, 120.0):
        args = (*t, 0.0, mp._f32(max_r * max_r), 90.0, 0.8)
        _k1_equal(args)
        copied = (*[a.contiguous() for a in t], *args[6:])
        for a, b in zip(mp.match_result_kernel(*args),
                        mp.match_result_kernel(*copied)):
            assert torch.equal(a, b)


def test_match_call_device_ops(cuda):
    """A match_features_pallas call on the card runs at most three device
    operations (the key table's initialisation, the match pass, the
    epilogue), with expanded operands too."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(14)
    one = [to_t(a).to(cuda) for a in match_case(rng, 512, 512, extent=640.)]
    calls = {
        "tracking": lambda: mp.match_features_pallas(
            *one, min_radius=1.5, max_radius=40.0),
        "triangulation": lambda: mp.match_features_pallas(
            *[a[None].expand(9, *a.shape) for a in one],
            min_radius=1.5, max_radius=120.0),
        "reloc": lambda: mp.match_features_pallas(*one, max_radius=1e9)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if (getattr(e, "self_device_time_total", 0)
                    or getattr(e, "self_cuda_time_total", 0)) > 0)
        assert 0 < n <= 3 * 5, (name, n)


# (Hc, Wc): the flagship canvas (480 x 1200, rows 16-byte aligned), a
# width that is no multiple of 4 (canvas_layout's 642 + 321 + 160 + 80),
# and a canvas smaller than a window
K5_CANVASES = [(480, 1200), (240, 1203), (20, 25)]


@pytest.mark.parametrize("hc,wc", K5_CANVASES)
def test_patch_kernel_equals_plain(cuda, hc, wc):
    """Bit for bit, with windows straddling every canvas edge and corner,
    windows entirely off the canvas, and keypoints anywhere."""
    rng = np.random.default_rng(hc + wc)
    canvas = to_t(rng.uniform(0, 255, (hc, wc)).astype(np.float32)).to(cuda)
    cx = rng.uniform(-40, wc + 40, 512)
    cy = rng.uniform(-40, hc + 40, 512)
    edge_x = np.array([0, wc - 1, 0, wc - 1, -17, wc + 16, -60, wc / 2])
    edge_y = np.array([0, 0, hc - 1, hc - 1, hc / 2, hc / 2, -60, hc + 60])
    cx = np.concatenate([edge_x + rng.uniform(0, 1, 8), cx])
    cy = np.concatenate([edge_y + rng.uniform(0, 1, 8), cy])
    cx, cy = (to_t(a.astype(np.float32)).to(cuda) for a in (cx, cy))
    n0 = native.LAUNCHES["patch_sampler"]
    for n in (len(cx), 1, 0):
        out = pp.extract_patches_kernel(canvas, cx[:n], cy[:n])
        ref = pp.extract_patches_plain(canvas, cx[:n], cy[:n])
        torch.cuda.synchronize()
        assert out.shape == (n, pp.PATCH, pp.PATCH)
        assert torch.equal(out, ref)
    # N == 0 launches nothing
    assert native.LAUNCHES["patch_sampler"] == n0 + 2


@pytest.mark.parametrize("hc,wc", K5_CANVASES)
def test_batched_patch_kernel_equals_plain_and_single_calls(cuda, hc, wc):
    """A batch of canvases in one launch, bit for bit against the batched
    plain version and against one call per canvas, with windows leaving
    each canvas on every side (taps there read 0, not the next canvas)."""
    B, n = 5, 300
    rng = np.random.default_rng(hc * wc)
    canvas = to_t(rng.uniform(0, 255, (B, hc, wc)).astype(np.float32)).to(
        cuda)
    cx = rng.uniform(-40, wc + 40, (B, n))
    cy = rng.uniform(-40, hc + 40, (B, n))
    cx[:, :6] = [-17.5, wc + 16.25, wc / 2, wc / 2, -60, wc + 60]
    cy[:, :6] = [hc / 2, hc / 2, -12.5, hc + 5.75, -60, hc + 60]
    cx, cy = (to_t(a.astype(np.float32)).to(cuda) for a in (cx, cy))
    n0 = native.LAUNCHES["patch_sampler"]
    out = pp.extract_patches_kernel(canvas, cx, cy)
    assert native.LAUNCHES["patch_sampler"] == n0 + 1
    torch.cuda.synchronize()
    assert out.shape == (B, n, pp.PATCH, pp.PATCH)
    assert torch.equal(out, pp.extract_patches_plain(canvas, cx, cy))
    for b in range(B):
        assert torch.equal(out[b], pp.extract_patches_kernel(canvas[b], cx[b],
                                                             cy[b]))


def test_batched_patch_kernel_at_the_fleet_shape(cuda):
    """64 canvases of the flagship's 480 x 1200 with 512 keypoints each."""
    rng = np.random.default_rng(64)
    canvas = to_t(rng.uniform(0, 255, (64, 480, 1200)).astype(
        np.float32)).to(cuda)
    cx = to_t(rng.uniform(-20, 1220, (64, 512)).astype(np.float32)).to(cuda)
    cy = to_t(rng.uniform(-20, 500, (64, 512)).astype(np.float32)).to(cuda)
    out = pp.extract_patches_kernel(canvas, cx, cy)
    torch.cuda.synchronize()
    assert torch.equal(out, pp.extract_patches_plain(canvas, cx, cy))


@pytest.mark.parametrize("shape", [
    (64, 512, 512, False, 1.5, 40.0, 0.9),     # the fleet's tracking match
    (64, 2048, 512, True, 0.0, 7.0, 0.9),      # the fleet's widening
])
def test_hamming_kernel_at_the_fleet_shapes(cuda, shape, monkeypatch):
    """K1 at B = 64 with per-scan windows, exact against the plain version
    through the route the rule picks (cells at these shapes) and through
    the other one."""
    args = _k1_args(cuda, *shape)
    ref = mp.hamming_match_plain(*args) + mp.match_result_plain(*args)
    assert int(ref[6].sum()) > 0
    assert _same_as_plain(args, ref) == "cells"
    monkeypatch.setattr(mp, "CELLS_MIN_PAIRS", float("inf"))
    assert _same_as_plain(args, ref) == "dense_int"


def test_wrappers_refuse_bad_input(cuda):
    canvas = torch.zeros((8, 8), device=cuda)
    cx = torch.zeros(4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        pp.extract_patches_kernel(canvas, cx, cx)
    with pytest.raises(ValueError):
        pp.extract_patches_kernel(canvas.t(), cx.float(), cx.float())
    args = list(_k1_args(cuda, 1, 64, 32, False, 0.0, 7.0, 0.9))
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError):
        mp.hamming_match_kernel(*bad)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError):
        mp.hamming_match_kernel(*bad)


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


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_linearize_kernel_keeps_a_far_cameras_near_points(cuda, seed):
    """A problem ~230 units from the world's origin at depths of 4-8 (a
    long scan's late keyframes): the kernel's g_lm and g_cam entry by
    entry within chip_smoke.py's GRAD_TOL of the plain version run in
    float64, as the plain version is (test_torch_linearize.py)."""
    args = far_ba_problem(seed, device=cuda)
    _, _, g_lm, _, g_cam, _ = lp.ba_linearize_kernel(*args)
    d_lm, d_cam = gradient_distances(args, g_lm, g_cam)
    assert d_lm <= 2.0 ** -17 and d_cam <= 2.0 ** -20, (d_lm, d_cam)


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


def _global_ba_args(cuda, live, C=512, L=65536, kmax=16, seed=0):
    """K2's arguments at the long scan's global-BA shape: C cameras 5 cm
    apart along x, each landmark seen by up to kmax cameras around it
    (16 slots, some left empty), noisy pixels with outliers, Huber 7; only
    the first ``live`` share of the landmark rows observed, as global BA's
    table over the whole landmark store leaves it."""
    rng = np.random.default_rng(seed)
    cx = 0.05 * np.arange(C)
    X = np.stack([rng.uniform(0, cx[-1], L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 8, L)], 1)
    n = rng.integers(2, kmax + 1, L)
    first = np.clip(np.searchsorted(cx, X[:, 0]) - n // 2, 0, C - n)
    n[int(live * L):] = 0
    lm_idx = np.repeat(np.arange(L), n)
    cam_idx = np.concatenate([f + np.arange(k) for f, k in zip(first, n)])
    rv = rng.normal(0, 0.01, (C, 3))
    tv = np.stack([-cx, rng.normal(0, 0.01, C), rng.normal(0, 0.01, C)], 1)
    from sfm_tpu_torch.np_geometry import rodrigues_np
    Rs = np.stack([rodrigues_np(r) for r in rv])
    p = np.einsum("oab,ob->oa", Rs[cam_idx], X[lm_idx]) + tv[cam_idx]
    uv = p[:, :2] / p[:, 2:] @ TEST_K[:2, :2].T + TEST_K[:2, 2]
    uv = uv + rng.normal(0, 0.7, uv.shape)
    uv[rng.uniform(0, 1, len(uv)) < 0.05] += 30.0
    f = np.float32
    o = Observations(to_t(cam_idx).long().to(cuda), to_t(lm_idx).long()
                     .to(cuda), to_t(uv.astype(f)).to(cuda),
                     torch.ones(len(uv), device=cuda))
    lm_cam, lm_uv, lm_w, dropped = build_lm_tables_device(o, L, kmax)
    assert int(dropped) == 0
    cam_free = torch.ones(C, device=cuda)
    cam_free[0] = 0.0
    Xn = X + rng.normal(0, 0.02, X.shape)
    R = exp_so3(to_t(rv.astype(f)).to(cuda)).contiguous()
    return (to_t(TEST_K).to(cuda), R, to_t(tv.astype(f)).to(cuda),
            to_t(Xn.astype(f)).to(cuda), torch.ones(L, device=cuda),
            cam_free, lm_cam, lm_uv, lm_w, 7.0)


@pytest.mark.parametrize("live", [0.2, 1.0])
def test_ba_kernels_at_the_global_ba_shape(cuda, live):
    """K2, K3 full and K3-gather at C=512, L=65536, kmax=16 (a 1M-slot
    camera-major index, most camera slots idle early in a scan), with 20%
    and 100% of the landmark rows live: equal to the plain versions and
    bit-identical on a rerun."""
    from sfm_tpu_torch.ba.large import camera_slots
    args = _global_ba_args(cuda, live)
    cs = camera_slots(args[6], args[8], 512)
    out = lp.ba_linearize_kernel(*args, slots=cs)
    ref = lp.ba_linearize_plain(*args)
    ref64 = lp.ba_linearize_plain(*_f64(args))
    for name, a, b, c in zip(("W", "V", "g_lm", "U", "g_cam", "cost"), out,
                             ref, ref64):
        print(f"K2 global-BA shape, live {live}, {name}: from f64, kernel "
              f"{_err_to_largest(a, c):.3e}, f32 plain "
              f"{_err_to_largest(b, c):.3e}; kernel from f32 plain "
              f"{_err_to_largest(a, b):.3e}")
    # f32 pixels of a few hundred and 512 cameras' sums in another order:
    # as in test_linearize_kernel_equals_plain past 1000 cameras, the f64
    # run is the witness, and the cost is held to _close
    for a, b, c in zip(out, ref, ref64):
        assert _err_to_largest(a, c) <= 2 * _err_to_largest(b, c) + 1e-6
        assert _err_to_largest(a, b) <= 1e-4
    _close(out[-1], ref[-1])
    for a, b in zip(out, lp.ba_linearize_kernel(*args, slots=cs)):
        assert torch.equal(a, b)
    W, V, g_lm = out[:3]
    Vinv = lp.damped_vinv(V, 1e-3)
    lm_cam = args[6]
    x = torch.randn((512, 6), generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda)
    # K3 against the same witness: the plain version in float64 (the
    # kernel no farther from it than twice the f32 plain version), and
    # within 1e-4 of the largest entry (chip_smoke.py's BA_REL_TOL)
    w64 = [t.double() for t in (W, Vinv, g_lm, x)]
    for mode, kern, plain in (
            ("full", lambda W, Vinv, g, x: sp.schur_kernel(
                "full", lm_cam, W, Vinv, g, x, slots=cs),
             lambda W, Vinv, g, x: sp.schur_apply_fused_plain(
                 lm_cam, W, Vinv, g, x, 512)),
            ("gather", lambda W, Vinv, g, x: (sp.schur_kernel(
                "gather", lm_cam, W, Vinv, g, x),),
             lambda W, Vinv, g, x: (sp.schur_gather_plain(
                 lm_cam, W, Vinv, g, x),))):
        first = kern(W, Vinv, g_lm, x)
        for a, b, c in zip(first, plain(W, Vinv, g_lm, x), plain(*w64)):
            e_kernel, e_plain = _err_to_largest(a, c), _err_to_largest(b, c)
            print(f"K3 {mode} global-BA shape, live {live}: from f64, kernel "
                  f"{e_kernel:.3e}, f32 plain {e_plain:.3e}")
            assert e_kernel <= 2 * e_plain + 1e-7
            assert _err_to_largest(a, b) <= 1e-4
        for a, b in zip(first, kern(W, Vinv, g_lm, x)):
            assert torch.equal(a, b)
    assert float(out[-1]) > 0


def test_run_ba_cg_on_the_card_matches_the_cpu(cuda):
    """run_ba_cg on the card (its sums in a fixed order, another order
    than the CPU's) against its CPU run on the same inputs: costs within
    rel 1e-4, the same accepted steps."""
    from sfm_tpu_torch.ba import run_ba_cg
    rng = np.random.default_rng(4)
    _, init, obs = ba_scene(rng, 6, 80, 4, noise_px=0.5, outlier_p=0.03,
                            dead_p=0.1, min_obs=2)
    cam_free = np.arange(6) > 0
    out = {}
    for dev in ("cpu", cuda):
        o = Observations(to_t(obs[0]).long().to(dev),
                         to_t(obs[1]).long().to(dev), to_t(obs[2]).to(dev),
                         to_t(obs[3]).to(dev))
        out[str(dev)] = run_ba_cg(
            to_t(TEST_K).to(dev), to_t(init["rv"]).to(dev),
            to_t(init["tv"]).to(dev), to_t(init["X"]).to(dev), o,
            cam_free=to_t(cam_free).to(dev),
            lm_free=torch.ones(80, dtype=torch.bool, device=dev),
            iterations=12, cg_iterations=15, huber_delta=2.0, tol=3e-4)[3]
    a, b = out["cuda"], out["cpu"]
    assert float(b.final_cost) < 0.5 * float(b.initial_cost)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(a, k)),
                                   float(getattr(b, k)), rtol=1e-4)
    assert int(a.accepted) == int(b.accepted)



@pytest.mark.parametrize("solver", ["run_ba", "run_ba_cg"])
def test_dense_and_cg_solvers_repeat_bit_for_bit(cuda, solver):
    """The dense and cg solvers sum over observations in a fixed order
    (utils/rowsum.py, no atomics): two runs on one problem give the same
    bits."""
    from sfm_tpu_torch.ba import core
    rng = np.random.default_rng(9)
    _, init, obs = ba_scene(rng, 12, 600, 6, noise_px=0.7, outlier_p=0.05,
                            dead_p=0.1, min_obs=2)
    o = Observations(to_t(obs[0]).long().to(cuda),
                     to_t(obs[1]).long().to(cuda), to_t(obs[2]).to(cuda),
                     to_t(obs[3]).to(cuda))
    cam_free = torch.arange(12, device=cuda) > 0
    runs = [getattr(core, solver)(
        to_t(TEST_K).to(cuda), to_t(init["rv"]).to(cuda),
        to_t(init["tv"]).to(cuda), to_t(init["X"]).to(cuda), o,
        cam_free=cam_free, lm_free=torch.ones(600, dtype=torch.bool,
                                              device=cuda),
        iterations=10, huber_delta=2.0, tol=0.0) for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    for k in ("initial_cost", "final_cost", "lam", "accepted"):
        assert torch.equal(getattr(runs[0][3], k), getattr(runs[1][3], k))
    assert float(runs[0][3].final_cost) < float(runs[0][3].initial_cost)


def test_kernel_library_builds_once_under_threads(cuda, tmp_path,
                                                  monkeypatch):
    """Two threads reach the kernels' first use together, with nothing
    built: one runs nvcc, the other waits and loads the same library."""
    import threading
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    builds, real = [], native.build

    def counted():
        builds.append(threading.get_ident())
        return real()
    monkeypatch.setattr(native, "build", counted)
    start = threading.Barrier(2)
    got, errors = [], []

    def first_use():
        try:
            start.wait()
            got.append(native.library())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(builds) == 1 and got[0] is got[1]
    stems = sorted(p.name for p in tmp_path.rglob("*.so"))
    assert stems == sorted(f"lib{s.stem}.so"
                           for s in native._CSRC.glob("*.cu"))


def test_pipeline_maps_on_its_own_stream(cuda):
    """The pipeline's mapping pass (K1, K2, K3, K3-gather) launches on the
    mapping stream, not the default one, and equals the same pass on the
    default stream bit for bit."""
    from torch_port_util import TEST_CFG_KW
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine import (CameraParams, init_state,
                                      mapping_pass, step_frame)
    from sfm_tpu_torch.mapstore import tree_map
    from sfm_tpu_torch.parallel.pipeline import AsyncMappingEngine
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    cfg = SfMConfig(**dict(TEST_CFG_KW, ba_solver="large", ba_kmax=8,
                           ba_cg_iterations=12, ba_huber_delta=2.0))
    K = to_t(TEST_K).to(cuda)
    cam = CameraParams(K=K, d=torch.zeros(5, device=cuda), Kopt=K)
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(30)
    state = init_state(cfg, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for i in range(30):
        img = torch.as_tensor(scene.render(TEST_K, rv[i], tv[i], 240, 320),
                              device=cuda)
        state, _ = step_frame(cfg, cam, state, img, gen, defer_mapping=True)
        if int(state.status) == 1 and int(state.pending_map_slot) >= 0 \
                and int(state.kfs.valid.sum()) >= 3:
            break
    slot = int(state.pending_map_slot)
    assert slot >= 0
    eng = AsyncMappingEngine(cfg, cam, device=cuda)
    default = torch.cuda.current_stream(cuda).cuda_stream
    ours = eng._stream.cuda_stream
    assert ours != default
    native.reset_launch_counts()
    ready = torch.cuda.Event()
    ready.record()
    on_map = eng._map(state, slot, ready)
    on_default = mapping_pass(cfg, cam, state, slot)
    torch.cuda.synchronize()
    counts = dict(native.STREAM_LAUNCHES)
    for name in ("hamming_match", "ba_linearize", "schur_apply",
                 "schur_gather"):
        assert counts.get((name, ours), 0) > 0, name
        assert counts.get((name, ours)) == counts.get((name, default)), name
    equal = []
    tree_map(lambda a, b: equal.append(torch.equal(a, b)), on_map,
             on_default)
    assert all(equal)


def test_pipeline_tracks_on_the_cpu_and_maps_on_the_card(cuda):
    """AsyncMappingEngine(track_device="cpu", map_device=the card): S0
    copied to the card at each dispatch, M back at each join.  Every K2 /
    K3 / K3-gather launch comes from the mapping stream, and the scan
    equals the CPU-only pipeline's within tests/test_torch_pipeline.py's
    limits: the same statuses, keyframes within 1 (the engine parity's),
    ATE under 10% of the extent, and the shared keyframes' centres within
    2% of the extent of the CPU run's (the card's BA sums in another
    order)."""
    from torch_port_util import TEST_CFG_KW
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine import CameraParams
    from sfm_tpu_torch.parallel.pipeline import AsyncMappingEngine
    from sfm_tpu_torch.synthetic import (SpriteScene, centres_of,
                                         strafe_trajectory, umeyama_ate)
    cfg = SfMConfig(**dict(TEST_CFG_KW, ba_solver="large", ba_kmax=8,
                           ba_cg_iterations=12, ba_huber_delta=2.0))
    K = to_t(TEST_K)
    cam = CameraParams(K=K, d=torch.zeros(5), Kopt=K)
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(30)
    frames = [scene.render(TEST_K, rv[i], tv[i], 240, 320)
              for i in range(30)]
    runs = {}
    for name, kw in (("split", dict(track_device="cpu", map_device=cuda)),
                     ("cpu", dict(device="cpu"))):
        eng = AsyncMappingEngine(cfg, cam, merge_lag=2, **kw)
        native.reset_launch_counts()
        status = [int(eng.step(f)["status"]) for f in frames]
        eng.flush()
        torch.cuda.synchronize()
        runs[name] = (eng, status, dict(native.STREAM_LAUNCHES))
    eng, status, by_stream = runs["split"]
    assert eng.state.lms.xyz.device.type == "cpu"
    ours = eng._stream.cuda_stream
    for k in ("ba_linearize", "schur_apply", "schur_gather"):
        assert by_stream.get((k, ours), 0) > 0, k
        assert sum(n for (name, _), n in by_stream.items() if name == k) \
            == by_stream[(k, ours)], k
    assert by_stream.get(("hamming_match", ours), 0) > 0
    assert not runs["cpu"][2]                 # nothing launched on the card
    ref, ref_status, _ = runs["cpu"]
    assert status == ref_status and status[-1] == 1
    out = {}
    for name, e in (("split", eng), ("cpu", ref)):
        kfs = e.state.kfs
        valid = kfs.valid.numpy()
        fns = kfs.frames.frame_no.numpy()[valid]
        order = np.argsort(fns)
        est = centres_of(kfs.frames.rvec.numpy()[valid][order],
                         kfs.frames.tvec.numpy()[valid][order])
        out[name] = (fns[order], est)
    (fa, ca), (fb, cb) = out["split"], out["cpu"]
    assert abs(len(fa) - len(fb)) <= 1 and len(fb) >= 3
    gt = centres_of(rv[fb], tv[fb])
    extent = np.linalg.norm(gt[-1] - gt[0])
    for f, c in out.values():
        assert umeyama_ate(c, centres_of(rv[f], tv[f])) < 0.10 * extent
    both = np.intersect1d(fa, fb)
    assert len(both) >= 3
    gap = ca[np.isin(fa, both)] - cb[np.isin(fb, both)]
    assert np.abs(gap).max() < 0.02 * extent


@pytest.mark.parametrize("mode", ["POSE_ONLY", "STRUCT_ONLY"])
def test_run_ba_modes_on_the_card(cuda, mode):
    """run_ba(mode=...) on the card: the frozen block bit for bit, the
    cost not rising, and the CPU run's costs within rel 1e-4."""
    from sfm_tpu_torch.ba import BAMode, run_ba
    rng = np.random.default_rng(12)
    _, init, obs = ba_scene(rng, 8, 300, 5, noise_px=0.5, outlier_p=0.03,
                            dead_p=0.1, min_obs=2)
    out = {}
    for dev in ("cpu", cuda):
        o = Observations(*(to_t(a).to(dev) for a in obs))
        o = o._replace(cam_idx=o.cam_idx.long(), lm_idx=o.lm_idx.long())
        args = [to_t(init[k]).to(dev) for k in ("rv", "tv", "X")]
        got = run_ba(to_t(TEST_K).to(dev), *args, o,
                     cam_free=torch.ones(8, dtype=torch.bool, device=dev),
                     lm_free=torch.ones(300, dtype=torch.bool, device=dev),
                     mode=BAMode[mode], iterations=10, huber_delta=2.0)
        frozen = got[2:3] if mode == "POSE_ONLY" else got[:2]
        init_frozen = args[2:3] if mode == "POSE_ONLY" else args[:2]
        assert all(torch.equal(a, b) for a, b in zip(frozen, init_frozen))
        out[str(dev)] = got[3]
    a, b = out["cuda"], out["cpu"]
    assert float(a.final_cost) < float(a.initial_cost)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(a, k)),
                                   float(getattr(b, k)), rtol=1e-4)


def test_match_pairs_on_k1s_result(cuda):
    """match_pairs on the kernel's MatchResult at the tracking shape equals
    the pairs of the plain version's, exactly, at caps that hold every
    match and that the matches overflow."""
    from sfm_tpu_torch.features.match import match_pairs
    args = _k1_args(cuda, *K1_SHAPES["tracking"])
    kw = dict(min_radius=1.5, max_radius=40.0, max_distance=90.0, ratio=0.8)
    n0 = native.LAUNCHES["hamming_match"]
    res = mp.match_features_pallas(*(a[0] for a in args[:6]), **kw)
    assert native.LAUNCHES["hamming_match"] == n0 + 1
    ref = mp.match_features_pallas(*(a[0].cpu() for a in args[:6]), **kw)
    n = int(ref.mask.sum())
    assert n > 20
    for cap in (2 * n, n // 2):
        for a, b in zip(match_pairs(res, cap), match_pairs(ref, cap)):
            assert torch.equal(a.cpu(), b)


def _dist_problem(seed=11, C=8, L=160, kmax=5):
    rng = np.random.default_rng(seed)
    _, init, obs = ba_scene(rng, C, L, kmax, noise_px=0.5, dead_p=0.05,
                            min_obs=2)
    return dict(K=TEST_K, rv=init["rv"], tv=init["tv"], X=init["X"],
                cam_free=np.arange(C) > 1, lm_free=np.ones(L, bool),
                obs=obs)


def test_dist_large_ba_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """The distributed implicit-Schur solver on 2 gloo ranks sharing the
    card (NCCL takes one rank per card): each rank launches K2, K3 and
    K3-gather on its shard, the ranks' poses are equal bit for bit, and
    they agree with run_large_ba (tol 0) on the whole problem on the card
    at tests/test_parallel.py's limits."""
    from sfm_tpu_torch.ba.large import build_tables, run_large_ba
    from sfm_tpu_torch.parallel import partition_tables
    from torch_port_util import dist_solver_worker, load_ranks, spawn_ranks
    p = _dist_problem()
    C, L = p["rv"].shape[0], p["X"].shape[0]
    obs = Observations(*map(to_t, p["obs"]))
    tabs, shard = partition_tables(obs, C, L, 2, L, 5)
    kw = dict(iterations=8, cg_iterations=25, huber_delta=2.0)
    job = ("card", "large", dict(n_cams=C, shard_size=shard, **kw),
           dict(p, tables=tuple(t.numpy() for t in tabs)))
    spawn_ranks(dist_solver_worker, 2, (tmp_path, [job], "cuda"), tmp_path,
                timeout=240.0, device="cuda")
    ranks = load_ranks(tmp_path, "card", 2)
    for r in ranks:
        assert min(r["launches"]) > 0, r["launches"]
        for k in ("rv", "tv", "final_cost"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
    X = np.concatenate([r["X"] for r in sorted(
        ranks, key=lambda r: int(r["map_rank"]))])
    t = lambda a: to_t(a).to(cuda)  # noqa: E731
    tables = build_tables(obs, C, L, L, 5)
    rv_s, _, X_s, st = run_large_ba(
        t(p["K"]), t(p["rv"]), t(p["tv"]), t(p["X"]),
        type(tables)(*map(t, tables)), cam_free=t(p["cam_free"]),
        lm_free=t(p["lm_free"]), tol=0.0, **kw)
    assert float(ranks[0]["final_cost"]) < float(ranks[0]["initial_cost"])
    np.testing.assert_allclose(ranks[0]["rv"], rv_s.cpu().numpy(), atol=1e-3)
    np.testing.assert_allclose(X, X_s.cpu().numpy(), atol=5e-3)


def test_partition_tables_on_the_card_equals_the_host(cuda):
    from sfm_tpu_torch.parallel import partition_tables
    p = _dist_problem(seed=12, C=10, L=400, kmax=6)
    obs = Observations(*map(to_t, p["obs"]))
    host, shard = partition_tables(obs, 10, 400, 4, 200, 6)
    card, shard_c = partition_tables(obs, 10, 400, 4, 200, 6, device=cuda)
    assert shard_c == shard
    for a, b in zip(card, host):
        assert a.is_cuda and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="drops"):
        partition_tables(obs, 10, 400, 4, 20, 6, device=cuda)


def test_shard_batched_state_keeps_a_card_fleet_on_the_card(cuda):
    """On a gloo mesh (its device type "cpu", as for gloo ranks sharing
    the card) the default block of a fleet made on the card stays on the
    card; ``device="cpu"`` still moves it."""
    import torch.distributed as dist

    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.parallel import (init_batched_state,
                                        make_scan_map_mesh,
                                        shard_batched_state)
    from torch_port_util import TEST_CFG_KW
    mesh = make_scan_map_mesh(1, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and mesh.device_type == "cpu"
        states = init_batched_state(SfMConfig(**TEST_CFG_KW), 2, cuda)
        block = shard_batched_state(states, mesh)
        assert block.status.is_cuda and block.kfs.frames.rvec.is_cuda
        assert torch.equal(block.status, states.status)
        images = torch.zeros((2, 4, 4), device=cuda)
        assert shard_batched_state(images, mesh).is_cuda
        assert not shard_batched_state(states, mesh,
                                       device="cpu").status.is_cuda
    finally:
        dist.destroy_process_group()


def _schur_diag_problem(dev):
    """A problem with dead slots (w == 0) and frozen cameras, its
    landmark-major table built on ``dev``."""
    from sfm_tpu_torch.ba.large import ObsTables
    rng = np.random.default_rng(12)
    truth, init, obs = ba_scene(rng, 10, 400, 6, noise_px=0.5,
                                outlier_p=0.03, dead_p=0.3, min_obs=3)
    cam_free = np.ones(10, bool)
    cam_free[[0, 1, 6]] = False
    for k in ("rv", "tv"):
        init[k][~cam_free] = truth[k][~cam_free]
    o = Observations(to_t(obs[0]).long().to(dev), to_t(obs[1]).long().to(dev),
                     to_t(obs[2]).to(dev), to_t(obs[3]).to(dev))
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(o, 400, 6)
    return ((to_t(TEST_K).to(dev), to_t(init["rv"]).to(dev),
             to_t(init["tv"]).to(dev), to_t(init["X"]).to(dev),
             ObsTables(lm_cam, lm_uv, lm_w)),
            dict(cam_free=to_t(cam_free).to(dev),
                 lm_free=torch.ones(400, dtype=torch.bool, device=dev),
                 iterations=10, cg_iterations=25, huber_delta=2.0, tol=0.0,
                 precond="schur_diag"))


def test_run_large_ba_schur_diag_on_the_card_matches_the_cpu(cuda):
    """precond="schur_diag" on the card (K2, K3 and K3-gather; the
    preconditioner's per-camera sums in camera_slots' order) against its
    CPU run (the plain versions) on a table with dead slots and frozen
    cameras: costs within rel 1e-4, the same accepted steps, poses within
    1e-4, the frozen cameras unmoved."""
    from sfm_tpu_torch.ba.large import run_large_ba
    out = {}
    for dev in ("cpu", cuda):
        args, kw = _schur_diag_problem(dev)
        native.reset_launch_counts()
        out[str(dev)] = run_large_ba(*args, **kw)
        if dev == cuda:
            assert all(native.LAUNCHES[k] > 0 for k in (
                "ba_linearize", "schur_apply", "schur_gather"))
    a, b = out["cuda"], out["cpu"]
    assert float(b[3].final_cost) < 0.5 * float(b[3].initial_cost)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(a[3], k)),
                                   float(getattr(b[3], k)), rtol=1e-4)
    assert int(a[3].accepted) == int(b[3].accepted)
    np.testing.assert_allclose(a[0].cpu().numpy(), b[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(a[1].cpu().numpy(), b[1].numpy(), atol=1e-4)
    args, _ = _schur_diag_problem("cpu")
    frozen = ~_schur_diag_problem("cpu")[1]["cam_free"]
    assert torch.equal(a[1].cpu()[frozen], args[2][frozen])


def test_run_large_ba_schur_diag_repeats_bit_for_bit(cuda):
    from sfm_tpu_torch.ba.large import run_large_ba
    args, kw = _schur_diag_problem(cuda)
    runs = [run_large_ba(*args, **kw) for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    for k in ("initial_cost", "final_cost", "lam", "accepted"):
        assert torch.equal(getattr(runs[0][3], k), getattr(runs[1][3], k))


# (cameras, landmarks, kmax, CG iterations, share of live landmark rows):
# a ba1k-like problem, and FLAGSHIP's mapping BA (32 keyframe slots, 2048
# compacted landmark rows, part of them live)
PCG_GRAPH_SHAPES = {"ba1k_like": (200, 20000, 6, 25, 1.0),
                    "flagship_mapping": (32, 2048, 8, 12, 0.6)}


@pytest.fixture
def fresh_pcg_graphs(monkeypatch):
    from collections import OrderedDict
    from sfm_tpu_torch.ba import pcg_graph
    monkeypatch.setattr(pcg_graph, "_GRAPHS", OrderedDict())


def _pcg_inputs(cuda, C, L, kmax, live, seed, lam=1e-3):
    """``large._schur_pcg``'s inputs at a problem's start, made as
    ``_large_lm`` makes them (K2's blocks damped, the jacobi_u
    preconditioner, the rhs through K3)."""
    from sfm_tpu_torch.ba.core import _damp, _inv
    from sfm_tpu_torch.ba.large import camera_slots
    pr = SMOKE.ba_problem(torch, cuda, C, L, kmax, seed=seed, noise_px=0.5,
                          spread=0.2, live=live)
    lm_cam, lm_uv, lm_w = pr["tables"][:3]
    cs = camera_slots(lm_cam, lm_w, C)
    W, V, g_lm, U, g_cam, _ = lp.ba_linearize(
        pr["K"], exp_so3(pr["rv"]).contiguous(), pr["tv"], pr["X"],
        pr["lm_free"].float(), pr["cam_free"].float(), lm_cam, lm_uv, lm_w,
        2.0, slots=cs)
    Ud, vinv = _damp(U, lam), lp.damped_vinv(V, lam)
    rhs = g_cam - sp.SchurOperator(W, lm_cam, vinv, cs).w_vinv_g(g_lm, C)
    M_inv = _inv(Ud + 1e-6 * torch.eye(6, device=cuda))
    return dict(Ud=Ud, M_inv=M_inv, rhs=rhs, W=W, vinv=vinv, lm_cam=lm_cam,
                offsets=cs.offsets, slots=cs.slots)


@pytest.mark.parametrize("shape", list(PCG_GRAPH_SHAPES))
def test_pcg_graph_replays_equal_the_eager_loop(cuda, fresh_pcg_graphs,
                                                shape):
    """The PCG captured once, then replayed on two problems of one shape
    in turn: each replay equals the eager loop on its problem bit for bit
    (the static inputs are refreshed), nothing more is captured, and every
    replay counts its CG iterations' K3 launches on the caller's
    stream."""
    import functools
    from sfm_tpu_torch.ba import large, pcg_graph
    from sfm_tpu_torch.utils.profiling import RECORDER
    C, L, kmax, cg, live = PCG_GRAPH_SHAPES[shape]
    fn = functools.partial(large._schur_pcg, iterations=cg)
    problems = [_pcg_inputs(cuda, C, L, kmax, live, seed) for seed in (1, 2)]
    eager = [fn(**p) for p in problems]
    assert not torch.equal(eager[0], eager[1])
    key = large._pcg_key(problems[0]["Ud"], problems[0]["W"], cg)
    with RECORDER.enabled() as trace:
        first = pcg_graph.run(key, fn, problems[0])
        assert trace.counter("pcg_graph_capture") == 1
        native.reset_launch_counts()
        order = (1, 0, 1, 1)
        outs = [pcg_graph.run(key, fn, problems[i]) for i in order]
        torch.cuda.synchronize()
    assert trace.counter("pcg_graph_capture") == 1
    assert trace.counter("pcg_graph_replay") == len(order)
    assert torch.equal(first, eager[0])
    for i, out in zip(order, outs):
        assert torch.equal(out, eager[i]), i
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert native.STREAM_LAUNCHES == {("schur_apply", stream):
                                      len(order) * cg}


def test_run_large_ba_replays_equal_the_eager_solve(cuda, fresh_pcg_graphs,
                                                    monkeypatch):
    """run_large_ba at the ba1k-like shape, twice with the graph path (the
    first solve captures, the second captures nothing) against the eager
    path: the same bits, and per solve (cg + 1) K3 full applies an LM
    iteration, as eagerly."""
    from sfm_tpu_torch.ba import large
    from sfm_tpu_torch.utils.profiling import RECORDER
    C, L, kmax, cg, _ = PCG_GRAPH_SHAPES["ba1k_like"]
    pr = SMOKE.ba_problem(torch, cuda, C, L, kmax, seed=4, noise_px=0.5,
                          spread=0.2)
    kw = dict(cam_free=pr["cam_free"], lm_free=pr["lm_free"], iterations=4,
              cg_iterations=cg, huber_delta=2.0, tol=0.0)

    def solve():
        native.reset_launch_counts()
        out = large.run_large_ba(pr["K"], pr["rv"], pr["tv"], pr["X"],
                                 pr["tables"], **kw)
        torch.cuda.synchronize()
        return out, native.LAUNCHES["schur_apply"]
    with monkeypatch.context() as m:
        m.setattr(large, "_pcg_graph_wanted", lambda device, reduce: False)
        eager, n_eager = solve()
    assert n_eager == kw["iterations"] * (cg + 1)
    captured = []
    for _ in range(2):
        with RECORDER.enabled() as trace:
            out, n = solve()
        captured.append(trace.counter("pcg_graph_capture"))
        assert n == n_eager
        assert trace.counter("pcg_graph_capture") + trace.counter(
            "pcg_graph_replay") == trace.calls("ba.pcg") == kw["iterations"]
        for a, b in zip(out[:3] + out[3][:4], eager[:3] + eager[3][:4]):
            assert torch.equal(a, b)
    assert captured == [1, 0]
    assert float(eager[3].final_cost) < float(eager[3].initial_cost)


def test_distorted_flagship_make_frame_on_the_card_matches_the_cpu(cuda):
    """make_frame at FLAGSHIP's size (480x640, 512 keypoints) on a
    ray-traced frame through chip_smoke's lens, on the card (K5 among
    torch ops) against the CPU's plain path: the keypoints at the same
    positions (at most 1% of them apart: FAST and the pyramid compare
    floats that either library may round last), undistorted positions
    within 1e-4 px, descriptors within tests/test_torch_features.py's
    bit-flip bound (measured: all 512 keypoints at the same positions, no
    descriptor bit apart; NVIDIA H100 80GB HBM3, 700 W)."""
    from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
    from sfm_tpu_torch.engine import SfMEngine
    from sfm_tpu_torch.engine.state import make_frame
    from sfm_tpu_torch.raytrace import RayScene, orbit_arc_trajectory
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    dist = [-0.22, 0.06, 0.0009, -0.0007, 0.0]
    rv, tv = orbit_arc_trajectory(60, radius=5.5, arc=0.7)
    img = RayScene(seed=11, n_boxes=24).render(
        K, rv[20], tv[20], 480, 640, d=dist, noise_std=2.5, frame_no=20)
    cfg = SfMConfig(**FLAGSHIP)
    fr = {}
    for dev in ("cpu", cuda):
        eng = SfMEngine(K, (480, 640), dist, cfg, device=dev)
        native.reset_launch_counts()
        fr[str(dev)] = make_frame(cfg, eng.cam, to_t(img).to(dev),
                                  torch.tensor(20, dtype=torch.int32,
                                               device=dev)).map(
            lambda x: x.cpu())
        if dev == cuda:
            assert native.LAUNCHES["patch_sampler"] == 1
    a, b = fr["cuda"], fr["cpu"]
    va, vb = a.kp_valid.numpy(), b.kp_valid.numpy()
    assert vb.sum() > 400
    pa = {tuple(x): i for i, x in enumerate(a.xy_dist.numpy()[va])}
    ia = np.nonzero(va)[0]
    same = [(ia[pa[tuple(x)]], j) for j, x in zip(np.nonzero(vb)[0],
                                                   b.xy_dist.numpy()[vb])
            if tuple(x) in pa]
    print(f"{len(same)} of {vb.sum()} keypoints at the same position")
    assert len(same) >= 0.99 * vb.sum() and abs(va.sum() - vb.sum()) \
        <= 0.01 * vb.sum()
    i, j = map(np.array, zip(*same))
    np.testing.assert_allclose(a.xy.numpy()[i], b.xy.numpy()[j], atol=1e-4)
    bits = lambda d: np.unpackbits(d.view(np.uint8), axis=-1)  # noqa: E731
    rate = float((bits(a.desc.numpy()[i]) != bits(b.desc.numpy()[j])).mean())
    print(f"descriptor bits apart: {rate:.2e}")
    assert rate < 0.002


@pytest.mark.parametrize("name", list(SMOKE.SANITIZE_CASES))
def test_sanitize_case(cuda, name):
    """A case of the kernel driver, at a main-path or an edge shape: each
    kernel twice in guard bands of two poisons, equal to its plain version
    (K1 and K5 bit for bit, K2 / K3 within BA_REL_TOL of the largest
    entry), the two runs equal bit for bit, no band or input written."""
    calls = sum(SMOKE.sanitize_check(torch, sub)
                for sub in SMOKE.SANITIZE_CASES[name](torch, cuda))
    assert calls > 0


def test_k1_refuses_empty_batches(cuda):
    """An empty batch (Ns, Nt or B of 0) raises ValueError before any
    launch: the kernels would index row -1."""
    assert all(SMOKE.k1_refusals(torch, cuda).values())


# csrc/cull.cu against the plain walk at (K, N, L): the flagship's store,
# the long session's, and one whose rows outgrow a block of 1024 threads;
# on chip_smoke's stores: a sweep (invalid slots interleaved, repeated
# links within a keyframe) and two whose fractions tie the redundancy
CULL_SHAPES = {"flagship": (32, 512, 8192), "longscan": (512, 512, 65536),
               "1500 keypoints": (512, 1500, 65536)}
CULL_STORES = {"sweep": (0.9, None), "tie 450/500 at 0.9": (0.9, (450, 500)),
               "tie 1/2 at 0.5": (0.5, (1, 2))}


@pytest.mark.parametrize("keep_first", [0, 2])
@pytest.mark.parametrize("store", list(CULL_STORES))
@pytest.mark.parametrize("shape", list(CULL_SHAPES))
def test_cull_kernel_equals_plain(cuda, shape, store, keep_first):
    """One launch gives the plain walk's valid mask, culls by rank and
    decremented view counts bit for bit."""
    K, N, L = CULL_SHAPES[shape]
    redundancy, tie = CULL_STORES[store]
    args = SMOKE.cull_inputs(torch, cuda, K, N, L, seed=K + N, tie=tie)
    opts = dict(redundancy=redundancy, min_others=3, keep_first=keep_first)
    n0 = native.LAUNCHES["cull_keyframes"]
    out = ms.cull_ranks_kernel(*args, **opts)
    torch.cuda.synchronize()
    assert native.LAUNCHES["cull_keyframes"] == n0 + 1
    ref = ms.cull_ranks_plain(*(a.cpu() for a in args), **opts)
    assert int(ref[1].sum()) > 0
    for name, a, b in zip(("valid", "culled", "counts"), out, ref):
        assert torch.equal(a.cpu(), b), name


def _cull_keyframe_store(dev, K, N, L, **kw):
    links, kp_valid, valid, frame_no = SMOKE.cull_store(K, N, L, **kw)
    kfs = ms.empty_keyframes(K, N, 16, dev)
    fr = kfs.frames.replace(landmark=to_t(links).to(dev),
                            kp_valid=to_t(kp_valid).to(dev),
                            frame_no=to_t(frame_no).to(dev))
    return kfs.replace(frames=fr, valid=to_t(valid).to(dev))


def test_cull_keyframes_makes_no_synchronisation(cuda):
    """``cull_keyframes`` on a CUDA store at the long session's size runs
    under the sync debug mode "error" without raising, counts one
    ``cull_kernel`` and no ``implicit_sync``, and culls as the CPU store
    does."""
    K, N, L = 512, 512, 65536
    kfs = _cull_keyframe_store(cuda, K, N, L, seed=1)
    ms.cull_keyframes(kfs, L)   # the build and the first launch
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with RECORDER.enabled() as trace:
            out, culled = ms.cull_keyframes(kfs, L)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert trace.counter("cull_kernel") == 1
    assert trace.counter("implicit_sync") == 0
    ref, culled_ref = ms.cull_keyframes(
        ms.tree_map(lambda x: x.cpu(), kfs), L)
    assert int(culled_ref.sum()) > 0
    assert torch.equal(culled.cpu(), culled_ref)
    assert torch.equal(out.valid.cpu(), ref.valid)


# csrc/pose.cu against the plain refinement (pnp.refine_pose_plain,
# ransac.refined_plain) on the card, on chip_smoke's pose problems.  The
# tolerances: the pose after one iteration within 1e-5 of the plain
# version's, since H and g are summed in another order and the kernel
# contracts multiply-adds, which moves a float32 step of ~1e-3 by ~1e-7
# of the pose; after more iterations the refinement amplifies such
# differences (a start 7e-7 apart ended 4e-4 apart in a 120x160 scan), so
# the final cost, in float64, within 1e-4 relative; the inlier masks and
# counts equal, since the problems are well separated (inliers within 1.5
# px of their projection, outliers 20 px off, the threshold 7 px).
def _pose_run(cuda, P, N, gated, iters, **kw):
    args = SMOKE.pose_inputs(torch, cuda, P, N, gated, **kw)
    kernel, plain = SMOKE.pose_fns(gated, iters)
    n0 = native.LAUNCHES["pose_refine"]
    out = kernel(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["pose_refine"] == n0 + 1
    ref = plain(*args)
    w = ref[2] if gated else args[5]
    c_k, c_p = (SMOKE.pose_cost(torch, args, o[0], o[1], w)
                for o in (out, ref))
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()
    assert ((c_k - c_p).abs() <= 1e-4 * c_p).all(), (c_k, c_p)
    if gated:
        assert torch.equal(out[2], ref[2])
        assert torch.equal(out[3], ref[3])
        assert int(ref[3].min()) > 0
    if iters == 1:
        for a, b in zip(out[:2], ref[:2]):
            assert (a - b).abs().max() <= 1e-5
    return args, out, ref


@pytest.mark.parametrize("iters", [1, 4])
def test_pose_refine_kernel_equals_plain(cuda, iters):
    """refine_pose at the tracking call's 512 matches."""
    _pose_run(cuda, 1, 512, False, iters, seed=iters)


def test_pose_gated_kernel_equals_plain(cuda):
    """ransac_pnp's refined() at 512 matches, 2 rounds of 6 iterations,
    threshold 7 px: the pose, the inliers and their count."""
    _pose_run(cuda, 1, 512, True, 6, seed=5)


@pytest.mark.parametrize("gated, iters", [(True, 6), (False, 4)])
def test_pose_kernel_fleet_batch(cuda, gated, iters):
    """A fleet's 64 scans x 512 matches: 64 blocks, each its own pose and
    points."""
    _pose_run(cuda, 64, 512, gated, iters, seed=6)


def test_pose_kernel_at_relocalisation_size(cuda):
    """N = 65536 landmark slots with 2% valid, as relocalisation and the
    loop probe pass them."""
    _pose_run(cuda, 1, 65536, True, 6, live=0.02, seed=7)


@pytest.mark.parametrize("gated", [False, True])
def test_pose_kernel_without_weights_returns_the_start(cuda, gated):
    """All weights zero (or no point valid): no step lowers a zero cost,
    so the start comes back bit for bit, with no inliers."""
    args = list(SMOKE.pose_inputs(torch, cuda, 3, 512, gated, seed=8))
    args[5] = torch.zeros_like(args[5])
    kernel, _ = SMOKE.pose_fns(gated, 4)
    out = kernel(*args)
    assert torch.equal(out[0], args[1]) and torch.equal(out[1], args[2])
    if gated:
        assert not out[2].any() and int(out[3].sum()) == 0


@pytest.mark.parametrize("gated", [False, True])
def test_pose_kernel_at_depth_zero_and_behind_the_camera(cuda, gated):
    """Points at camera depth ~0 (the 1e-9 and 1e-6 guards) and behind
    the camera (weight 1): finite, and as the plain version."""
    _pose_run(cuda, 2, 512, gated, 1, degenerate=8, seed=9)


@pytest.mark.parametrize("iters", [1, 4])
def test_pose_kernel_near_pi(cuda, iters):
    """A rotation 0.02 rad short of pi: log_so3's near-pi branch."""
    _pose_run(cuda, 1, 512, False, iters, angle=np.pi - 0.02, seed=10)


@pytest.mark.parametrize("P, gated", [(1, True), (64, False)])
def test_pose_kernel_repeats_bit_for_bit(cuda, P, gated):
    """Fixed-order sums, no atomics: two launches give equal bits."""
    args = SMOKE.pose_inputs(torch, cuda, P, 512, gated, seed=11)
    kernel, _ = SMOKE.pose_fns(gated, 6)
    for a, b in zip(kernel(*args), kernel(*args)):
        assert SMOKE.same_bits(torch, a, b)


def test_pose_wrapper_refuses_other_inputs(cuda):
    """A float64 pose, a float mask or K on the host raise before any
    launch."""
    from sfm_tpu_torch import ransac
    from sfm_tpu_torch.geometry import pnp
    K, rv, tv, xyz, uv, valid = SMOKE.pose_inputs(torch, cuda, 1, 64, True)
    w = valid.float()
    n0 = native.LAUNCHES["pose_refine"]
    with pytest.raises(TypeError):
        pnp.refine_pose(K, rv.double(), tv, xyz, uv, w, iters=2)
    with pytest.raises(TypeError):
        pnp.refine_pose(K, rv, tv, xyz.double(), uv, w, iters=2)
    with pytest.raises(TypeError):
        ransac.refined_kernel(K, rv, tv, xyz, uv, w, threshold=7.0, iters=2)
    with pytest.raises(ValueError, match="different devices|expected a CUDA"):
        pnp.refine_pose(K.cpu(), rv, tv, xyz, uv, w, iters=2)
    with pytest.raises(ValueError, match="different devices|expected a CUDA"):
        ransac.refined(K, rv, tv, xyz, uv, valid.cpu(), threshold=7.0,
                       iters=2)
    assert native.LAUNCHES["pose_refine"] == n0


def test_pose_entries_count_and_make_no_synchronisation(cuda):
    """On the card each entry launches once and counts one ``pose_refine``
    and one ``pose_kernel``, under the sync debug mode "error"."""
    from sfm_tpu_torch import ransac
    from sfm_tpu_torch.geometry import pnp
    K, rv, tv, xyz, uv, valid = SMOKE.pose_inputs(torch, cuda, 1, 512, True)
    pnp.refine_pose(K, rv, tv, xyz, uv, valid.float(), iters=4)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with RECORDER.enabled() as trace:
            pnp.refine_pose(K, rv, tv, xyz, uv, valid.float(), iters=4)
            ransac.refined(K, rv, tv, xyz, uv, valid, threshold=7.0, iters=6)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert trace.counter("pose_refine") == 2
    assert trace.counter("pose_kernel") == 2
    assert trace.counter("implicit_sync") == 0
