"""The camera-major slot index of the large solver
(``sfm_tpu_torch.ba.large.camera_slots``) and the index contract that the
camera-side phase of the BA kernels follows, on the CPU: the CSR against a
numpy bucketing, and per-camera sums over its slots, done in numpy here,
against the plain K3 scatter and the plain K2 camera blocks.  Also the
engine's default device: the card, never a silent CPU engine."""

import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, ba_scene, to_t

from sfm_tpu_torch.ba import linearize_pallas as lp
from sfm_tpu_torch.ba import schur_pallas as sp
from sfm_tpu_torch.ba.large import build_lm_tables_device, camera_slots
from sfm_tpu_torch.ba.residuals import (Observations, huber_weights,
                                        residuals_and_jacobians)
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import SfMEngine
from sfm_tpu_torch.geometry.rotations import exp_so3
from sfm_tpu_torch.io import load_state, save_state

# (C, L, kmax, share of empty slots, share of dead landmark rows, cameras
# left without an observation); camera indices out of range are clamped
CASES = {
    "empty slots": (7, 40, 5, 0.4, 0.0, ()),
    "dead rows": (6, 50, 4, 0.1, 0.6, ()),
    "idle cameras": (9, 60, 6, 0.2, 0.1, (0, 4, 8)),
    "C=1": (1, 30, 3, 0.3, 0.2, ()),
    "kmax=1": (5, 64, 1, 0.3, 0.2, (2,)),
}


def _table(name):
    C, L, kmax, empty_p, dead_p, idle = CASES[name]
    rng = np.random.default_rng(len(name) * 31 + C)
    busy = np.setdiff1d(np.arange(C), idle)
    lm_cam = rng.choice(busy, (L, kmax)).astype(np.int32)
    lm_cam[rng.random((L, kmax)) < 0.05] = C + 3     # clamped to C - 1
    lm_w = rng.uniform(0.5, 2.0, (L, kmax)).astype(np.float32)
    lm_w[rng.random((L, kmax)) < empty_p] = 0.0
    lm_w[rng.random(L) < dead_p] = 0.0
    if C - 1 in idle:   # keep the idle camera idle after the clamp
        lm_w[lm_cam >= C] = 0.0
    lm_cam[lm_w == 0] = 0   # as the table builders leave empty slots
    return C, lm_cam, lm_w


def _numpy_csr(lm_cam, lm_w, C):
    cam = np.clip(lm_cam.reshape(-1), 0, C - 1)
    live = lm_w.reshape(-1) != 0
    per = [np.nonzero(live & (cam == c))[0] for c in range(C)]
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in per])])
    return offsets, np.concatenate(per)


@pytest.mark.parametrize("name", list(CASES))
def test_camera_slots_equal_numpy_bucketing(name):
    C, lm_cam, lm_w = _table(name)
    cs = camera_slots(to_t(lm_cam), to_t(lm_w), C)
    offsets, slots = _numpy_csr(lm_cam, lm_w, C)
    assert cs.offsets.dtype == cs.slots.dtype == torch.int32
    np.testing.assert_array_equal(cs.offsets.numpy(), offsets)
    n = int(offsets[-1])
    np.testing.assert_array_equal(cs.slots.numpy()[:n], slots)
    # every slot appears once, the empty ones after the live ones
    all_s = cs.slots.numpy()
    np.testing.assert_array_equal(np.sort(all_s), np.arange(lm_cam.size))
    assert (lm_w.reshape(-1)[all_s[n:]] == 0).all()


@pytest.mark.parametrize("name", list(CASES))
def test_camera_slots_without_weights_take_every_slot(name):
    """No weights: every slot is live, bucketed by its clamped camera (the
    index the K3 wrappers build when the caller gives none; an empty
    slot's zero W block adds nothing)."""
    C, lm_cam, lm_w = _table(name)
    cs = camera_slots(to_t(lm_cam), None, C)
    offsets, slots = _numpy_csr(lm_cam, np.ones_like(lm_w), C)
    np.testing.assert_array_equal(cs.offsets.numpy(), offsets)
    np.testing.assert_array_equal(cs.slots.numpy(), slots)


def test_camera_slots_of_an_all_empty_table():
    cs = camera_slots(torch.zeros((20, 4), dtype=torch.int32),
                      torch.zeros((20, 4)), 5)
    assert cs.offsets.tolist() == [0] * 6
    assert sorted(cs.slots.tolist()) == list(range(80))


@pytest.mark.parametrize("name", list(CASES))
def test_csr_sums_equal_plain_schur_scatter(name):
    """y[c] = sum over camera c's CSR slots s of W[s] z[s // kmax], summed
    in numpy, equals the plain K4b scatter and the plain K3 full apply."""
    C, lm_cam, lm_w = _table(name)
    L, kmax = lm_cam.shape
    rng = np.random.default_rng(kmax + L)
    W = rng.normal(0, 1, (L, kmax, 6, 3)).astype(np.float32)
    W[lm_w == 0] = 0.0
    z = rng.normal(0, 1, (L, 3)).astype(np.float32)
    offsets, slots = _numpy_csr(lm_cam, lm_w, C)
    Wf = W.reshape(-1, 6, 3).astype(np.float64)
    y = np.stack([np.einsum("sab,sb->a", Wf[slots[a:b]],
                            z[slots[a:b] // kmax].astype(np.float64))
                  for a, b in zip(offsets[:-1], offsets[1:])])
    lm_cam_t, W_t = to_t(lm_cam), to_t(W)
    ys = sp.schur_scatter_plain(lm_cam_t, W_t, to_t(z), C)
    np.testing.assert_allclose(ys.numpy(), y, rtol=1e-5, atol=1e-5)
    Vinv = np.eye(3, dtype=np.float32)[None].repeat(L, 0)
    z_f, y_f = sp.schur_apply_fused_plain(lm_cam_t, W_t, to_t(Vinv), to_t(z),
                                          None, C)
    np.testing.assert_array_equal(z_f.numpy(), z)
    np.testing.assert_allclose(y_f.numpy(), y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("huber,kmax", [(0.0, 6), (2.0, 4)])
def test_csr_sums_equal_plain_linearize_camera_blocks(huber, kmax):
    """U, g_cam and the cost, summed in numpy over each camera's CSR slots
    from per-slot blocks (the camera phase of K2 recomputes each slot's A,
    r and weight), equal the plain linearizer's."""
    C, L = 8, 60
    rng = np.random.default_rng(kmax)
    _, init, obs = ba_scene(rng, C, L, kmax + 1, noise_px=0.8,
                            outlier_p=0.1, dead_p=0.15)
    o = Observations(to_t(obs[0]).long(), to_t(obs[1]).long(), to_t(obs[2]),
                     to_t(obs[3]))
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(o, L, kmax)
    cam_free = torch.ones(C)
    cam_free[0] = 0.0
    lm_free = (torch.arange(L) % 5 != 0).float()
    K, R = to_t(TEST_K), exp_so3(to_t(init["rv"]))
    tv, X = to_t(init["tv"]), to_t(init["X"])
    _, _, _, U, g_cam, cost = lp.ba_linearize_plain(
        K, R, tv, X, lm_free, cam_free, lm_cam, lm_uv, lm_w, huber)

    cs = camera_slots(lm_cam, lm_w, C)
    n = int(cs.offsets[-1])
    s = cs.slots[:n].long()
    cam = lm_cam.reshape(-1)[s].long()
    slot_obs = Observations(cam, s // kmax, lm_uv.reshape(-1, 2)[s],
                            lm_w.reshape(-1)[s])
    r, A, _ = residuals_and_jacobians(K, R, tv, X, slot_obs)
    w = slot_obs.w * huber_weights(r, huber)
    A = (A * (w * cam_free[cam])[:, None, None]).double().numpy()
    rw = (r * w[:, None]).double().numpy()
    c_w = (w * (r * r).sum(-1)).double().numpy()
    off = cs.offsets.numpy()
    U_np = np.stack([np.einsum("sia,sib->ab", A[a:b], A[a:b])
                     for a, b in zip(off[:-1], off[1:])])
    g_np = np.stack([-np.einsum("sia,si->a", A[a:b], rw[a:b])
                     for a, b in zip(off[:-1], off[1:])])
    scale = float(np.abs(U_np).max())
    np.testing.assert_allclose(U.numpy(), U_np, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(g_cam.numpy(), g_np, rtol=1e-4,
                               atol=1e-6 * np.abs(g_np).max())
    np.testing.assert_allclose(float(cost), c_w.sum(), rtol=1e-5)
    assert (off[1:] - off[:-1]).min() >= 0 and n == int((lm_w != 0).sum())


def test_engine_defaults_to_the_card(tmp_path):
    """SfMEngine and load_state run on the card unless asked for the CPU;
    without a card the default raises instead of building a CPU engine."""
    cfg = SfMConfig(image_height=48, image_width=64, max_keypoints=64,
                    max_keyframes=4, max_landmarks=256)
    p = str(tmp_path / "s.npz")
    save_state(p, SfMEngine(np.eye(3), (48, 64), None, cfg,
                            device="cpu").state)
    if torch.cuda.is_available():
        assert SfMEngine(np.eye(3), (48, 64), None, cfg).device.type == "cuda"
        assert load_state(p, cfg).status.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SfMEngine(np.eye(3), (48, 64), None, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_state(p, cfg)
