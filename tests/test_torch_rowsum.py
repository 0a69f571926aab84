"""The fixed-order sums (utils/rowsum.py) that the dense and cg BA solvers
and the landmark colour sums use in place of ``index_add_``, and the lazy
builds under threads.

On the CPU a fixed-order sum equals ``index_add_`` bit for bit (the same
order); the assembly equals the one written with ``index_add_`` (the
solvers' form before the sums were fixed) and an f64 assembly within f32
rounding.  Two threads that reach the C++ runtime's first use together
build it once and load the same library."""

import threading

import numpy as np
import pytest
import torch

from torch_port_util import ba_scene, to_t, TEST_K

from sfm_tpu_torch.ba import core
from sfm_tpu_torch.ba.residuals import (Observations, huber_weights,
                                        residuals_and_jacobians, robust_cost)
from sfm_tpu_torch.geometry.rotations import exp_so3
from sfm_tpu_torch.io import runtime
from sfm_tpu_torch.mapstore import add_descriptors, empty_landmarks
from sfm_tpu_torch.utils.rowsum import RowSum, add_rows


@pytest.mark.parametrize("shape", [(), (3,), (6, 3)])
def test_rowsum_equals_index_add(shape):
    rng = np.random.default_rng(len(shape))
    n, m = 37, 2000
    idx = to_t(rng.integers(0, n - 5, m))      # some targets get nothing
    src = to_t(rng.normal(size=(m,) + shape).astype(np.float32) * 1e3)
    ref = torch.zeros((n,) + shape).index_add_(0, idx, src)
    assert torch.equal(RowSum(idx, n)(src), ref)
    base = to_t(rng.normal(size=(n,) + shape).astype(np.float32))
    assert torch.equal(add_rows(base, idx, src), base.index_add(0, idx, src))
    # no rows at all
    empty = RowSum(idx[:0], n)(src[:0])
    assert empty.shape == (n,) + shape and not empty.any()


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    _, init, obs = ba_scene(rng, 6, 120, 4, noise_px=0.7, outlier_p=0.05,
                            dead_p=0.1)
    o = Observations(*(to_t(a) for a in obs))
    o = o._replace(cam_idx=o.cam_idx.long(), lm_idx=o.lm_idx.long())
    return (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
            to_t(init["X"]), o)


def _assemble_index_add(K, rvec, tvec, xyz, obs, cam_free, lm_free, huber):
    """The dense solver's assembly written with ``index_add_``."""
    C, L = rvec.shape[0], xyz.shape[0]
    r, A, B = residuals_and_jacobians(K, exp_so3(rvec), tvec, xyz, obs)
    w = obs.w * huber_weights(r, huber)
    A = A * (w * cam_free[obs.cam_idx])[:, None, None]
    B = B * (w * lm_free[obs.lm_idx])[:, None, None]
    rw = r * w[:, None]
    At, Bt = A.transpose(1, 2), B.transpose(1, 2)
    U = xyz.new_zeros((C, 6, 6)).index_add_(0, obs.cam_idx, At @ A)
    V = xyz.new_zeros((L, 3, 3)).index_add_(0, obs.lm_idx, Bt @ B)
    g_cam = xyz.new_zeros((C, 6)).index_add_(
        0, obs.cam_idx, -(At @ rw[:, :, None])[..., 0])
    g_lm = xyz.new_zeros((L, 3)).index_add_(
        0, obs.lm_idx, -(Bt @ rw[:, :, None])[..., 0])
    W = xyz.new_zeros((C * L, 6, 3)).index_add_(
        0, obs.cam_idx * L + obs.lm_idx, At @ B).reshape(C, L, 6, 3)
    return (U, V, W, g_cam, g_lm), robust_cost(r, obs.w, huber)


def _assemble(K, rv, tv, X, obs, huber=2.0):
    C, L = rv.shape[0], X.shape[0]
    cam_free = torch.ones(C, dtype=X.dtype)
    cam_free[0] = 0
    lm_free = torch.ones(L, dtype=X.dtype)
    sums = core._Sums.of(obs, C, L)
    pair = RowSum(obs.cam_idx * L + obs.lm_idx, C * L)
    return (core._assemble(K, rv, tv, X, obs, cam_free, lm_free, huber, sums,
                           pair),
            _assemble_index_add(K, rv, tv, X, obs, cam_free, lm_free, huber))


def test_assembly_equals_index_add_and_f64():
    K, rv, tv, X, obs = _problem()
    (blocks, cost), (ref, ref_cost) = _assemble(K, rv, tv, X, obs)
    assert torch.equal(cost, ref_cost)
    for a, b in zip(blocks, ref):
        assert torch.equal(a, b)
    obs64 = obs._replace(uv=obs.uv.double(), w=obs.w.double())
    (b64, _), _ = _assemble(K.double(), rv.double(), tv.double(), X.double(),
                            obs64)
    for name, a, b in zip(("U", "V", "W", "g_cam", "g_lm"), blocks, b64):
        # f32 rounding of sums of up to a few hundred terms
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err < 1e-5, (name, err)


@pytest.mark.parametrize("solver", ["run_ba", "run_ba_cg"])
def test_solvers_repeat_bit_for_bit(solver):
    K, rv, tv, X, obs = _problem(1)
    cam_free = torch.ones(rv.shape[0], dtype=torch.bool)
    cam_free[0] = False
    kw = dict(cam_free=cam_free, lm_free=torch.ones(X.shape[0],
                                                    dtype=torch.bool),
              iterations=6, huber_delta=2.0)
    runs = [getattr(core, solver)(K, rv, tv, X, obs, **kw) for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert float(runs[0][3].final_cost) < float(runs[0][3].initial_cost)


def test_colour_sums_equal_index_add():
    rng = np.random.default_rng(4)
    lms = empty_landmarks(64, 512, "cpu")
    lms = lms.replace(color_sum=to_t(rng.uniform(0, 900, (64, 3)).astype(
        np.float32)))
    ids = to_t(rng.integers(-1, 64, 300).astype(np.int32))
    desc = to_t(rng.integers(-2 ** 31, 2 ** 31, (300, 16)).astype(np.int32))
    cols = to_t(rng.uniform(0, 255, (300, 3)).astype(np.float32))
    out = add_descriptors(lms, ids, desc, colors=cols)
    ok = ids >= 0
    ref = lms.color_sum.index_add(0, torch.where(ok, ids, 0).long(),
                                  cols * ok[:, None])
    assert torch.equal(out.color_sum, ref)


def test_runtime_builds_once_under_threads(tmp_path, monkeypatch):
    """Two threads reach the C++ runtime's first use together, with no
    library built: one builds, the other waits and loads the same one."""
    monkeypatch.setattr(runtime, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(runtime, "_lib", None)
    builds, real = [], runtime.build

    def counted():
        builds.append(threading.get_ident())
        return real()
    monkeypatch.setattr(runtime, "build", counted)
    start = threading.Barrier(2)
    got, errors = [], []

    def first_use():
        try:
            start.wait()
            got.append(runtime.library())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(builds) == 1
    assert got[0] is got[1]
    libs = sorted(p.name for p in tmp_path.rglob("*.so"))
    assert libs == ["libsfm_native.so"]
    xyz = np.ones((4, 3), np.float32)
    got[0].pc_center(xyz.ctypes.data_as(runtime._FP), 4)
    assert not xyz.any()
