"""Global BA's spans and counters, its stats read in one copy, and one call
held to the plain float64 reference.

One port scan at TEST_CFG size on the CPU (the large mapping solver on a
local window, global BA every 3 keyframes at LONGSCAN's global BA settings:
kmax 16, Huber 7, 10 LM x 25 CG) gives an established map; each test runs
``SfMEngine.global_ba`` or ``run_global_ba`` from that state."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import TEST_CFG_KW, TEST_K

from portbench.reference import global_ba as reference
from sfm_tpu_torch.ba.core import observations_from_keyframes
from sfm_tpu_torch.ba.large import build_lm_tables_device
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import SfMEngine
from sfm_tpu_torch.engine.global_ba import run_global_ba
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.utils.profiling import RECORDER

GBA_KW = dict(TEST_CFG_KW, ba_solver="large", ba_kmax=6, ba_cg_iterations=12,
              ba_local_window=4, global_ba_every=3, global_ba_iterations=10,
              global_ba_cg_iterations=25, global_ba_kmax=16,
              global_ba_huber_delta=7.0)
N_FRAMES, CHUNK = 30, 6


@pytest.fixture(scope="module")
def engine():
    scene = SpriteScene(np.random.default_rng(3))
    rv, tv = strafe_trajectory(N_FRAMES)
    frames = np.stack([scene.render(TEST_K, rv[i], tv[i], 240, 320)
                       for i in range(N_FRAMES)]).astype(np.uint8)
    eng = SfMEngine(TEST_K, (240, 320), config=SfMConfig(**GBA_KW),
                    device="cpu", seed=0)
    for c in range(0, N_FRAMES, CHUNK):
        eng.add_frames(frames[c:c + CHUNK])
    assert int(eng.state.kfs.valid.sum()) >= 4
    return eng, eng.state, eng.config


@pytest.fixture
def eng(engine):
    """The module's engine at the scan's final state and configuration."""
    e, state, cfg = engine
    e.state, e.config = state, cfg
    return e


def _chain(span):
    out, p = [], span.parent
    while p is not None:
        out.append(p.name)
        p = p.parent
    return out


def test_the_stages_nest_inside_engine_global_ba(eng):
    with RECORDER.enabled() as tr:
        eng.global_ba()
    for name in ("global_ba.tables", "ba.solve", "global_ba.writeback"):
        (s,) = [s for s in tr.spans if s.name == name]
        assert s.parent.name == "engine.global_ba", name
    for name in ("ba.linearize", "ba.pcg", "ba.update"):
        assert tr.calls(name) > 0
        assert all("engine.global_ba" in _chain(s)
                   for s in tr.spans if s.name == name), name
    assert [s.name for s in tr.roots()] == ["engine.global_ba"]


@pytest.mark.parametrize("kmax", [16, 2])
def test_dropped_observations_are_counted(eng, kmax):
    eng.config = dataclasses.replace(eng.config, global_ba_kmax=kmax)
    with RECORDER.enabled() as tr:
        out = eng.global_ba()
    assert tr.counter("global_ba_dropped_obs") == int(out["dropped_obs"])
    assert tr.counter("global_ba_dropped_obs", "engine.global_ba") \
        == int(out["dropped_obs"])
    # two observations a landmark drop some; sixteen keep every one here
    assert (int(out["dropped_obs"]) > 0) == (kmax == 2)


def test_the_stats_come_in_one_read_and_as_before(eng):
    """The five stats in one copy: the values, dtypes and shapes of a read
    per field of ``run_global_ba``'s stats, from the same state."""
    state = eng.state
    _, stats = run_global_ba(eng.config, eng.cam, state)
    with RECORDER.enabled() as tr:
        out = eng.global_ba()
    assert tr.counter("host_reads", "engine.global_ba") == 1
    # the rest are the solver's, one an LM iteration
    assert tr.counter("host_reads") == 1 + tr.counter("host_reads",
                                                      "ba.solve")
    want = {k: v.cpu().numpy() for k, v in stats._asdict().items()}
    assert list(out) == list(want)
    for k, v in want.items():
        assert isinstance(out[k], np.ndarray) and out[k].shape == ()
        assert out[k].dtype == v.dtype and out[k] == v, k


def test_off_the_recorder_records_nothing(eng):
    state = eng.state
    with RECORDER.enabled() as tr:
        on = eng.global_ba()
    spans, counters = len(tr.spans), dict(tr.counters)
    eng.state = state
    off = eng.global_ba()
    assert RECORDER.trace() is tr
    assert len(tr.spans) == spans and tr.counters == counters
    assert tr.counter("host_reads") == counters[("engine.global_ba",
                                                 "host_reads")] \
        + tr.counter("host_reads", "ba.solve")
    for k in on:
        assert off[k] == on[k], k


def _problem(state, kmax):
    fr = state.kfs.frames
    return reference.problem(
        torch.as_tensor(TEST_K), state.kfs.valid, fr.frame_no, fr.rvec,
        fr.tvec, fr.landmark, fr.kp_valid, fr.xy, state.lms.xyz,
        state.lms.valid, kmax)


def test_the_reference_problem_holds_the_programs_tables(eng):
    """The reference rebuilds, from the keyframe store alone, the
    observations the program's tables keep, at a kmax that drops some."""
    state = eng.state
    for kmax in (16, 2):
        pr = _problem(state, kmax)
        obs = observations_from_keyframes(state.kfs, state.lms.valid)
        lm_cam, lm_uv, lm_w, dropped = build_lm_tables_device(
            obs, eng.config.max_landmarks, kmax)
        live = lm_w > 0
        lm = torch.arange(lm_w.shape[0])[:, None].expand_as(lm_w)[live]
        prog = sorted(zip(lm.tolist(), lm_cam[live].tolist(),
                          lm_uv[live].tolist()))
        ref = sorted(zip(pr["lm_idx"].tolist(), pr["cam_idx"].tolist(),
                         pr["uv"].tolist()))
        assert prog == ref and pr["dropped"] == int(dropped), kmax


@pytest.mark.parametrize("delta", [7.0, 0.5])
def test_global_ba_holds_against_the_float64_reference(eng, delta):
    """At LONGSCAN's Huber threshold, and at one that most residuals pass,
    where the large solver's cost (|r|^2 times the IRLS weight) is not
    Huber's rho."""
    cfg = eng.config = dataclasses.replace(eng.config,
                                           global_ba_huber_delta=delta)
    state = eng.state
    after, stats = run_global_ba(cfg, eng.cam, state)
    pr = _problem(state, cfg.global_ba_kmax)
    _, _, _, c0, c_ref, taken, n = reference.solve(
        pr, iterations=cfg.global_ba_iterations,
        cg_iterations=cfg.global_ba_cg_iterations, lam0=cfg.ba_lambda_init,
        lam_up=cfg.ba_lambda_up, lam_down=cfg.ba_lambda_down,
        huber_delta=cfg.global_ba_huber_delta, tol=cfg.ba_tol)
    P = reference.Problem(pr, torch.float64, cfg.global_ba_huber_delta)
    fr = after.kfs.frames
    c_prog = float(P.cost(fr.rvec.double(), fr.tvec.double(),
                          after.lms.xyz.double()))
    # the same LM decisions, and the same early stop, in both precisions
    assert taken == int(stats.accepted) and taken >= 1
    assert n <= cfg.global_ba_iterations
    # float32 against float64 over ten LM steps on ~500 observations: the
    # program's answer, costed in float64, reads 3.7e-6 of the start's cost
    # from the reference's (each float32 step rounds apart, and the ten do
    # not converge); 1e-4 leaves room for another summation order and stays
    # a hundredth of what the solve moves the cost (1.2e-2, checked below)
    assert abs(c_prog - c_ref) / c0 < 1e-4
    # the program's own float32 cost within float32 rounding of its sum
    assert float(stats.final_cost) == pytest.approx(c_prog, rel=1e-5)
    assert float(stats.initial_cost) == pytest.approx(c0, rel=1e-5)
    start = (state.kfs.frames.rvec.double(), state.kfs.frames.tvec.double(),
             state.lms.xyz.double())
    assert abs(float(P.cost(*start)) - c_ref) / c0 > 1e-2
