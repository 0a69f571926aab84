"""Loop closure through the port's engine against the JAX engine: a
closure with an injected probe (``probe_loop_closure``: close_loop, two
global BA calls, the log) from the same state, and the probe schedule of a
TEST-size scan (``add_frame`` and ``add_frames``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import (LOOP_FRAMES, LOOP_KW, TEST_K, jax_loop_scan,
                             jitted_jax_retriangulation, loop_state,
                             record_probes, to_np)

from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu.engine import SfMEngine as JaxEngine
from sfm_tpu.engine import loop as jloop
from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.engine import RUNNING, SfMEngine, state_from_numpy
from sfm_tpu_torch.np_geometry import rodrigues_np
from sfm_tpu_torch.synthetic import umeyama_ate


@pytest.fixture(scope="module")
def jax_scan():
    return jax_loop_scan()


@pytest.fixture(autouse=True)
def jitted_retriangulation(monkeypatch):
    jitted_jax_retriangulation(monkeypatch)


def test_engine_closes_a_loop_like_jax(jax_scan, capsys):
    """probe_loop_closure with an injected probe (the "loop" case's JAX
    probe) on the same loop state in both engines: close_loop, then two
    global BA calls (costs as in test_torch_global_ba.py, the first
    call's accepted steps, keyframe centres up to sim(3) within 1e-3 of
    the extent), then the log entry, the corrected span and the stderr
    line."""
    kw = dict(LOOP_KW, loop_min_age=2)
    tree, slot = loop_state(jax_scan["tree"])
    pj = jax.device_get(jax.jit(jloop.build_loop_probe(
        JaxConfig(**kw), jax_scan["cam"]))(jax.tree.map(jnp.asarray, tree),
                                           jnp.asarray(slot)))
    assert bool(pj.ok)
    ej = JaxEngine(TEST_K, (240, 320), None, JaxConfig(**kw))
    et = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**kw), device="cpu")
    ej.state = jax.tree.map(jnp.asarray, tree)
    et.state = state_from_numpy(tree, "cpu")
    stats = {}
    for name, eng in (("jax", ej), ("port", et)):
        eng._loop_probe = lambda state, s, _p=pj: _p
        calls, real = [], eng.global_ba
        eng.global_ba = lambda _c=calls, _r=real: _c.append(_r()) or _c[-1]
        assert eng.probe_loop_closure() is True
        stats[name] = calls
    assert "loop closure @ frame" in capsys.readouterr().err
    assert len(stats["port"]) == len(stats["jax"]) == 2
    for sj, st in zip(stats["jax"], stats["port"]):
        np.testing.assert_allclose(float(st["initial_cost"]),
                                   float(sj["initial_cost"]), rtol=1e-5)
        np.testing.assert_allclose(float(st["final_cost"]),
                                   float(sj["final_cost"]), rtol=1e-3)
        assert float(st["final_cost"]) <= float(st["initial_cost"])
    # the first call's steps; the second starts converged, where taking a
    # step is decided by the last bits of the cost
    assert int(stats["port"][0]["accepted"]) \
        == int(stats["jax"][0]["accepted"]) > 0
    assert et.loop_closures[0][0] == ej.loop_closures[0][0]
    assert et.loop_closures[0][2] == ej.loop_closures[0][2]
    np.testing.assert_allclose(et.loop_closures[0][1],
                               ej.loop_closures[0][1], rtol=1e-6)
    assert et._corrected_spans == ej._corrected_spans
    assert et._kfs_since_global_ba == 0
    sj = jax.device_get(ej.state)
    np.testing.assert_array_equal(to_np(et.state.kfs.frames.landmark),
                                  np.asarray(sj.kfs.frames.landmark))
    kv = np.asarray(sj.kfs.valid)
    fn = np.asarray(sj.kfs.frames.frame_no)[kv]

    def centres(rv, tv):
        return np.stack([-rodrigues_np(r).T @ t for r, t in zip(rv, tv)])
    c_t = centres(to_np(et.state.kfs.frames.rvec)[kv],
                  to_np(et.state.kfs.frames.tvec)[kv])
    c_j = centres(np.asarray(sj.kfs.frames.rvec)[kv],
                  np.asarray(sj.kfs.frames.tvec)[kv])
    order = np.argsort(fn)
    extent = np.linalg.norm(c_j[order[-1]] - c_j[order[0]])
    assert umeyama_ate(c_t, c_j) < 1e-3 * extent


def test_engine_probes_after_the_same_frames(jax_scan):
    """The port's engine on the JAX scan's frames (add_frame): the loop
    probe runs after the same frames, closes nothing (no landmark is old
    enough), and the scan stays RUNNING."""
    eng = SfMEngine(TEST_K, (240, 320), None, SfMConfig(**LOOP_KW),
                    device="cpu")
    frame = [0]
    probes = record_probes(eng, frame)
    for i, f in enumerate(jax_scan["frames"]):
        frame[0] = i
        eng.add_frame(f)
    assert eng.status == RUNNING
    assert probes == jax_scan["probes"] and len(probes) >= 2
    assert eng.loop_closures == [] and eng._corrected_spans == []


def test_add_frames_probes_on_the_schedule(jax_scan):
    """add_frames feeds the chunk's insertions to the probe schedule
    first: a probe per loop_detect_every insertions; a probe that finds
    no loop leaves the global BA schedule alone."""
    cfg = SfMConfig(**dict(LOOP_KW, global_ba_every=3))
    eng = SfMEngine(TEST_K, (240, 320), None, cfg, device="cpu")
    probes = record_probes(eng, [0])
    frames = np.stack(jax_scan["frames"])
    ms = []
    for i in range(0, LOOP_FRAMES, cfg.keyframe_time_lag):
        ms += eng.add_frames(frames[i:i + cfg.keyframe_time_lag])
    inserted = sum(int(m["keyframe_added"]) for m in ms)
    assert inserted >= 4
    assert len(probes) == inserted // 2
    assert eng._kfs_since_loop_probe == inserted % 2
    assert eng._kfs_since_global_ba == inserted % 3
