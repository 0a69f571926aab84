"""The large solver's PCG as a captured CUDA graph (``ba/pcg_graph.py``),
on the CPU: the rule that engages it (the card and an unsharded problem
only), the eager loop everywhere else with the counters at 0, the cache's
key and its least-recently-used cap (on stand-in graphs), and the launch
counters' record of a capture.  The capture and its replays against the
eager loop bit for bit are card tests (``test_torch_kernels_cuda.py``)."""

import ctypes
from collections import OrderedDict

import numpy as np
import pytest
import torch

from torch_port_util import TEST_K, ba_scene, to_t

from sfm_tpu_torch import native
from sfm_tpu_torch.ba import large, pcg_graph
from sfm_tpu_torch.ba.residuals import Observations
from sfm_tpu_torch.utils.profiling import RECORDER

COUNTERS = ("pcg_graph_capture", "pcg_graph_replay")


def _problem(seed=5, C=6, L=80):
    rng = np.random.default_rng(seed)
    _, init, obs = ba_scene(rng, C, L, 5, noise_px=0.5, dead_p=0.05,
                            min_obs=2)
    o = Observations(to_t(obs[0]).long(), to_t(obs[1]).long(),
                     to_t(obs[2]), to_t(obs[3]))
    lm_cam, lm_uv, lm_w, _ = large.build_lm_tables_device(o, L, 5)
    args = (to_t(TEST_K), to_t(init["rv"]), to_t(init["tv"]),
            to_t(init["X"]), lm_cam, lm_uv, lm_w,
            (torch.arange(C) > 0).float(), torch.ones(L))
    kw = dict(iterations=4, cg_iterations=10, lam0=1e-3, lam_up=4.0,
              lam_down=2.0, huber_delta=2.0, tol=0.0)
    return args, kw


@pytest.mark.parametrize("device,sharded,wanted", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False),
    ("cpu", True, False)])
def test_graph_path_only_on_the_card_for_an_unsharded_problem(
        device, sharded, wanted):
    reduce = (lambda *ts: ts) if sharded else large._local
    assert large._pcg_graph_wanted(torch.device(device), reduce) is wanted


def _refuse_graphs(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("the graph path was requested")
    monkeypatch.setattr(pcg_graph, "run", refused)


@pytest.mark.parametrize("precond", ["jacobi_u", "schur_diag"])
def test_cpu_and_sharded_solves_run_the_eager_loop(monkeypatch, precond):
    """On CPU tensors, with the whole problem's reduce and with another
    (the identity, as a sharded solve's all-reduce over one shard), the
    graph path is never requested, the counters stay 0, ``_pcg`` runs
    once an LM iteration, and both solves give the same bits."""
    _refuse_graphs(monkeypatch)
    calls, real = [], large._pcg
    monkeypatch.setattr(large, "_pcg", lambda *a: calls.append(1) or real(*a))
    args, kw = _problem()
    with RECORDER.enabled() as trace:
        whole = large._large_lm(*args, **kw, precond=precond)
        shard = large._large_lm(*args, **kw, precond=precond,
                                reduce=lambda *ts: ts)
    assert all(trace.counter(k) == 0 for k in COUNTERS)
    assert len(calls) == 2 * kw["iterations"]
    for a, b in zip(whole[:3] + whole[3][:4], shard[:3] + shard[3][:4]):
        assert torch.equal(a, b)
    assert float(whole[3].final_cost) < float(whole[3].initial_cost)


def _key(C=1000, L=100000, kmax=6, iterations=25, dtype=torch.float32):
    return large._pcg_key(torch.zeros((C, 6, 6), dtype=dtype),
                          torch.zeros((L, kmax, 6, 3), dtype=dtype),
                          iterations)


@pytest.mark.parametrize("other", [
    dict(C=999), dict(L=99999), dict(kmax=8), dict(iterations=12),
    dict(dtype=torch.float64)])
def test_the_cache_key_separates_shapes_and_trip_counts(other):
    assert _key() == _key()
    assert _key(**other) != _key()


class _StandIn:
    """A graph's place in the cache, on the CPU: ``fn`` "captured" (kept),
    replayed by calling it."""
    released = []

    def __init__(self, fn, inputs):
        self.fn = fn

    def replay(self, inputs):
        return self.fn(**inputs)

    def release(self):
        _StandIn.released.append(self)


@pytest.fixture
def stand_ins(monkeypatch):
    monkeypatch.setattr(pcg_graph, "_Graph", _StandIn)
    monkeypatch.setattr(pcg_graph, "_GRAPHS", OrderedDict())
    _StandIn.released = []
    return pcg_graph._GRAPHS


def test_the_cache_keeps_the_least_recently_used_cap(stand_ins):
    """A key's first call runs ``fn`` and captures, later calls replay;
    past ``CAPACITY`` keys the least recently used graph is released and
    dropped, a replay counting as a use."""
    cap = pcg_graph.CAPACITY
    fn = lambda x: x + 1  # noqa: E731
    x = torch.arange(3.0)
    with RECORDER.enabled() as trace:
        for k in range(cap):
            assert torch.equal(pcg_graph.run(("k", k), fn, dict(x=x)), x + 1)
        first = stand_ins[("k", 0)]
        pcg_graph.run(("k", 0), fn, dict(x=x))          # used again
        pcg_graph.run(("k", cap), fn, dict(x=x))        # evicts ("k", 1)
    assert list(stand_ins) == [("k", k) for k in [*range(2, cap), 0, cap]]
    assert stand_ins[("k", 0)] is first
    assert len(_StandIn.released) == 1
    assert trace.counter("pcg_graph_capture") == cap + 1
    assert trace.counter("pcg_graph_replay") == 1
    # one sync a capture, one an eviction
    assert trace.counter("implicit_sync") == cap + 2


def test_a_capture_records_launches_and_a_replay_counts_them(monkeypatch):
    """A launch inside ``captured_launches`` is recorded, not counted; each
    ``count_replay`` adds the record on the replay's stream."""
    monkeypatch.setattr(native, "LAUNCHES", dict.fromkeys(native.LAUNCHES, 0))
    monkeypatch.setattr(native, "STREAM_LAUNCHES", {})
    side, ours = ctypes.c_void_p(7), ctypes.c_void_p(9)
    with native.captured_launches() as rec:
        for _ in range(3):
            native.count_launch("schur_apply", side)
    assert rec == {"schur_apply": 3}
    assert native.LAUNCHES["schur_apply"] == 0 and not native.STREAM_LAUNCHES
    native.count_launch("schur_apply", ours)    # counted again after it
    for _ in range(2):
        native.count_replay(rec, ours)
    assert native.LAUNCHES["schur_apply"] == 7
    assert native.STREAM_LAUNCHES == {("schur_apply", 9): 7}
