"""The recorder on the card: every synchronising operation of a FLAGSHIP
scan is one the program counts, and a span shares the device trace's
clock.

Marked ``cuda``: without an NVIDIA GPU every test here skips with a
reason.  On a GPU machine run them with
``python -m pytest tests/test_torch_tracing_cuda.py -q --noconftest``
(``tests/conftest.py`` imports JAX, which a GPU machine need not have)."""

import json
import re
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

from sfm_tpu_torch import native
from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
from sfm_tpu_torch.engine import SfMEngine
from sfm_tpu_torch.entry import FLAGSHIP_K
from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu_torch.utils.profiling import RECORDER, device_trace

pytestmark = pytest.mark.cuda

# what torch.cuda.set_sync_debug_mode("warn") says of each synchronisation
SYNC = "called a synchronizing CUDA operation"
# the FLAGSHIP scan's chunks, as `cli scan --chunk 10` feeds them
CHUNK, N_FRAMES = 10, 40
K1 = re.compile(r"\b(dense_kernel|cells_kernel|init_keys|epilogue_kernel)\(")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    native.library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames(cuda):
    """bench.py's strafe past 260 sprites, 480x640 grey uint8."""
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260,
                        spread=2.4)
    rv, tv = strafe_trajectory(N_FRAMES, step=0.06, yaw_rate=0.001)
    return np.stack([np.clip(scene.render(FLAGSHIP_K, rv[i], tv[i], 480,
                                          640), 0, 255)
                     for i in range(N_FRAMES)]).astype(np.uint8)


def _engine(cuda):
    return SfMEngine(FLAGSHIP_K, (480, 640), config=SfMConfig(**FLAGSHIP),
                     device=cuda, seed=3)


def _flagged(call):
    """(``call()``, the synchronisations flagged while it ran, its trace):
    the sync debug mode's warnings, and the device-wide synchronizes,
    which it does not flag (``torch.cuda.graph`` makes one before the
    solver's PCG graph is captured)."""
    synced, real = [], torch.cuda.synchronize

    def synchronize(*a, **k):
        synced.append(1)
        return real(*a, **k)
    with warnings.catch_warnings(record=True) as caught, \
            RECORDER.enabled() as trace, \
            mock.patch.object(torch.cuda, "synchronize", synchronize):
        warnings.simplefilter("always")
        out = call()
    return (out, sum(SYNC in str(w.message) for w in caught) + len(synced),
            trace)


def _counted(trace):
    return {k: trace.counter(k)
            for k in ("host_reads", "implicit_sync", "uploads")}


@pytest.fixture
def sync_warnings(cuda):
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    yield
    torch.cuda.set_sync_debug_mode(mode)


def test_every_synchronisation_of_a_scan_is_counted(cuda, frames,
                                                    sync_warnings):
    """Chunk by chunk (the bootstrap chunk, tracking chunks and their
    deferred mapping passes), the synchronisations that the sync debug
    mode flags equal the program's host_reads + implicit_sync + uploads;
    so do the engine's construction's."""
    eng, flagged, trace = _flagged(lambda: _engine(cuda))
    assert flagged == sum(_counted(trace).values()) > 0
    passes = 0
    for c in range(0, N_FRAMES, CHUNK):
        out, flagged, trace = _flagged(
            lambda: eng.add_frames(frames[c:c + CHUNK]))
        counted = _counted(trace)
        assert counted["uploads"] == 1
        assert flagged == sum(counted.values()), (c, flagged, counted)
        passes += trace.calls("engine.mapping")
    assert int(out[-1]["status"]) == 1 and passes >= 1


def test_every_synchronisation_of_inline_mapping_is_counted(
        cuda, frames, sync_warnings):
    """add_frame, whose mapping pass runs inline on a slot held on the
    card: frame by frame, the same accounting."""
    eng = _engine(cuda)
    passes = 0
    for i in range(N_FRAMES // 2):
        _, flagged, trace = _flagged(lambda: eng.add_frame(frames[i]))
        counted = _counted(trace)
        assert flagged == sum(counted.values()), (i, flagged, counted)
        passes += trace.calls("engine.mapping")
    assert eng.status == 1 and passes >= 1


def test_k1_launched_in_track_match_lies_inside_the_span(cuda, frames,
                                                         tmp_path):
    """In device_trace's export, each track.match span holds the launch of
    the K1 kernels it asked for: the spans and the profiler's host events
    share one clock.  (Where the card's clock runs apart from the host's,
    as the offset printed shows, a kernel's own interval can open before
    the span that launched it.)"""
    eng = _engine(cuda)
    eng.add_frames(frames[:CHUNK])
    with device_trace(str(tmp_path)) as tr:
        eng.add_frames(frames[CHUNK:2 * CHUNK])
    events = json.loads(open(tr.path).read())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "program_span" and e["name"] == "track.match"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    k1 = [(launches[e["args"]["correlation"]]["ts"], e["ts"])
          for e in events if e.get("cat") == "kernel"
          and K1.search(e["name"])
          and e["args"].get("correlation") in launches]
    assert len(spans) == CHUNK and k1
    for s0, s1 in spans:
        assert [lt for lt, _ in k1 if s0 <= lt <= s1], (s0, s1)
    lag = sorted(kt - lt for lt, kt in k1)
    print(f"K1 kernel start - launch, us: min {lag[0]:.1f}, median "
          f"{lag[len(lag) // 2]:.1f}, max {lag[-1]:.1f} ({len(lag)})")
    names = {name for name, _ in tr.idle_by_span}
    assert names and names <= set(tr.trace.totals) | {"outside"}
