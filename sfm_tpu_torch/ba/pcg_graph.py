"""The large solver's PCG on the card as the replay of one CUDA graph.

``large._pcg`` runs a fixed trip count with no host read: per CG iteration
about fifteen torch ops on [C, 6] vectors and one K3 full apply, each a
launch the host makes.  At 1000 cameras that is ~0.4 ms of host time an
iteration against ~0.07 ms of device work, and the card waits.  ``run``
plays the same loop (the same kernels and ops, in the same order, on the
same inputs) as one ``torch.cuda.CUDAGraph``: captured once per key and
replayed once per LM iteration.

The cache holds ``CAPACITY`` graphs in this module, across solves and
engines, least recently used evicted.  The caller's key names everything
the capture fixed (``large._pcg_key``: device, dtype, C, L, kmax and the
trip count); the preconditioner is an input, so both share a graph.

A call on a key not cached runs the loop eagerly on the caller's stream:
that is its answer, and the warm-up the capture needs (the kernels loaded,
cuBLAS's handle made), with every launch counted on the stream that asked
for it.  Then the loop is captured on a side stream of the device, with
``capture_error_mode="thread_local"``: the pipeline's mapping worker
solves on its own thread while the main thread tracks.  A later call
copies its inputs into the graph's static buffers (laid out as the
inputs were at capture), replays the graph on the caller's current stream
and returns a copy of the static output, so no caller holds a view of it.
One lock serialises the calls' host side, and a replay waits on the event
of the one before, so a replay on another stream never overwrites buffers
that a replay still reads.

Counters: ``pcg_graph_capture`` (one a capture) and ``pcg_graph_replay``
(one a replay) in the recorder, and the capture's device synchronisation
in ``implicit_sync``.  The capture launches nothing; the K3 launches it
recorded are added to ``native.LAUNCHES`` and ``STREAM_LAUNCHES`` on every
replay, on the replay's stream.  A replay reads nothing on the host."""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from .. import native
from ..utils.profiling import count

# graphs kept; each holds its static inputs (at 1000 cameras and 100000
# landmarks, ~50 MB) and its private memory pool
CAPACITY = 4

_LOCK = threading.Lock()
_GRAPHS: "OrderedDict[tuple, _Graph]" = OrderedDict()
_SIDE_STREAMS = {}   # device -> the stream captures run on


class _Graph:
    """``fn`` captured on static copies of ``inputs``' layouts: the graph,
    its output, the kernel launches it holds, and the event its last
    replay recorded."""

    def __init__(self, fn, inputs: dict):
        dev = next(iter(inputs.values())).device
        self.static = {k: torch.empty_strided(v.shape, v.stride(),
                                              dtype=v.dtype, device=dev)
                       for k, v in inputs.items()}
        side = _SIDE_STREAMS.get(dev)
        if side is None:
            side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        with native.captured_launches() as self.launches:
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = fn(**self.static)
        self.done = torch.cuda.Event()

    def replay(self, inputs: dict) -> torch.Tensor:
        stream = torch.cuda.current_stream(self.out.device)
        stream.wait_event(self.done)
        for k, v in inputs.items():
            self.static[k].copy_(v)
        self.graph.replay()
        out = self.out.clone()
        self.done.record(stream)
        native.count_replay(self.launches,
                            native.stream_handle(self.out.device))
        return out

    def release(self) -> None:
        """Wait for the last replay, so that nothing in flight reads the
        buffers this graph gives back."""
        self.done.synchronize()


def run(key: tuple, fn, inputs: dict) -> torch.Tensor:
    """``fn(**inputs)``: a function of CUDA tensors with fixed shapes, no
    host read and no branch on their values, returning one tensor.  Played
    as the replay of the graph cached under ``key``; a key not cached runs
    ``fn`` eagerly and captures it for the next call."""
    with _LOCK:
        graph = _GRAPHS.get(key)
        if graph is not None:
            _GRAPHS.move_to_end(key)
            count("pcg_graph_replay")
            return graph.replay(inputs)
        out = fn(**inputs)
        graph = _Graph(fn, inputs)
        count("pcg_graph_capture")
        count("implicit_sync")   # torch.cuda.graph syncs the device first
        _GRAPHS[key] = graph
        while len(_GRAPHS) > CAPACITY:
            _GRAPHS.popitem(last=False)[1].release()
            count("implicit_sync")
        return out

