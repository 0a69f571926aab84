"""The benchmark of sfm_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up reads the cell's entry in BENCHMARK.json and finds its
configuration, traffic mix, driver and limits by name, makes the inputs
from the seed, builds or loads the kernels and warms the cell's own
shapes.  The window drives the port for ``--seconds`` (``--trace 1``:
under ``torch.profiler``).  Then the program's outputs are compared with
the plain reference, and the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` when traced, and last ``compared``, each number of the
comparison beside its limit (also the last lines of standard error).

Without a CUDA card, or with fewer than the cell asks for, it exits 1 and
prints no result; so it does when a module of JAX or of the JAX package
is loaded once the window has closed.  ``--control 1`` runs the cell's control
in the program's place: the comparison has to fail it."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Context:
    """What a driver sees of the run."""

    def __init__(self, cell, seed, seconds, traced, device, control):
        from portbench import core
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds = int(seed), float(seconds)
        self.device, self.control = device, int(control)
        self.span = core.Spans(traced)
        self.log = lambda msg: log(f"[{cell.name}] {msg}")


def run_cell(workload, seed, seconds, trace, *, device="cuda",
             control=False, overrides=None, root=ROOT, t_start=None):
    """One run; returns the result object.  ``overrides`` ({"config": {...},
    "traffic": {...}, "engine": {...}}) shrink a cell for the CPU tests."""
    import torch
    from portbench import core
    t_start = T_START if t_start is None else t_start
    cell = core.Cell(workload, root)
    for key in ("config", "traffic"):
        getattr(cell, key).update((overrides or {}).get(key, {}))
    if overrides and "engine" in overrides:
        cell.config["engine"] = dict(cell.config["engine"],
                                     **overrides["engine"])
    traced = bool(int(trace))
    ctx = Context(cell, seed, seconds, traced, device, control)
    on_card = torch.device(device).type == "cuda"
    drv = cell.driver()

    st = drv.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    launches0 = dict(_launches())
    setup_s = time.perf_counter() - t_start
    prof = core.start_profiler(on_card) if traced else None
    with ctx.span("window"):
        rec = drv.window(ctx, st)
        if on_card:
            torch.cuda.synchronize()
    trace_rec = None
    if prof is not None:
        t0 = time.perf_counter()
        prof.stop()
        t1 = time.perf_counter()
        trace_rec = core.reduce_events(*core.trace_events(prof))
        del prof
        ctx.log(f"trace read: the profiler stopped in {t1 - t0:.1f} s, its "
                f"events reduced in {time.perf_counter() - t1:.1f} s")
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drv.finish(ctx, st)
    values = drv.judge(ctx, st)

    record = dict(rec, setup_s=setup_s, trace=trace_rec, launches=launches,
                  config=cell.config, traffic=cell.traffic)
    metrics = {}
    for m in cell.metrics(traced):
        v = cell.reader(m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    compared = {k: {"value": values.get(k), "limit": lim}
                for k, lim in cell.limits.items()}
    correct = all(core.is_number(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit_w": core.power_limit_w() if on_card
                   else None}
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": device_info}
    if trace_rec is not None:
        device_info.update(busy_s=trace_rec["busy_s"],
                           window_s=trace_rec["window_s"])
        result["breakdown"] = core.breakdown(trace_rec)
    result["compared"] = compared
    log(f"[{workload}] launches in the window: "
        f"{ {k: v for k, v in launches.items() if v} }; set-up "
        f"{setup_s:.3f} s")
    for k, v in values.items():
        if k not in compared:
            log(f"read, not compared, {k}: {v}")
    for k, c in compared.items():
        log(f"compared {k}: {c['value']} limit {c['limit']}")
    return result


def _launches():
    """The port's launch counters (its wrappers count every launch)."""
    from sfm_tpu_torch import native
    return native.LAUNCHES


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    from portbench import core
    cell = core.Cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    result = run_cell(a.workload, a.seed, a.seconds, a.trace,
                      control=a.control)
    bad = core.forbidden_loaded()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
