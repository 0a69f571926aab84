"""The harness's machinery on the CPU: the trace reduction, the roofline
arithmetic, the result line, a cell added as data alone, and the import
guard."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core
from portbench.reference.roofline import ba_bound, bound
from portbench.run import run_cell
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[2]


def test_device_busy_is_the_union_of_two_overlapping_streams():
    # stream A: [0, 4) and [10, 12); stream B overlaps A: [3, 6) and [11, 15)
    dev = [(0.0, 4.0, "a1"), (10.0, 12.0, "a2"), (3.0, 6.0, "b1"),
           (11.0, 15.0, "b2")]
    spans = [(0.0, 20.0, "window"), (6.5, 9.0, "add_frames"),
             (16.0, 19.0, "new_scan")]
    t = core.reduce_events(dev, spans)
    assert t["window_s"] == 20.0
    assert t["busy_s"] == pytest.approx(6.0 + 5.0)   # not 4+2+3+4 = 13
    assert t["device_time"] == {"a1": 4.0, "a2": 2.0, "b1": 3.0, "b2": 4.0}
    # idle: [6, 10) with add_frames open at its middle, [15, 20) new_scan
    assert t["idle_gaps"] == [["new_scan", 5.0], ["add_frames", 4.0]]
    assert core.idle_pct({"trace": t}) == pytest.approx(100 * 9 / 20)


def test_idle_gaps_sum_by_span():
    spans = [(0.0, 10.0, "window"), (0.0, 4.0, "add_frames"),
             (5.0, 8.5, "add_frames")]
    t = core.reduce_events([(1.0, 2.0, "k"), (3.0, 6.0, "k"),
                            (7.0, 8.0, "k")], spans)
    # gaps [0, 1) [2, 3) add_frames, [6, 7) add_frames, [8, 10) window
    assert t["idle_gaps"] == [["add_frames", 3.0], ["window", 2.0]]


def test_idle_gap_labels_take_the_innermost_span():
    spans = [(0.0, 10.0, "window"), (1.0, 9.0, "add_frames"),
             (2.0, 3.0, "new_scan")]
    assert core.label_of(2.5, spans) == "new_scan"
    assert core.label_of(5.0, spans) == "add_frames"
    assert core.label_of(0.5, spans) == "window"
    assert core.label_of(11.0, spans) == "outside"


def test_events_outside_the_window_are_clipped():
    t = core.reduce_events([(-1.0, 1.0, "k"), (9.0, 12.0, "k")],
                           [(0.0, 10.0, "window")])
    assert t["busy_s"] == pytest.approx(2.0)
    assert t["device_time"]["k"] == pytest.approx(2.0)


def test_kernel_files_from_profiler_names():
    f = core.kernel_file
    assert f("(anonymous namespace)::dense_kernel((anonymous namespace)"
             "::Operands, bool, int*, float*, float*)") == "match"
    assert f("(anonymous namespace)::patch_kernel(float const*, int, int, "
             "int, float const*, float const*, float*)") == "patches"
    assert f("void (anonymous namespace)::landmark_phase<0>(int const*, "
             "float const*, float const*)") == "schur"
    assert f("(anonymous namespace)::landmark_phase(float const*, float "
             "const*, float const*)") == "linearize"
    assert f("(anonymous namespace)::camera_phase(float const*, int const*, "
             "int const*, float*)") == "schur"
    assert f("(anonymous namespace)::camera_phase(float const*, float "
             "const*, float const*, float const*)") == "linearize"
    assert f("void at::native::vectorized_elementwise_kernel<4>(int)") \
        is None
    assert f("Memcpy DtoH (Device -> Pageable)") is None


def test_ba_bound_at_bench_ba():
    # 1000 cameras, 100000 landmarks, 6 live slots each: the kernel table's
    # bounds (17.74, 15.42, 15.41 us, by bytes)
    shape = (100_000, 6, 600_000, 1000)
    k2 = ba_bound("ba_linearize", *shape)
    assert k2["bytes"] == 59_420_040 and k2["bound_by"] == "bytes"
    assert k2["bound_ms"] == pytest.approx(59_420_040 / 3.35e12 * 1e3)
    assert ba_bound("schur_apply", *shape)["bytes"] == 51_648_000
    assert ba_bound("schur_gather", *shape)["bytes"] == 51_624_000
    assert bound(0, 67e9)["bound_ms"] == pytest.approx(1.0)
    assert bound(0, 67e9)["bound_by"] == "operations"


def _check_line(r, traced):
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(r) == keys + ["compared"]
    assert isinstance(r["correct"], bool)
    assert r["attempted"] > 0 and r["failed"] >= 0
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and core.is_number(m["value"])
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        for k in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][k]) <= 10
    for c in r["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line_schema(traced):
    r = run_cell("ba1k.solve", 2 ** 31 + 5, 0.5, traced, device="cpu",
                 overrides=small.BA)
    _check_line(r, traced)
    want = {"ba_iter_ms", "setup_s"} if not traced else set()
    assert set(r["metrics"]) == want   # the device metrics need a card
    assert r["correct"] is True


def test_a_cell_added_as_data_alone(tmp_path):
    """A new traffic file, limits file, metric reader and the entries for
    them, in a copy: nothing else is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "solve2.json").write_text(json.dumps(
        {"driver": "solve", "loop": "closed"}))
    shutil.copy(pb / "limits" / "ba1k.solve.json",
                pb / "limits" / "ba1k.solve2.json")
    (pb / "metrics" / "solves.ba2.py").write_text(
        "def read(record):\n    return record.get('solves')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ba1k.solve2", "config": "ba1k",
                               "traffic": "solve2", "chips": 1,
                               "why": "a copy"})
    for m in bench["end_to_end"]:
        if m["name"] == "ba_iter_ms":
            m["workloads"].append("ba1k.solve2")
    bench["per_layer"].append({"name": "solves.ba2", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "solver", "moves": "ba_iter_ms",
                               "workloads": ["ba1k.solve2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell("ba1k.solve2", 7, 0.5, 1, device="cpu",
                 overrides=small.BA, root=tmp_path)
    assert r["metrics"]["solves.ba2"]["value"] >= 1
    r = run_cell("ba1k.solve2", 7, 0.5, 0, device="cpu",
                 overrides=small.BA, root=tmp_path)
    assert "ba_iter_ms" in r["metrics"]


def test_forbidden_names_are_compared_whole():
    mods = {"sfm_tpu_torch": 1, "sfm_tpu_torch.engine": 1, "jaxtyping": 1,
            "sfm_tpu.engine": 1, "jax": 1, "flax.linen": 1, "numpy": 1}
    assert core.forbidden_loaded(mods) == ["flax.linen", "jax",
                                           "sfm_tpu.engine"]


def test_nothing_the_benchmark_runs_loads_jax():
    """Every portbench module, each driver's set-up imports and the port's
    entries the drivers call, in a fresh interpreter."""
    code = f"""
import importlib, sys
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
from portbench import core
for p in sorted(Path({str(ROOT / 'portbench')!r}).rglob('*.py')):
    rel = p.relative_to({str(ROOT)!r}).with_suffix('')
    if rel.parts[1] == 'metrics':
        core.load_module(p, 'm_' + p.stem.replace('.', '_'))
    elif rel.parts[1] != 'tests':
        importlib.import_module('.'.join(rel.parts))
for m in ('sfm_tpu_torch.engine', 'sfm_tpu_torch.ba.large',
          'sfm_tpu_torch.ba.residuals', 'sfm_tpu_torch.ba.core',
          'sfm_tpu_torch.config', 'sfm_tpu_torch.native',
          'sfm_tpu_torch.engine.mapping'):
    importlib.import_module(m)
print(core.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    """Without a CUDA card the command exits 1 and prints nothing on
    standard output."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ba1k.solve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 1 and out.stdout == ""
