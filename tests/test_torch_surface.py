"""The port's public surface against ``sfm_tpu``'s.

The JAX package is read from its source with ``ast`` (nothing of it is
imported); the port is imported.  Three checks, one case each:

- ``names``: every public module-level name of a ``sfm_tpu`` module (and
  every public method of its public classes) is in the port's module of
  the same path, or in another module of the same subpackage;
- ``reexports``: every name an ``sfm_tpu`` ``__init__`` re-exports is an
  attribute of the port's package of the same path;
- ``keywords``: every parameter of a public function or method is
  accepted, by name, by its port counterpart.

A name the port replaces by design is listed below with its reason: the
list of ROADMAP "State of the port"."""

from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "sfm_tpu"

_TPU_K2 = ("K2's TPU tiling: the CUDA kernel takes the landmark-major "
           "table directly")
_TPU_K3 = ("K3's TPU tiling: the CUDA kernel takes the landmark-major "
           "table and its camera-major index directly")
_SMALLINV = ("a closed-form small inverse (a TPU workaround): torch.linalg "
             "and @")
_PYRAMID = ("the per-level pyramid path: descriptor.describe_canvas samples "
            "every level in one K5 call")
_JIT = ("a jit builder: step_frame, run_pending_mapping and SfMEngine run "
        "eagerly")
# (module path under sfm_tpu/, name) -> why the port has no counterpart
BY_DESIGN = {
    ("ba/core.py", "inv3_sym"): _SMALLINV,
    ("ba/large.py", "make_coupling_ops"): "SchurOperator runs K3 on the tables",
    ("ba/linearize_pallas.py", "LinTables"): _TPU_K2,
    ("ba/linearize_pallas.py", "build_lin_tables"): _TPU_K2,
    ("ba/linearize_pallas.py", "fused_blocks"): _TPU_K2,
    ("ba/linearize_pallas.py", "linearize_fused"): _TPU_K2,
    ("ba/linearize_pallas.py", "window_gather"): _TPU_K2,
    ("ba/linearize_pallas.py", "window_combine"): _TPU_K2,
    ("ba/linearize_pallas.py", "damped_vinv_tiled"):
        "damped_vinv, the same math in the port's layout",
    ("ba/residuals.py", "bmm_small"): _SMALLINV,
    ("ba/residuals.py", "bmv_small"): _SMALLINV,
    ("ba/residuals.py", "residuals_and_jacobians_gathered"):
        "folded into residuals_and_jacobians",
    ("ba/schur_pallas.py", "LANE"): _TPU_K3,
    ("ba/schur_pallas.py", "SchurPlan"): _TPU_K3,
    ("ba/schur_pallas.py", "pack_lm_tiles"): _TPU_K3,
    ("ba/schur_pallas.py", "unpack_lm_tiles"): _TPU_K3,
    ("ba/schur_pallas.py", "SchurOperator.from_packed"): _TPU_K3,
    ("ba/schur_pallas.py", "SchurOperator.set_vinv"): _TPU_K3,
    ("ba/schur_pallas.py", "SchurOperator.w_vinv_g_packed"): _TPU_K3,
    ("ba/schur_pallas.py", "SchurOperator.back_substitute_packed"): _TPU_K3,
    ("engine/state.py", "StepMetrics"):
        "the metrics dict: METRIC_FIELDS, the same fields, dtypes and order",
    ("engine/state.py", "zero_metrics"): "the metrics dict (METRIC_FIELDS)",
    ("engine/step.py", "build_step"): _JIT,
    ("engine/step.py", "build_video_step"): _JIT,
    ("engine/step.py", "build_mapping_step"): _JIT,
    ("features/descriptor.py", "bilinear"): _PYRAMID,
    ("features/descriptor.py", "describe"): _PYRAMID,
    ("features/descriptor.py", "extract_patches"): _PYRAMID,
    ("features/descriptor.py", "orientation"): _PYRAMID,
    ("features/descriptor.py", "orientation_from_patches"): _PYRAMID,
    ("features/match.py", "match_features"):
        "match_pallas.match_features_pallas, one entry through K1",
    ("features/match_pallas.py", "hamming_match_tiles"):
        "K1's TPU tiling: the CUDA kernel tiles itself",
    **{("geometry/smallinv.py", n): _SMALLINV
       for n in ("inv3x3", "inv6x6", "min_eigvec", "solve3", "solve6",
                 "solve12")},
}
_RNG = "a jax.random key: the port takes a torch.Generator (or the samples)"
_KNOB = ("a TPU route or precision knob: the port always runs its CUDA "
         "kernel, in f32")
_INTERPRET = "Pallas interpret mode: a CPU tensor runs the plain version"
# (module path, function, parameter) -> why the port does not take it
BY_DESIGN_KW = {
    **{("ransac.py", f, "key"): _RNG
       for f in ("sample_masked", "ransac_fundamental", "ransac_homography",
                 "ransac_pnp")},
    ("ba/core.py", "run_ba", "cam_major"):
        "the TPU's scatter-free assembly: the port sums in a fixed order "
        "on every layout",
    **{("ba/large.py", "run_large_ba", k): _KNOB
       for k in ("onehot_threshold", "pallas_matvec", "pallas_tile",
                 "pallas_precision", "pallas_interpret", "schur_plan",
                 "fused_linearize")},
    ("parallel/dist_large_ba.py", "build_dist_large_ba", "onehot_threshold"):
        _KNOB,
    ("engine/global_ba.py", "run_global_ba", "use_pallas"): _KNOB,
    **{("ba/schur_pallas.py", f, k): _TPU_K3
       for f, ks in (("schur_apply_fused", ("base_t", "cams_t", "wt",
                                            "vinv_t", "g_t", "kmax", "window",
                                            "pad_width", "precision",
                                            "interpret")),
                     ("schur_gather", ("cams_t", "wt", "vinv_t", "g_t",
                                       "kmax", "precision", "interpret")),
                     ("schur_scatter", ("cams_t", "wt", "z_t", "kmax",
                                        "n_cams_pad", "precision",
                                        "interpret")),
                     ("SchurOperator.__init__", ("W_l", "tile", "precision",
                                                 "interpret", "base",
                                                 "window", "pad_width")))
       for k in ks},
    ("features/patches_pallas.py", "extract_patches_pallas", "interpret"):
        _INTERPRET,
    ("features/match_pallas.py", "match_features_pallas", "interpret"):
        _INTERPRET,
    ("features/descriptor.py", "describe_canvas", "compute_dtype"): _KNOB,
    ("features/descriptor.py", "describe_canvas", "patch_int8"):
        "the int8 patch path (ROADMAP Queue 3): the port keeps f32 patches",
    ("features/detect.py", "build_canvas", "dtype"): _KNOB,
    ("features/detect.py", "detect", "compute_dtype"): _KNOB,
    ("features/detect.py", "detect", "approx_topk"):
        "the TPU's approximate top-k: the port takes the exact one",
}


def _jax_modules():
    return sorted(p.relative_to(JAX_ROOT).as_posix()
                  for p in JAX_ROOT.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _defs(rel: str):
    """{name: node} of the module's public top-level functions, classes and
    assignments, and {Class.method: node} of its public classes' public
    methods (and ``__init__``)."""
    tree = ast.parse((JAX_ROOT / rel).read_text())
    names, methods = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = node
        elif isinstance(node, ast.Assign):
            names.update((t.id, node) for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names[node.target.id] = node
        if isinstance(node, ast.ClassDef) and _public(node.name):
            methods.update((f"{node.name}.{m.name}", m) for m in node.body
                           if isinstance(m, ast.FunctionDef)
                           and (_public(m.name) or m.name == "__init__"))
    return {k: v for k, v in names.items() if _public(k)}, methods


def _module_name(rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["sfm_tpu_torch", *parts])


def _port_module(rel: str):
    try:
        return importlib.import_module(_module_name(rel))
    except ModuleNotFoundError:
        return None


def _subpackage_modules(rel: str):
    """The port's modules of the subpackage that holds ``rel``."""
    pkg = importlib.import_module(_module_name(
        str(Path(rel).parent / "__init__.py")))
    mods = [pkg]
    for info in pkgutil.iter_modules(pkg.__path__):
        if not info.ispkg:
            mods.append(importlib.import_module(f"{pkg.__name__}."
                                                f"{info.name}"))
    return mods


def _lookup(rel: str, dotted: str):
    """The port's counterpart of ``dotted`` (name or Class.method) of module
    ``rel``: from the same module, else from its subpackage; None if
    absent."""
    mods = [m for m in [_port_module(rel)] if m is not None]
    mods += _subpackage_modules(rel)
    head, _, tail = dotted.partition(".")
    for m in mods:
        obj = getattr(m, head, None)
        if obj is not None and tail:
            obj = inspect.getattr_static(obj, tail, None)
        if obj is not None:
            return obj
    return None


def _missing_names():
    out = []
    for rel in _jax_modules():
        names, methods = _defs(rel)
        for dotted in [*names, *methods]:
            cls = dotted.partition(".")[0]
            if (rel, dotted) in BY_DESIGN or (rel, cls) in BY_DESIGN:
                continue
            if _lookup(rel, dotted) is None:
                out.append(f"{rel}::{dotted}")
    return out


def _missing_reexports():
    out = []
    for rel in _jax_modules():
        if not rel.endswith("__init__.py"):
            continue
        pkg = _port_module(rel)
        tree = ast.parse((JAX_ROOT / rel).read_text())
        for node in tree.body:
            if not (isinstance(node, ast.ImportFrom) and node.level == 1):
                continue
            src = (Path(rel).parent / (node.module.replace(".", "/")
                                       + ".py")).as_posix()
            for alias in node.names:
                name = alias.asname or alias.name
                if (src, alias.name) in BY_DESIGN:
                    continue
                if pkg is None or not hasattr(pkg, name):
                    out.append(f"{rel}: {name} (from {src})")
    return out


def _params(node):
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _missing_keywords():
    out = []
    for rel in _jax_modules():
        names, methods = _defs(rel)
        funcs = {k: v for k, v in [*names.items(), *methods.items()]
                 if isinstance(v, ast.FunctionDef)}
        for dotted, node in funcs.items():
            if any(isinstance(d, ast.Name) and d.id == "property"
                   for d in node.decorator_list):
                continue
            port = _lookup(rel, dotted)
            if port is None:
                continue      # held by the names check
            if isinstance(port, (staticmethod, classmethod)):
                port = port.__func__
            params = inspect.signature(port).parameters
            if any(p.kind is p.VAR_KEYWORD for p in params.values()):
                continue
            for name in _params(node):
                if name not in params \
                        and (rel, dotted, name) not in BY_DESIGN_KW:
                    out.append(f"{rel}::{dotted}({name}=)")
    return out


@pytest.mark.parametrize("check", ["names", "reexports", "keywords"])
def test_port_surface_covers_the_reference(check):
    missing = {"names": _missing_names, "reexports": _missing_reexports,
               "keywords": _missing_keywords}[check]()
    assert not missing, (f"no counterpart in sfm_tpu_torch and not on the "
                         f"by-design list: {missing}")


def test_by_design_lists_name_what_the_reference_has():
    """Every by-design entry names a name or parameter the JAX package
    has, so the lists shrink when the reference does."""
    stale = []
    for rel, dotted in BY_DESIGN:
        names, methods = _defs(rel)
        if dotted not in names and dotted not in methods:
            stale.append((rel, dotted))
    for rel, dotted, kw in BY_DESIGN_KW:
        names, methods = _defs(rel)
        node = names.get(dotted, methods.get(dotted))
        if node is None or kw not in _params(node):
            stale.append((rel, dotted, kw))
    assert not stale, stale
