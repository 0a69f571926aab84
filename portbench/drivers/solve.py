"""Offline refinement in a closed loop: ``run_large_ba`` again and again
from the same start, on a problem made on the device from the seed in
set-up.  ``tol`` 0 makes every solve run all its LM iterations; an
iteration fails when its solve raises or returns a value that is not
finite.

The comparison: once the window has closed, the outputs of a sample of
the window's solves (drawn from the seed, with the first and the last) are
held to one solve of the plain float64 reference (``reference/ba_lm.py``)
from the same start: its final cost, and each output's step from the start
against the reference's step.  The control (``ctx.control``) puts the
reference itself, in bfloat16, in the program's place: the configuration
states float32 with TF32 off, and TF32 changes nothing on this path (its
small batched products take no tensor core; measured on the card, the
reference in float32 with TF32 on reads as the program does), so the
nearest precision below that changes the arithmetic is bfloat16."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import ba_lm
from portbench.reference.ba_problem import ba_problem

# solves whose outputs are kept for the comparison, besides the first and
# the last: this many drawn from the first ``SAMPLE_RANGE``
SAMPLE, SAMPLE_RANGE = 6, 400


def _sync(ctx):
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()


def setup(ctx):
    from sfm_tpu_torch.ba.large import ObsTables, build_lm_tables_device
    from sfm_tpu_torch.ba.residuals import Observations
    c = ctx.config["problem"]
    s = ctx.config["solver"]
    # the configuration's float32 with TF32 off, as the engine runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pr = ba_problem(ctx.device, int(c["cameras"]), int(c["landmarks"]),
                    int(c["obs_per_landmark"]), ctx.seed)
    obs = Observations(pr["cam_idx"], pr["lm_idx"], pr["uv"], pr["w"])
    lm_cam, lm_uv, lm_w, dropped = build_lm_tables_device(
        obs, int(c["landmarks"]), pr["kmax"])
    tables = ObsTables(lm_cam, lm_uv, lm_w)
    kw = dict(iterations=int(s["lm_iterations"]),
              cg_iterations=int(s["cg_iterations"]), tol=float(s["tol"]),
              precond=s["precond"], huber_delta=float(s["huber_delta"]))

    if ctx.control:
        def solve():
            rv, tv, X, c0, c1, acc = ba_lm.solve(
                pr, iterations=kw["iterations"],
                cg_iterations=kw["cg_iterations"], dtype=torch.bfloat16)
            return rv, tv, X, torch.tensor(c1)
    else:
        from sfm_tpu_torch.ba.large import run_large_ba

        def solve():
            rv, tv, X, stats = run_large_ba(
                pr["K"], pr["rv"], pr["tv"], pr["X"], tables,
                cam_free=pr["cam_free"], lm_free=pr["lm_free"], **kw)
            return rv, tv, X, stats.final_cost

    solve()         # warm: every kernel and shape of the window
    _sync(ctx)
    ctx.log(f"problem: {int(c['cameras'])} cameras, {int(c['landmarks'])} "
            f"landmarks, {len(pr['w'])} observations, {int(dropped)} "
            f"dropped by the table")
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 2])
    sample = set(rng.choice(SAMPLE_RANGE, SAMPLE, replace=False).tolist())
    return dict(pr=pr, solve=solve, sample=sample | {0}, kw=kw)


def window(ctx, st):
    solve, iters = st["solve"], st["kw"]["iterations"]
    kept, costs, n, failed = {}, [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        try:
            with ctx.span("run_large_ba"):
                rv, tv, X, cost = solve()
        except Exception as e:  # noqa: BLE001 - counted, then reported
            ctx.log(f"solve {n} raised: {e!r}")
            failed += iters
            n += 1
            continue
        costs.append(cost)
        if n in st["sample"]:
            kept[n] = (rv, tv, X)
        last = (n, (rv, tv, X))
        n += 1
    _sync(ctx)
    window_s = time.perf_counter() - t0
    if costs:
        kept[last[0]] = last[1]
        finite = torch.isfinite(torch.stack([c.float().reshape(())
                                             for c in costs]).cpu())
        failed += iters * int((~finite).sum())
    st["kept"] = kept
    st["reported_cost"] = float(costs[-1]) if costs else float("nan")
    ctx.log(f"{n} solves, {n * iters} LM iterations in {window_s:.3f} s; "
            f"outputs of solves {sorted(kept)} kept for the comparison")
    return dict(window_s=window_s, lm_iterations=n * iters, solves=n,
                attempted=n * iters, failed=failed)


def finish(ctx, st):
    st["kept"] = {k: tuple(t.double() for t in v)
                  for k, v in st["kept"].items()}
    st.pop("solve")
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()


def judge(ctx, st):
    """``cost_gap``: the program's final cost, recomputed by the reference
    in float64 from its outputs, against the reference's own, over the
    reference's decrease from the start (near the optimum the cost itself
    is rounding, and a share of it swings);
    ``step_gap_rv`` / ``_tv`` / ``_X``: the distance between the program's
    output and the reference's, over the length of the reference's step
    from the start (each over all cameras or landmarks); each the widest
    over the kept solves."""
    pr, kw = st["pr"], st["kw"]
    rv_r, tv_r, X_r, _, c_ref, acc = ba_lm.solve(
        pr, iterations=kw["iterations"], cg_iterations=kw["cg_iterations"])
    P = ba_lm.Problem(pr, torch.float64)
    start = (pr["rv"].double(), pr["tv"].double(), pr["X"].double())
    ref = (rv_r, tv_r, X_r)
    out = dict(cost_gap=0.0, step_gap_rv=0.0, step_gap_tv=0.0, step_gap_X=0.0)
    if not st["kept"]:
        return {k: None for k in out}
    c0 = float(P.cost(*start))
    for outs in st["kept"].values():
        c = float(P.cost(*outs))
        out["cost_gap"] = max(out["cost_gap"], abs(c - c_ref) / (c0 - c_ref))
        for name, o, r, s in zip(("rv", "tv", "X"), outs, ref, start):
            gap = float(torch.linalg.norm(o - r) / torch.linalg.norm(r - s))
            out[f"step_gap_{name}"] = max(out[f"step_gap_{name}"], gap)
    ctx.log(f"reference: cost {c0:.6e} -> {c_ref:.6e} "
            f"({acc} steps taken); the program reported {st['reported_cost']:.6e}")
    return {k: (v if np.isfinite(v) else None) for k, v in out.items()}
