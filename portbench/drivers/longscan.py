"""One long handheld session in a closed loop: a single ``SfMEngine`` fed
the serpentine sweep's grey frames through ``add_frames`` in chunks of
``chunk`` (``cli scan --chunk 4``: each chunk defers its mapping to one
pass), with periodic global BA every ``global_ba_every`` keyframe
insertions, as a one-take video of a shelf, a wall or a room is mapped
offline.  The engine is seeded from ``--seed``; the frames are the same
for every seed.

Set-up renders the session's ``session_frames`` frames (in
``RENDER_WORKERS`` processes, first frames first, or here when it is 0)
once a checkout, into ``FRAME_CACHE`` keyed by what they are made from,
as the kernels are built once a checkout; later runs load them.  It
feeds the first ``warm_frames`` of them, which hold the bootstrap,
mapping passes and the first periodic global BA: every shape the window
runs is warm.  The window carries the same session on, a chunk at a
time, until its deadline or the session's last frame; there is no
restart.

Each global BA call's input (the keyframe store and the landmarks) and
output (the poses and positions) are kept for the judge by reference: the
call and every step after it build new tensors and write none of these
in place.

The control (``--control 1``) puts the plain reference in bfloat16 in
the place of the tracker's pose refinement (``scanlib``'s) and of the
mapping pass's and global BA's ``run_large_ba`` (``_ba_in_bf16`` here)."""

from __future__ import annotations

import hashlib
import importlib
import os
import resource
import time
from pathlib import Path

import numpy as np
import torch

from portbench.drivers import scanlib
from portbench.reference import global_ba, longscan, session_judge

# frames a render task makes, and the processes that render them in
# set-up (0: in this process)
RENDER_BLOCK = 32
RENDER_WORKERS = 4
# where rendered sessions are kept (None: rendered every run)
FRAME_CACHE = Path(__file__).resolve().parents[2] / "build" / "portbench" \
    / "frames"
_PROGRAM = {}


def _ba_in_bf16(K, rvec, tvec, xyz, tables, *, cam_free, lm_free,
                iterations, cg_iterations, lam0, lam_up, lam_down,
                huber_delta, tol, **_):
    """A ``run_large_ba`` call by the plain reference (``global_ba.solve``,
    the large solver's LM) in bfloat16, from the same tables, start and
    settings.  Only the tables' filled slots (weight > 0) are
    observations: an empty slot names no live landmark, its residual need
    not be finite, and its zero weight times a non-finite residual would
    make every cost NaN and every step refused."""
    from sfm_tpu_torch.ba.core import BAStats
    L, kmax = tables.lm_cam.shape
    w = tables.lm_w.reshape(-1)
    keep = w > 0
    pr = dict(K=K, rv=rvec, tv=tvec, X=xyz, cam_free=cam_free,
              lm_free=lm_free, cam_idx=tables.lm_cam.reshape(-1)[keep],
              lm_idx=torch.arange(L, device=xyz.device
                                  ).repeat_interleave(kmax)[keep],
              uv=tables.lm_uv.reshape(-1, 2)[keep], w=w[keep])
    rv, tv, X, c0, c1, acc, _ = global_ba.solve(
        pr, iterations=iterations, cg_iterations=cg_iterations, lam0=lam0,
        lam_up=lam_up, lam_down=lam_down, huber_delta=huber_delta, tol=tol,
        dtype=torch.bfloat16)
    f = lambda v: torch.tensor(v, device=xyz.device)  # noqa: E731
    return rv.float(), tv.float(), X.float(), BAStats(
        f(c0), f(c1), f(0.0), f(acc))


def _use_solvers(bf16: bool):
    """Global BA's ``run_large_ba``, or with the control ``_ba_in_bf16``
    in its place and in the mapping pass's (``scanlib.new_engine`` has
    set the mapping pass's to the program's or to its own control)."""
    gba = importlib.import_module("sfm_tpu_torch.engine.global_ba")
    _PROGRAM.setdefault("run_large_ba", gba.run_large_ba)
    gba.run_large_ba = _ba_in_bf16 if bf16 else _PROGRAM["run_large_ba"]
    if bf16:
        importlib.import_module("sfm_tpu_torch.engine.mapping"
                                ).run_large_ba = _ba_in_bf16


def _rendered(n, K, size):
    """(frames [n, H, W] uint8 to fill, ``ready(hi)`` that returns once
    frames [0, hi) are in it, ``close()``)."""
    frames = np.empty((n,) + tuple(size), np.uint8)
    blocks = [(lo, min(lo + RENDER_BLOCK, n)) for lo in range(0, n,
                                                              RENDER_BLOCK)]
    if RENDER_WORKERS == 0:
        for lo, hi in blocks:
            frames[lo:hi] = longscan.render(n, lo, hi, K, size)
        return frames, lambda hi: None, lambda: None
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(RENDER_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    todo = [(lo, hi, pool.submit(longscan.render, n, lo, hi, K, size))
            for lo, hi in blocks]

    def ready(upto):
        while todo and todo[0][0] < upto:
            lo, hi, fut = todo.pop(0)
            frames[lo:hi] = fut.result()

    def close():
        ready(n)
        pool.shutdown()
    return frames, ready, close


def _cache_path(n, K, size):
    """The file of the session's frames: named by the renderer's source and
    the numbers it is given, so a change to either renders anew."""
    h = hashlib.sha256()
    for f in ("longscan.py", "synthetic.py"):
        h.update((Path(longscan.__file__).parent / f).read_bytes())
    h.update(repr((n, np.asarray(K, np.float32).tolist(),
                   tuple(size))).encode())
    return FRAME_CACHE / f"{h.hexdigest()[:16]}.npy"


def _frames(path, n, K, size):
    """``_rendered``'s three, the frames loaded whole from ``path`` where a
    run has rendered them there; a run that renders them keeps them there
    (``path`` None: neither)."""
    if path and path.is_file():
        return np.load(path), lambda hi: None, lambda: None
    frames, ready, close = _rendered(n, K, size)
    if not path:
        return frames, ready, close

    def close_and_keep():
        close()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.save(f, frames)
        os.replace(tmp, path)
    return frames, ready, close_and_keep


def _host():
    """(this thread's CPU seconds, its involuntary context switches)."""
    r = resource.getrusage(resource.RUSAGE_THREAD)
    return r.ru_utime + r.ru_stime, r.ru_nivcsw


def inputs(state) -> dict:
    """What a global BA call starts from: the keyframe store and the
    landmarks (``session_judge.gba_gap``'s ``before``)."""
    fr = state.kfs.frames
    return dict(kf_valid=state.kfs.valid, kf_frame_no=fr.frame_no,
                kf_rvec=fr.rvec, kf_tvec=fr.tvec, kf_landmark=fr.landmark,
                kf_kp_valid=fr.kp_valid, kf_xy=fr.xy, lm_xyz=state.lms.xyz,
                lm_valid=state.lms.valid)


def outputs(state) -> dict:
    """What a global BA call returns: the poses and the positions."""
    return dict(rv=state.kfs.frames.rvec, tv=state.kfs.frames.tvec,
                X=state.lms.xyz)


def _keep_global_ba(eng, st):
    """Wrap ``eng.global_ba``: each call appends its input, output and
    stats to ``st["gba"]``."""
    real = eng.global_ba

    def global_ba():
        before = inputs(eng.state)
        out = real()
        st["gba"].append(dict(after_frame=st["fed"],
                              in_window=st["in_window"], before=before,
                              after=outputs(eng.state), stats=out))
        return out
    eng.global_ba = global_ba


def _feed(st, lo):
    """One chunk from frame ``lo``: its answers."""
    chunk = st["chunk"]
    st["fed"] = lo + chunk
    ans = scanlib.answers(st["engine"].add_frames(st["frames"][lo:lo + chunk]),
                          lo, lo // chunk)
    st["answers"] += ans
    return ans


def setup(ctx):
    from sfm_tpu_torch.config import SfMConfig
    K, size = scanlib.camera(ctx)
    n = int(ctx.config["session_frames"])
    chunk = int(ctx.traffic["chunk"])
    n -= n % chunk
    warm = min(int(ctx.traffic["warm_frames"]), n)
    warm -= warm % chunk
    scene, rv, tv = longscan.longscan_scene(n)
    path = FRAME_CACHE and _cache_path(n, K, size)
    cached = bool(path) and path.is_file()
    frames, ready, close = _frames(path, n, K, size)
    st = dict(frames=frames, gt=(rv, tv), scene=scene, n=n, chunk=chunk,
              cfg=SfMConfig(**ctx.config["engine"]), gba=[], answers=[],
              fed=0, in_window=False, engine=scanlib.new_engine(ctx, 0))
    _use_solvers(ctx.control == scanlib.CONTROL_BF16)
    _keep_global_ba(st["engine"], st)
    t0 = time.perf_counter()
    try:
        for lo in range(0, warm, chunk):
            ready(lo + chunk)
            _feed(st, lo)
        t1 = time.perf_counter()
    finally:
        close()
    ctx.log(f"set-up fed frames [0, {warm}) in {t1 - t0:.3f} s, then "
            f"waited {time.perf_counter() - t1:.3f} s for the rest of the "
            f"{n} frames ({'loaded' if cached else 'rendered'}); "
            f"{len(st['gba'])} global BA call(s) after frames "
            f"{[c['after_frame'] for c in st['gba']]}")
    if not st["gba"]:
        ctx.log(f"no periodic global BA in the first {warm} frames: the "
                "window is the first to run its shapes")
    return st


def window(ctx, st):
    chunk, n = st["chunk"], st["n"]
    lo = first = st["fed"]
    st["in_window"] = True
    attempted, failed, answers, chunk_s = 0, 0, [], []
    cpu0, switched0 = _host()
    load0 = os.getloadavg()[0]
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while lo < n and time.perf_counter() < deadline:
        attempted += chunk
        t = time.perf_counter()
        try:
            with ctx.span("add_frames"):
                answers += _feed(st, lo)
        except Exception as e:  # noqa: BLE001 - counted, then reported
            ctx.log(f"add_frames raised at frame {lo}: {e!r}")
            failed += chunk
            break
        chunk_s.append(time.perf_counter() - t)
        lo += chunk
    window_s = time.perf_counter() - t0
    cpu1, switched1 = _host()
    st["in_window"] = False
    if lo >= n and window_s < ctx.seconds:
        ctx.log(f"the session's {n} frames ran out "
                f"{ctx.seconds - window_s:.3f} s before the deadline")
    failed += scanlib.failed_frames(answers, 0)
    calls = [c for c in st["gba"] if c["in_window"]]
    kfs = sum(a["keyframe_added"] for a in answers)
    per = RENDER_BLOCK // chunk
    blocks = [round(1e3 * sum(chunk_s[i:i + per]) / (chunk * len(
        chunk_s[i:i + per])), 1) for i in range(0, len(chunk_s), per)]
    ctx.log(f"frames [{first}, {lo}) in {window_s:.3f} s; {kfs} keyframes, "
            f"{len(calls)} global BA call(s) after frames "
            f"{[c['after_frame'] for c in calls]}; ms a frame by "
            f"{per * chunk}-frame block: {blocks}")
    ctx.log(f"host in the window: the driving thread ran "
            f"{cpu1 - cpu0:.3f} s of {window_s:.3f} s, was switched out "
            f"{switched1 - switched0} times unasked; load average "
            f"{load0:.2f} -> {os.getloadavg()[0]:.2f}")
    return dict(window_s=window_s, frames=answers, attempted=attempted,
                failed=failed)


def finish(ctx, st):
    st["snap"] = scanlib.snapshot(st.pop("engine"))
    st["gba"] = [c for c in st["gba"] if c["in_window"]]


def judge(ctx, st):
    """``judge_session``'s numbers over the whole session, and
    ``gba_cost_gap``, the widest over the window's global BA calls (None
    where the window held none)."""
    K, _ = scanlib.camera(ctx)
    rv, tv = st["gt"]
    out = session_judge.judge_session(st["answers"], rv, tv, st["snap"],
                                      st["scene"], K)
    cfg = st["cfg"]
    settings = dict(kmax=cfg.global_ba_kmax or cfg.ba_kmax,
                    iterations=cfg.global_ba_iterations,
                    cg_iterations=cfg.global_ba_cg_iterations,
                    lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
                    lam_down=cfg.ba_lambda_down,
                    huber_delta=cfg.global_ba_huber_delta
                    or cfg.ba_huber_delta, tol=cfg.ba_tol)
    gaps = []
    for c in st["gba"]:
        Kt = torch.as_tensor(K, device=c["before"]["lm_xyz"].device)
        g = session_judge.gba_gap(Kt, c["before"], c["after"], settings)
        ctx.log(f"global BA after frame {c['after_frame']}: "
                f"{g['observations']} observations ({g['dropped']} dropped "
                "by the reference, "
                f"{int(c['stats']['dropped_obs'])} by the program); cost "
                f"{g['initial']:.6e} -> reference {g['reference']:.6e} "
                f"({g['taken']} steps in {g['iterations']} iterations), "
                f"program {g['program']:.6e} (it reported "
                f"{float(c['stats']['final_cost']):.6e}); gap {g['gap']}")
        gaps.append(g["gap"])
    out["gba_calls"] = len(gaps)
    out["gba_cost_gap"] = max(gaps) if gaps and None not in gaps else None
    return out
