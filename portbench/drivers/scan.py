"""Offline scans in a closed loop: one scan at a time, each through a new
``SfMEngine`` and ``add_frames`` in chunks of ``chunk`` frames (deferred
mapping: one mapping pass after a chunk that inserted a keyframe), as
``cli scan --chunk 10`` feeds a recorded video.  When a scan ends the next
one starts; the window stops at the first chunk boundary past its end."""

from __future__ import annotations

import time

from portbench.drivers import scanlib


def setup(ctx):
    pool, gt = scanlib.scene_pool(ctx, rgb=bool(ctx.traffic["rgb"]))
    chunk = int(ctx.traffic["chunk"])
    # warm every shape the window uses: a bootstrap chunk, tracking chunks
    # with keyframes, their mapping passes
    eng = scanlib.new_engine(ctx, -1)
    frames = pool[0][1]
    for c in range(0, int(ctx.traffic["warm_frames"]), chunk):
        eng.add_frames(frames[c:c + chunk])
    return dict(pool=pool, gt=gt, chunk=chunk)


def window(ctx, st):
    pool, chunk = st["pool"], st["chunk"]
    n = int(ctx.traffic["frames_per_scan"])
    nth = scanlib.scan_order(ctx, len(pool))
    scans, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    i = 0
    while time.perf_counter() < deadline:
        k = nth(i)
        with ctx.span("new_scan"):
            eng = scanlib.new_engine(ctx, i)
        scan = dict(engine=eng, scene=pool[k][0], scene_k=k, frames=[],
                    partial=True,
                    started=time.perf_counter())
        scans.append(scan)
        for c in range(0, n, chunk):
            if time.perf_counter() >= deadline:
                break
            attempted += chunk
            try:
                with ctx.span("add_frames"):
                    outs = eng.add_frames(pool[k][1][c:c + chunk])
            except Exception as e:  # noqa: BLE001 - counted, then reported
                ctx.log(f"add_frames raised on scan {i}, frame {c}: {e!r}")
                failed += chunk
                break
            scan["frames"] += scanlib.answers(outs, c, c // chunk)
        else:
            scan["partial"] = False
        scan["seconds"] = time.perf_counter() - scan["started"]
        failed += scanlib.failed_frames(scan["frames"], chunk)
        i += 1
    window_s = time.perf_counter() - t0
    st["scans"] = scans
    frames = [f for s in scans for f in s["frames"]]
    kfs = sum(f["keyframe_added"] for f in frames)
    ctx.log(f"{len(scans)} scans ({sum(not s['partial'] for s in scans)} "
            f"whole), {len(frames)} frames in {window_s:.3f} s; "
            f"{kfs} keyframes, so {kfs} mapping passes; seconds by scan "
            f"(scene): " + ", ".join(f"{s['seconds']:.2f} ({s['scene_k']})"
                                      for s in scans))
    return dict(window_s=window_s, frames=frames, attempted=attempted,
                failed=failed)


def finish(ctx, st):
    for s in st["scans"]:
        s["snap"] = scanlib.snapshot(s.pop("engine"))


def judge(ctx, st):
    return scanlib.judge(ctx, st["scans"], st["gt"])
