"""GPU smoke run of the PyTorch/CUDA port (sfm_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --calls DIR   # K1 / K5 call times of DIR's package

1. requires CUDA (exits non-zero without a card) and prints the card's
   name and power limit;
2. builds the CUDA kernels from sfm_tpu_torch/csrc (one nvcc per source,
   all in parallel, sm_90a);
3. drives the main path: SfMEngine.add_frames on the synthetic 80-frame
   480x640 strafe scan (the JAX package's bench.py workload) under the
   FLAGSHIP configuration (the large implicit-Schur BA solver), on the card,
   and checks tracking, keyframes, trajectory accuracy (sim(3) keyframe ATE
   against the ground-truth poses), finite landmarks, and that K1, K5, K2,
   K3 and K3-gather were launched by the run (K1's launches also by call
   site);
4. the same scan under SLICE (the dense BA solver), with its own checks;
5. the large solver's second entry point, run_large_ba, at bench_ba.py's
   operating point (1000 cameras, 100k landmarks, 8 LM x 25 CG
   iterations): ms per LM iteration, and the cost must decrease;
6. "live": FLAGSHIP on RGB frames through per-frame SfMEngine.add_frame
   (scan guidance in the step): 40 strafe frames, max_lost_frames + 2
   blank frames, 20 more; the engine must go LOST, relocalize through K1
   and P3P within 3 frames, and meet the ATE, guidance and colour checks;
7. "flow": FLAGSHIP with track_with_flow on 30 frames, and lk_flow timed;
8. "cli": ``cli.main(["scan", ...])`` on the card with metrics, checkpoint
   and overlay video, then a --resume run, then the PLY files read back;
9. holds each kernel against its plain PyTorch version at the main path's
   shapes and times both, in device time (torch.profiler) and with CUDA
   events, beside the kernel's bound (bytes over the memory rate or
   operations over the core rate, from this run's inputs; the card's clock
   raised by a busy burst before each profile): K1 bit for bit (raw
   outputs and MatchResult) and timed as the whole match_features_pallas
   call, three device ops, at its five shapes (relocalization's
   windowless 8192x512 match included), with the route its rule did not
   pick held and timed too where the window admits both; K1 again on the
   FLAGSHIP scan's own calls, replayed by call site and route (bit for
   bit, device time per call, bound, the other route, device time lost
   per scan); K5 bit for bit (with F.grid_sample at the same sample
   positions as the library yardstick), and the BA kernels K2
   (linearizer) and K3 (Schur apply:
   full, gather and scatter modes) within 1e-4 of the largest entry and
   bit-identical on a rerun, at the flagship's mapping-BA shape (dead rows
   included), at benchmarks/bench_ba.py's 1000-camera problem and, for
   equality only, at its layout with 4096 cameras; then run_large_ba once
   more under the profiler.  This comes last because a profiler session
   leaves the host slower for the host-bound phases after it;
10. prints a JSON line with the phases' numbers, a JSON line with the
   kernels' numbers, then the card line, then {"ok": true, "device":
   {...}} as the last line.
With ``--calls DIR`` it only times K1's whole call at its five shapes and
K5's call (device time and device ops per call) for the sfm_tpu_torch
package under DIR, and prints them as JSON and the card line: the way to
compare two commits in one run on one card.
Any failed check raises, and the script exits non-zero."""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

KERNEL_ROWS = (
    ("hamming_match", "sfm_tpu_torch/csrc/match.cu",
     "sfm_tpu/features/match_pallas.py:33"),
    ("patch_sampler", "sfm_tpu_torch/csrc/patches.cu",
     "sfm_tpu/features/patches_pallas.py:30"),
    ("ba_linearize", "sfm_tpu_torch/csrc/linearize.cu",
     "sfm_tpu/ba/linearize_pallas.py:110"),
    ("schur_apply", "sfm_tpu_torch/csrc/schur.cu",
     "sfm_tpu/ba/schur_pallas.py:231"),
    ("schur_gather", "sfm_tpu_torch/csrc/schur.cu",
     "sfm_tpu/ba/schur_pallas.py:125"),
    ("schur_scatter", "sfm_tpu_torch/csrc/schur.cu",
     "sfm_tpu/ba/schur_pallas.py:150"),
)
# the kernels the FLAGSHIP scan must launch (K3-scatter is off its path)
MAIN_PATH = ("hamming_match", "patch_sampler", "ba_linearize", "schur_apply",
             "schur_gather")
# BA kernels against their plain versions: max abs error over the largest
# entry of the plain output.  The kernels contract multiply-adds (FMA)
# where the plain torch ops round each step; a residual of a few pixels at
# coordinates of hundreds keeps ~5 digits in f32, and the Huber weight and
# g follow it.  Sums run in another order (shuffle trees and a fixed
# per-camera order in the kernels, atomics in the plain index_add_).
BA_REL_TOL = 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
# memory bytes per second, and f32 operations per second outside the
# tensor cores.  Every kernel's operations, integer ones included, are held
# to the latter, so a bound set by operations is a floor.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# device microseconds per call of the BA kernels' earlier design (a
# per-block shared-memory camera accumulator summed by a second launch;
# torch.profiler, NVIDIA H100 80GB HBM3, 700.00 W, as PERF.md records
# them), by kernel and shape
EARLIER_US = {("ba_linearize", "flagship"): 22.01,
          ("ba_linearize", "bench_ba"): 480.39,
          ("schur_apply", "flagship"): 8.11, ("schur_apply", "bench_ba"): 112.13,
          ("schur_gather", "flagship"): 2.72,
          ("schur_gather", "bench_ba"): 63.34,
          ("schur_scatter", "flagship"): 6.80,
          ("schur_scatter", "bench_ba"): 52.67}
K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
N_FRAMES = 80
RELOC_K1 = "8192x512 windowless"
# (label, B, Ns, Nt, window centres, min_r, max_r): the main path's K1
# calls — tracking, widen_tracks, mapping triangulation, re-observation —
# and relocalization's windowless global match of every landmark slot
# (zero source positions, radius 1e9, of which 20% are live)
K1_CASES = (("512x512", 1, 512, 512, False, 1.5, 40.0),
            ("2048x512 centres", 1, 2048, 512, True, 0.0, 7.0),
            ("9x512x512", 9, 512, 512, False, 1.5, 120.0),
            ("16x2048x512 centres", 16, 2048, 512, True, 0.0, 7.0),
            (RELOC_K1, 1, 8192, 512, False, 0.0, 1e9))
# device operations a match_features_pallas call may launch on the card
# (the call is exactly this many: a profiler session that shows fewer
# dropped events and is repeated)
K1_MAX_OPS = 3
# K1's match pass kernels, one per route (the other ops of a call are the
# key table's initialisation and the epilogue)
K1_PASSES = ("cells_kernel", "dense_kernel")
# the live phase: strafe frames before the blanks, and after them
LIVE_BEFORE, LIVE_AFTER = 40, 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dev_ms(torch, dev, fn, reps=10):
    """Milliseconds per call: CUDA events on the card, the host clock on
    the CPU (where the phases are rehearsed at a small size)."""
    if torch.device(dev).type == "cuda":
        return cuda_ms(torch, fn, reps=reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run_checks(label, checks):
    for name, ok in checks.items():
        log(f"check [{label}] {name}: {'pass' if ok else 'FAIL'}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} checks failed: {failed}")


def in_turns(torch, plain, kernel):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _short(key):
    """A profiler event's kernel name without return type, namespaces and
    arguments."""
    k = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    k = k.split("(")[0].strip()
    depth, start = 0, 0
    for i, ch in enumerate(k):
        depth += (ch == "<") - (ch == ">")
        if ch == ":" and depth == 0:
            start = i + 1
    return k[start:][:48]


def warm_clocks(torch, ms=30.0):
    """Keep the card busy for ~``ms`` milliseconds: an idle H100 drops its
    SM clock to 345 MHz, and a profiled burst of small kernels does not
    raise it again, so short kernels would be timed at a low clock."""
    a = torch.ones((2048, 2048), device="cuda")
    t0 = time.perf_counter()
    while 1e3 * (time.perf_counter() - t0) < ms:
        for _ in range(8):
            a = a @ a * 1e-3
        torch.cuda.synchronize()


def device_ms(torch, fn, reps=20, by_kernel=None, attempts=5, ops=None,
              ops_ok=float.is_integer):
    """Device milliseconds per call of ``fn``: the self device time of
    every device op torch.profiler records over ``reps`` calls, summed (all
    the kernels and copies a wrapper launches), after warm_clocks.  A
    session now and then records no device event at all, or drops some;
    it is repeated, up to ``attempts`` sessions, and None returned when
    none was whole.  A session is whole when it recorded a device event
    and ``ops_ok(device ops per call)`` holds: by default a whole number
    of ops per call (a session that dropped events rarely leaves one).
    ``by_kernel``, a dict, receives the same per kernel name; ``ops``, a
    dict, the device ops per call under "per_call"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        warm_clocks(torch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times, count = {}, 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None) \
                or getattr(e, "self_cuda_time_total", 0)
            if t > 0:
                name = _short(e.key)
                times[name] = times.get(name, 0.0) + t / reps / 1e3
                count += e.count
        if times and ops_ok(count / reps):
            if by_kernel is not None:
                by_kernel.update(times)
            if ops is not None:
                ops["per_call"] = count / reps
            return sum(times.values())
        log(f"device_ms: a profiler session recorded {count} device ops over "
            f"{reps} calls; repeated")
    return None


@contextlib.contextmanager
def k1_route_forced(mp, route):
    """Inside, every K1 call whose window admits the cells route takes
    ``route``: the route rule's pair threshold (``CELLS_MIN_PAIRS``) moved
    below any call or past every call.  Only for timing the route that
    the rule did not pick; the port never moves it."""
    saved = mp.CELLS_MIN_PAIRS
    mp.CELLS_MIN_PAIRS = -1 if route == "cells" else float("inf")
    try:
        yield
    finally:
        mp.CELLS_MIN_PAIRS = saved


def cells_admitted(mp, args):
    """Whether the window and the target count of a K1 call (the
    kernel's arguments) admit the cells route."""
    return (args[7] <= mp.WINDOW_MAX_RADIUS ** 2
            and args[3].shape[1] <= mp.MAX_SMEM_TARGETS)


def timed(torch, plain, kernel, reps=20, plain_reps=5,
          ops_ok=float.is_integer):
    """The kernel's and the plain version's device ms per call
    (torch.profiler; None where it recorded nothing; ``ops_ok`` as in
    device_ms, for the kernel) and their CUDA-event ms per call including
    the Python wrapper, in turns."""
    ev, plain_ev = in_turns(torch, plain, kernel)
    parts, ops = {}, {}
    ms = device_ms(torch, kernel, reps, parts, ops=ops, ops_ok=ops_ok)
    plain_ms = device_ms(torch, plain, plain_reps)
    return dict(ms=ms, plain_ms=plain_ms, event_ms=ev, plain_event_ms=plain_ev,
                parts_ms=parts, ops_per_call=ops.get("per_call"))


def us(ms):
    """Microseconds for a log line, from ms that may be None."""
    return "not recorded" if ms is None else f"{1e3 * ms:.2f} us"


def share(bound_ms, ms):
    return "" if ms is None else f", {bound_ms / ms:.1%} of it"


def bound(nbytes, ops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CORE_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops), bytes=nbytes, ops=ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bound(torch, args):
    """K1's bound on these inputs: each input read and each output written
    once; ~6 operations per pair for the window test and 48 (16 words of
    XOR, popcount, add) per feasible pair, the only ones it matches."""
    desc_s, ctr_s, valid_s, desc_t, xy_t, valid_t, min_r2, max_r2 = args[:8]
    B, Ns = valid_s.shape
    Nt = valid_t.shape[1]
    d2 = ((ctr_s[:, :, None, :] - xy_t[:, None, :, :]) ** 2).sum(-1)
    feasible = int((valid_s[:, :, None] & valid_t[:, None, :] & (d2 >= min_r2)
                    & (d2 <= max_r2)).sum())
    out = B * Ns * 12 + B * Nt * 8     # idx, best, second; keys
    return bound(nbytes(*args[:6]) + out, 6 * B * Ns * Nt + 48 * feasible)


def k5_bound(torch, canvas_s, cx, cy, out):
    """K5's bound on these inputs: the canvas pixels its windows cover
    (the union of the 34 x 34 windows at (cx, cy), inside the canvas: the
    only pixels it reads), cx and cy read once, the patches written once;
    9 operations (6 multiplies, 3 adds) per patch value."""
    from sfm_tpu_torch.features.patches_pallas import PATCH, PATCH_RADIUS
    Hc, Wc = canvas_s.shape
    rr = torch.arange(PATCH + 1, device=cx.device)
    xs = torch.floor(cx).long()[:, None] - PATCH_RADIUS + rr
    ys = torch.floor(cy).long()[:, None] - PATCH_RADIUS + rr
    inside = (((ys >= 0) & (ys < Hc))[:, :, None]
              & ((xs >= 0) & (xs < Wc))[:, None, :])
    covered = torch.zeros(Hc * Wc, dtype=torch.bool, device=cx.device)
    covered[(ys[:, :, None] * Wc + xs[:, None, :])[inside]] = True
    window = int(covered.sum()) * canvas_s.element_size()
    return dict(bound(window + nbytes(cx, cy, out), 9 * out.numel()),
                window_bytes=window)


def match_case(torch, g, B, Ns, Nt, centers, dev):
    """Descriptors where a third of the sources are noisy copies of a
    target (so ratio tests pass and ties occur), positions in the image."""
    desc_t = g.integers(-2 ** 31, 2 ** 31, (B, Nt, 16), dtype=np.int64)
    desc_s = g.integers(-2 ** 31, 2 ** 31, (B, Ns, 16), dtype=np.int64)
    xy_t = g.uniform(0, [640, 480], (B, Nt, 2))
    pick = g.integers(0, Nt, (B, Ns))
    copy = g.uniform(0, 1, (B, Ns)) < 0.35
    flips = np.zeros((B, Ns, 16), np.int64)
    for _ in range(3):
        flips |= 1 << g.integers(0, 31, (B, Ns, 16))
    noisy = np.take_along_axis(desc_t, pick[..., None], 1) ^ (
        flips * (g.uniform(0, 1, (B, Ns, 16)) < 0.4))
    desc_s = np.where(copy[..., None], noisy, desc_s)
    near = np.take_along_axis(xy_t, pick[..., None], 1) + g.normal(
        0, 3 if centers else 8, (B, Ns, 2))
    xy_s = np.where(copy[..., None], near, g.uniform(0, [640, 480],
                                                     (B, Ns, 2)))
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (t(desc_s.astype(np.int32), torch.int32),
            t(xy_s, torch.float32),
            t(g.uniform(0, 1, (B, Ns)) < 0.95, torch.bool),
            t(desc_t.astype(np.int32), torch.int32),
            t(xy_t, torch.float32),
            t(g.uniform(0, 1, (B, Nt)) < 0.95, torch.bool))


def k1_inputs(torch, g, case, dev):
    """One case of K1_CASES: the kernel's arguments (the radii squared and
    rounded to f32, as match_features_pallas passes them) and
    match_features_pallas's keywords."""
    label, B, Ns, Nt, centers, rmin, rmax = case
    args = match_case(torch, g, B, Ns, Nt, centers, dev)
    if label == RELOC_K1:
        args = (args[0], torch.zeros_like(args[1]),
                torch.as_tensor(g.uniform(0, 1, (B, Ns)) < 0.2,
                                device=dev)) + args[3:]
    kw = dict(min_radius=rmin, max_radius=rmax, max_distance=90.0,
              ratio=0.8, window_center0=args[1] if centers else None)
    return args + (float(np.float32(rmin * rmin)),
                   float(np.float32(rmax * rmax)), 90.0, 0.8), kw


def k5_inputs(torch, dev):
    """K5's inputs on a rendered frame's canvas and keypoints (the main
    path's shape)."""
    from sfm_tpu_torch.features.descriptor import patch_inputs
    from sfm_tpu_torch.features.detect import detect
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rv, tv = strafe_trajectory(2, step=0.06, yaw_rate=0.001)
    img = torch.as_tensor(scene.render(K, rv[0], tv[0], 480, 640), device=dev)
    kps, canvas = detect(img, max_keypoints=512, levels=4, return_canvas=True)
    return patch_inputs(canvas, kps, 4, 640)


def time_calls(torch, dev):
    """K1 as the whole match_features_pallas call at the five K1_CASES
    shapes, and K5's call, in device time with the device ops per call.
    Runs on whatever sfm_tpu_torch is first on the path (``--calls DIR``),
    so that two commits are timed by the same code on one card."""
    from sfm_tpu_torch.features import match_pallas as mp
    from sfm_tpu_torch.features import patches_pallas as pp
    g = np.random.default_rng(5)
    out = {}
    for case in K1_CASES:
        args, kw = k1_inputs(torch, g, case, dev)
        ops = {}
        ms = device_ms(torch, lambda: mp.match_features_pallas(*args[:6], **kw),
                       ops=ops)
        out[case[0]] = dict(ms=ms, ops_per_call=ops.get("per_call"))
        log(f"K1 {case[0]} whole call: {us(ms)} device, "
            f"{ops.get('per_call')} device ops per call")
    canvas_s, cx, cy = k5_inputs(torch, dev)
    ops = {}
    ms = device_ms(torch, lambda: pp.extract_patches_kernel(canvas_s, cx, cy),
                   ops=ops)
    out["patch_sampler"] = dict(ms=ms, ops_per_call=ops.get("per_call"))
    log(f"K5 call: {us(ms)} device, {ops.get('per_call')} device ops per call")
    return out


def check_kernels(torch, dev):
    from sfm_tpu_torch.features import match_pallas as mp
    from sfm_tpu_torch.features import patches_pallas as pp

    g = np.random.default_rng(5)
    rows = {}
    k1 = []
    for case in K1_CASES:
        label = case[0]
        args, kw = k1_inputs(torch, g, case, dev)
        a = mp.hamming_match_kernel(*args) + mp.match_result_kernel(*args)
        b = mp.hamming_match_plain(*args) + mp.match_result_plain(*args)
        torch.cuda.synchronize()
        for name, x, y in zip(("idx", "best", "second", "keys", "result idx",
                               "result dist", "result mask"), a, b):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"K1 {label}: {name} differs from the plain version at "
                    f"{int((x != y).sum())} entries")
        res_k = mp.match_features_pallas(*args[:6], **kw)
        n_match = int(res_k.mask.sum())
        if n_match == 0:
            raise AssertionError(f"K1 {label}: no matches in the test case")
        err = float((a[1] - b[1]).abs().max())
        route = mp.k1_route(args[7], *args[0].shape[:2], args[3].shape[1])

        def call():
            return mp.match_features_pallas(*args[:6], **kw)
        # K1 is the whole call: the key table, the match pass, the epilogue
        t = timed(torch, lambda: mp.match_result_plain(*args), call,
                  ops_ok=lambda n: n == K1_MAX_OPS)
        if t["ops_per_call"] is None or t["ops_per_call"] > K1_MAX_OPS:
            raise AssertionError(f"K1 {label}: {t['ops_per_call']} device ops "
                                 f"per call (at most {K1_MAX_OPS})")
        kernel_only = sum(v for k, v in t["parts_ms"].items()
                          if k in K1_PASSES)
        bd = k1_bound(torch, args)
        row = dict(shape=label, route=route, max_abs_err=err, matches=n_match,
                   library_ms=None, kernel_only_ms=kernel_only, **t, **bd)
        alt_msg = ""
        if cells_admitted(mp, args):
            # the route the rule did not pick, held and timed on the same
            # inputs: what the rule's choice is worth here
            other = "dense_int" if route == "cells" else "cells"
            with k1_route_forced(mp, other):
                same = all(torch.equal(x, y) for x, y in zip(
                    mp.match_result_kernel(*args), b[4:]))
                if not same:
                    raise AssertionError(f"K1 {label}: the {other} route "
                                         f"differs from the plain version")
                row["other_route"] = other
                row["other_route_ms"] = device_ms(
                    torch, call, ops_ok=lambda n: n == K1_MAX_OPS)
            alt_msg = f"; the {other} route {us(row['other_route_ms'])}"
        k1.append(row)
        log(f"K1 {label}: exact, {n_match} matches, route {route}, whole call "
            f"{us(t['ms'])} device in {t['ops_per_call']} device ops "
            f"(match pass {us(kernel_only)}; {t['event_ms']:.4f} ms events), "
            f"plain {us(t['plain_ms'])} device ({t['plain_event_ms']:.4f} ms)"
            f"{alt_msg}; bound {us(bd['bound_ms'])} ({bd['bound_by']}: "
            f"{bd['bytes']} B, {bd['ops']:.3e} ops)"
            f"{share(bd['bound_ms'], t['ms'])}")
    # the kernels line keeps the batched mapping shape; every shape is in
    # per_shape
    rows["hamming_match"] = dict(
        next(r for r in k1 if r["shape"] == "16x2048x512 centres"),
        per_shape=k1)

    canvas_s, cx, cy = k5_inputs(torch, dev)
    a = pp.extract_patches_kernel(canvas_s, cx, cy)
    b = pp.extract_patches_plain(canvas_s, cx, cy)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    if not torch.equal(a, b):
        raise AssertionError(f"K5: differs from the plain version (max abs "
                             f"err {err})")
    t = timed(torch, lambda: pp.extract_patches_plain(canvas_s, cx, cy),
              lambda: pp.extract_patches_kernel(canvas_s, cx, cy),
              ops_ok=lambda n: n == 1)
    # the library yardstick: F.grid_sample (bilinear, zero padding) at the
    # same 33 x 33 sample positions, one call; the port never calls it
    F = torch.nn.functional
    Hc, Wc = canvas_s.shape
    r = torch.arange(-pp.PATCH_RADIUS, pp.PATCH_RADIUS + 1, device=dev,
                     dtype=torch.float32)
    gx = (cx[:, None, None] + r[None, None, :]).expand(-1, pp.PATCH, -1)
    gy = (cy[:, None, None] + r[None, :, None]).expand(-1, -1, pp.PATCH)
    grid = torch.stack([2 * gx / (Wc - 1) - 1, 2 * gy / (Hc - 1) - 1], -1)
    grid = grid.reshape(1, -1, pp.PATCH, 2).contiguous()
    img = canvas_s[None, None]

    def library():
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    lib_err = float((library().reshape(a.shape) - b).abs().max())
    lib_ms = device_ms(torch, library)
    bd = k5_bound(torch, canvas_s, cx, cy, a)
    rows["patch_sampler"] = dict(shape=f"{cx.shape[0]} kp, canvas "
                                       f"{tuple(canvas_s.shape)}",
                                 max_abs_err=err, library_ms=lib_ms,
                                 library_max_abs_err=lib_err, **t, **bd)
    log(f"K5 {rows['patch_sampler']['shape']}: equal to the plain version, "
        f"kernel {us(t['ms'])} device ({t['event_ms']:.4f} ms events), "
        f"plain {us(t['plain_ms'])} device; F.grid_sample {us(lib_ms)} "
        f"device (max abs diff {lib_err:.2e}); bound {us(bd['bound_ms'])} "
        f"({bd['bound_by']}: {bd['bytes']} B of which {bd['window_bytes']} "
        f"B of canvas windows, {bd['ops']} ops)"
        f"{share(bd['bound_ms'], t['ms'])}")
    return rows


def ba_problem(torch, dev, n_cams, n_lms, obs_per_lm, seed=0,
               min_obs=None, noise_px=0.0, outlier_p=0.0, spread=1.0,
               live=1.0):
    """benchmarks/bench_ba.py's synthetic problem (cameras along x, each
    landmark seen by obs_per_lm consecutive cameras), made the same way
    with numpy.  The options are not in bench_ba: min_obs empties the tail
    slots of some landmarks; noise_px / outlier_p perturb the pixels;
    spread scales the lateral extent of the scene and the trajectory (at 1
    the pixels reach ~2700, where an f32 residual of a few pixels keeps
    only ~4 digits; 0.2 keeps them within ~800); live < 1 leaves only the
    first share of the landmark rows observed, as landmark compaction
    leaves the mapping BA's table."""
    from sfm_tpu_torch.ba.large import ObsTables, build_lm_tables_device
    from sfm_tpu_torch.ba.residuals import Observations
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-50, 50, n_lms) * spread,
                  rng.uniform(-10, 10, n_lms) * spread,
                  rng.uniform(20, 60, n_lms)], 1).astype(np.float32)
    cam_t = np.stack([np.linspace(-40, 40, n_cams) * spread,
                      np.zeros(n_cams), np.zeros(n_cams)],
                     1).astype(np.float32)
    base = rng.integers(0, n_cams - obs_per_lm, n_lms)
    lm_idx = np.repeat(np.arange(n_lms), obs_per_lm)
    cam_idx = (base[:, None] + np.arange(obs_per_lm)[None, :]).reshape(-1)
    p = X[lm_idx] + cam_t[cam_idx]
    uv = (p[:, :2] / p[:, 2:]) * 525.0 + np.array([320.0, 240.0])
    w = np.ones(len(cam_idx), np.float32)
    if min_obs is not None:
        n = rng.integers(min_obs, obs_per_lm + 1, n_lms)
        slot = np.tile(np.arange(obs_per_lm), n_lms)
        w[slot >= np.repeat(n, obs_per_lm)] = 0
    w[lm_idx >= int(live * n_lms)] = 0
    if noise_px:
        uv = uv + rng.normal(0, noise_px, uv.shape)
    uv[rng.uniform(0, 1, len(uv)) < outlier_p] += 30.0
    rv0 = np.zeros((n_cams, 3), np.float32)
    rv0[1:] += 0.002
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev)
    obs = Observations(t(cam_idx, torch.int64), t(lm_idx, torch.int64),
                       t(uv), t(w))
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(obs, n_lms, obs_per_lm)
    cam_free = torch.ones(n_cams, dtype=torch.bool, device=dev)
    cam_free[0] = False
    return dict(K=t(K), rv=t(rv0), tv=t(cam_t), X=t(X0),
                tables=ObsTables(lm_cam, lm_uv, lm_w), cam_free=cam_free,
                lm_free=torch.ones(n_lms, dtype=torch.bool, device=dev),
                n_obs=int((w > 0).sum()))


def _rel_err(a, b):
    """(max abs error, the same over the largest |b|)."""
    err = float((a.double() - b.double()).abs().max())
    scale = max(float(b.double().abs().max()), 1e-30)
    if not np.isfinite(err) or err > BA_REL_TOL * scale:
        raise AssertionError(f"max abs err {err} > {BA_REL_TOL} x {scale}")
    return err, err / scale


def ba_bound(name, tb, C):
    """The bound of a BA kernel on a table: its inputs read and outputs
    written once (f32 / int32; K3 with g and x given), and its flops on the
    live slots (K2 ~300 per slot; K3 36 per slot and half of the full
    mode, 18 per landmark for Vinv t)."""
    L, kmax = tb.lm_cam.shape
    slots, live = L * kmax, int((tb.lm_w != 0).sum())
    if name == "ba_linearize":
        # K, R, t, cam_free; xyz, lm_free; lm_cam, uv, w | W; V, g_lm;
        # U, g_cam; cost
        io = 36 + C * 52 + L * 16 + slots * 16 + slots * 72 + L * 48 \
            + C * 168 + 4
        return bound(io, 300 * live)
    table = slots * (4 + 72)          # lm_cam and W
    io = {"schur_apply": table + L * (36 + 12 + 12) + C * 48,
          "schur_gather": table + L * (36 + 12 + 12) + C * 24,
          "schur_scatter": table + L * 12 + C * 24}[name]
    ops = {"schur_apply": 72 * live + 18 * L, "schur_gather": 36 * live
           + 18 * L, "schur_scatter": 36 * live}[name]
    return bound(io, ops)


def check_ba_kernels(torch, dev):
    """K2 and the three K3 modes against their plain versions at the
    flagship's mapping-BA shape (32 cameras, 2048 landmark rows of which
    the first 20% are live, as after compaction on the scan's map; kmax 8,
    Huber 2.0, free masks), at bench_ba.py's (1000, 100k, 6) and, for
    equality only, at bench_ba's layout with 4096 cameras (above the camera
    caps of the earlier shared-memory design).  Each kernel is run twice and
    must give the same bits; each is timed with torch.profiler beside its
    bound and the earlier design's time."""
    from sfm_tpu_torch.ba import linearize_pallas as lp
    from sfm_tpu_torch.ba import schur_pallas as sp
    from sfm_tpu_torch.ba.large import camera_slots
    from sfm_tpu_torch.geometry.rotations import exp_so3

    # (label, C, L, kmax, Huber delta, landmark mask, problem options,
    # timed)
    shapes = (("flagship C=32 L=2048 kmax=8", 32, 2048, 8, 2.0, True,
               dict(min_obs=2, noise_px=1.0, outlier_p=0.05, spread=0.2,
                    live=0.2), True),
              ("bench_ba C=1000 L=100000 kmax=6", 1000, 100_000, 6, 0.0,
               False, {}, True),
              ("bench_ba layout C=4096 L=100000 kmax=6", 4096, 100_000, 6,
               0.0, False, {}, False))
    per = {k: [] for k in ("ba_linearize", "schur_apply", "schur_gather",
                           "schur_scatter")}

    def check(name, label, kern, plain, tb, C, timed_shape):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        errs = [_rel_err(u, v) for u, v in zip(a, b)]
        err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        again = kern()
        same = all(torch.equal(u, v) for u, v in zip(a, again))
        if not same:
            raise AssertionError(f"{name} {label}: two launches differ")
        row = dict(shape=label, max_abs_err=err, max_rel_err=rel,
                   bit_identical=same, library_ms=None,
                   **ba_bound(name, tb, C))
        msg = (f"{name} {label}: max abs err {err:.3e} (rel {rel:.3e}"
               f"{'; ' + ' '.join(f'{e[1]:.1e}' for e in errs) if len(errs) > 2 else ''}"
               f"), rerun bit-identical")
        if timed_shape:
            row.update(timed(torch, plain, kern))
            prev = EARLIER_US.get((name, label.split()[0]))
            row["earlier_design_us"] = prev
            msg += (f"; kernel {us(row['ms'])} device (earlier design: "
                    f"{prev} us; {row['event_ms']:.4f} ms events), plain "
                    f"{us(row['plain_ms'])} device; bound "
                    f"{us(row['bound_ms'])} ({row['bound_by']})"
                    f"{share(row['bound_ms'], row['ms'])}; by kernel "
                    + ", ".join(f"{k} {1e3 * v:.2f} us"
                                for k, v in row["parts_ms"].items()))
        per[name].append(row)
        log(msg)

    for label, C, L, kmax, huber, mask, extra, timed_shape in shapes:
        pr = ba_problem(torch, dev, C, L, kmax, **extra)
        tb = pr["tables"]
        cs = camera_slots(tb.lm_cam, tb.lm_w, C)
        lm_free = pr["lm_free"].float()
        if mask:   # camera 0 is frozen already; every 7th landmark too
            lm_free[::7] = 0.0
        args = (pr["K"], exp_so3(pr["rv"]).contiguous(), pr["tv"], pr["X"],
                lm_free, pr["cam_free"].float(), tb.lm_cam, tb.lm_uv,
                tb.lm_w, huber)
        log(f"[BA kernels] {label}: {pr['n_obs']} observations")
        check("ba_linearize", label,
              lambda: lp.ba_linearize_kernel(*args, slots=cs),
              lambda: lp.ba_linearize_plain(*args), tb, C, timed_shape)

        W, V, g_lm = lp.ba_linearize_plain(*args)[:3]
        Vinv = lp.damped_vinv(V, 1e-3)
        x = torch.as_tensor(np.random.default_rng(1).normal(0, 1, (C, 6)),
                            dtype=torch.float32, device=dev)
        lm_cam = tb.lm_cam
        z_ref = sp.schur_gather_plain(lm_cam, W, Vinv, g_lm, x)
        cases = (
            ("schur_apply",
             lambda: sp.schur_kernel("full", lm_cam, W, Vinv, g_lm, x,
                                     slots=cs),
             lambda: sp.schur_apply_fused_plain(lm_cam, W, Vinv, g_lm, x,
                                                C)),
            ("schur_gather",
             lambda: (sp.schur_kernel("gather", lm_cam, W, Vinv, g_lm, x),),
             lambda: (sp.schur_gather_plain(lm_cam, W, Vinv, g_lm, x),)),
            ("schur_scatter",
             lambda: (sp.schur_kernel("scatter", lm_cam, W, z=z_ref,
                                      n_cams=C, slots=cs),),
             lambda: (sp.schur_scatter_plain(lm_cam, W, z_ref, C),)))
        for name, kern, plain in cases:
            check(name, label, kern, plain, tb, C, timed_shape)
    # the kernels line carries the main path's (flagship) shape
    return {k: dict(v[0], per_shape=v) for k, v in per.items()}


def run_bench_ba(torch, dev, iterations=8, cg_iterations=25):
    """run_large_ba at bench_ba.py's operating point, timed on the second
    of two runs (host clock around a synchronised run).  Returns the
    numbers and the function that runs it (``bench_ba_device`` profiles
    it at the end)."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.ba.large import run_large_ba
    pr = ba_problem(torch, dev, 1000, 100_000, 6)

    def once():
        return run_large_ba(pr["K"], pr["rv"], pr["tv"], pr["X"],
                            pr["tables"], cam_free=pr["cam_free"],
                            lm_free=pr["lm_free"], iterations=iterations,
                            cg_iterations=cg_iterations, tol=0.0)

    once()
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, X, st = once()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in native.LAUNCHES.items() if v}
    c0, c1 = float(st.initial_cost), float(st.final_cost)
    ms_iter = 1e3 * secs / iterations
    log(f"run_large_ba 1000 cams x 100000 lms ({pr['n_obs']} obs): "
        f"{ms_iter:.3f} ms per LM iteration ({iterations} LM x "
        f"{cg_iterations} CG), cost {c0:.6e} -> {c1:.6e}, "
        f"{int(st.accepted)} accepted, launches {launches}")
    checks = {"cost decreases": np.isfinite(c1) and c1 < c0,
              "landmarks finite": bool(torch.isfinite(X).all()),
              "K2 and K3 launched": launches.get("ba_linearize", 0) > 0
              and launches.get("schur_apply", 0) > 0}
    for name, ok in checks.items():
        log(f"check run_large_ba {name}: {'pass' if ok else 'FAIL'}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"run_large_ba checks failed: {failed}")
    return dict(ms_per_lm_iter=ms_iter, initial_cost=c0, final_cost=c1,
                accepted=int(st.accepted), launches=launches), once


def bench_ba_device(torch, once, iterations=8):
    """One more run_large_ba under torch.profiler: its device ms per LM
    iteration, and that of the K2 / K3 phases by kernel."""
    parts = {}
    dev_iter = (device_ms(torch, once, 1, parts) or float("nan")) / iterations
    ba = {k: v / iterations for k, v in parts.items()
          if k.startswith(("landmark_phase", "camera_phase"))}
    log(f"run_large_ba under torch.profiler: device {dev_iter:.3f} ms per LM "
        f"iteration, of which the K2 / K3 phases {sum(ba.values()):.3f} ms ("
        + ", ".join(f"{k} {v:.3f}" for k, v in ba.items()) + ")")
    return dict(device_ms_per_lm_iter=dev_iter, ba_kernels_ms_per_lm_iter=ba)


def _kept(torch, t):
    """A copy of a recorded K1 operand; an expanded one (batch stride 0)
    stays expanded."""
    if not torch.is_tensor(t):
        return t
    if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
        return t[:1].clone().expand_as(t)
    return t.clone()


def count_k1_sites(native, record=None):
    """Wrap the matcher entry of each engine module so that K1's launches
    are also counted by calling function ("module.function"); returns the
    counts and a function that undoes the wrapping.  The wrapper counts
    what the kernel's own counter adds, nothing else.  With a list
    ``record``, each K1 call also appends (site, a copy of the kernel's
    arguments), taken at the K1 dispatch ``match_pallas.hamming_match``,
    for the replay in ``k1_by_site``."""
    import importlib

    import torch

    from sfm_tpu_torch.features import match_pallas as mp
    sites, undo, current = {}, [], [None]
    for stem in ("bootstrap", "tracking", "mapping", "reloc"):
        mod = importlib.import_module(f"sfm_tpu_torch.engine.{stem}")
        real = mod.match_features_pallas

        def wrapped(*a, _real=real, _stem=stem, **kw):
            site = f"{_stem}.{sys._getframe(1).f_code.co_name}"
            n0 = native.LAUNCHES["hamming_match"]
            current[0] = site
            try:
                out = _real(*a, **kw)
            finally:
                current[0] = None
            sites[site] = sites.get(site, 0) \
                + native.LAUNCHES["hamming_match"] - n0
            return out
        mod.match_features_pallas = wrapped
        undo.append((mod, "match_features_pallas", real))
    if record is not None:
        dispatch = mp.hamming_match

        def recorded(*a):
            record.append((current[0], tuple(_kept(torch, x) for x in a)))
            return dispatch(*a)
        mp.hamming_match = recorded
        undo.append((mp, "hamming_match", dispatch))

    def restore():
        for mod, name, real in undo:
            setattr(mod, name, real)
    return sites, restore


def k1_by_site(torch, calls):
    """K1 on the FLAGSHIP scan's own calls (``calls``: (site, kernel
    arguments) as ``count_k1_sites`` recorded them), replayed after the
    scan, grouped by call site and route.  Each call is held bit for bit
    against the plain version.  Per group: the calls, the device us per
    call (every device op of the calls under torch.profiler, exactly three
    a call), the bound (``k1_bound``, mean over the calls), the device us
    a call takes on the route the rule did not pick where the window
    admits both, and launches x (us - bound), the device time the group
    loses per scan."""
    from sfm_tpu_torch.features import match_pallas as mp
    groups = {}
    for site, args in calls:
        route = mp.k1_route(args[7], *args[0].shape[:2], args[3].shape[1])
        groups.setdefault((site, route), []).append(args)
    out = {}
    for (site, route), group in groups.items():
        label = f"{site} [{route}]"

        def check(what):
            for args in group:
                for x, y in zip(mp.match_result_kernel(*args),
                                mp.match_result_plain(*args)):
                    if not torch.equal(x, y):
                        raise AssertionError(f"K1 {label}: {what} differs "
                                             f"from the plain version")

        def run(group=group):
            for args in group:
                mp.match_result_kernel(*args)
        n = len(group)
        check("the kernel")
        ms = device_ms(torch, run, reps=5,
                       ops_ok=lambda c, n=n: c == K1_MAX_OPS * n)
        if ms is None:
            raise AssertionError(f"K1 {label}: no whole profiler session")
        bound_us = 1e3 * float(np.mean([k1_bound(torch, a)["bound_ms"]
                                        for a in group]))
        row = dict(site=site, route=route, calls=n, us=1e3 * ms / n,
                   bound_us=bound_us,
                   lost_ms=n * (1e3 * ms / n - bound_us) / 1e3,
                   shapes=sorted({f"{a[0].shape[0]}x{a[0].shape[1]}x"
                                  f"{a[3].shape[1]}" for a in group}),
                   max_r=sorted({round(float(np.sqrt(a[7])), 3)
                                 for a in group}))
        msg = ""
        if all(cells_admitted(mp, a) for a in group):
            other = "dense_int" if route == "cells" else "cells"
            with k1_route_forced(mp, other):
                check(f"the {other} route")
                o = device_ms(torch, run, reps=5,
                              ops_ok=lambda c, n=n: c == K1_MAX_OPS * n)
            row.update(other_route=other,
                       other_route_us=None if o is None else 1e3 * o / n)
            msg = f"; the {other} route {us(o and o / n)}"
        out[label] = row
        log(f"K1 on the FLAGSHIP scan's calls, {label}: {n} calls "
            f"{row['shapes']} radius {row['max_r']}, exact, {us(ms / n)} "
            f"device per call{msg}; bound {row['bound_us']:.2f} us; lost per "
            f"scan {row['lost_ms']:.4f} ms")
    return out


def run_slice(torch, dev, cfg, label, kernels, K=K, n_frames=N_FRAMES,
              k1_calls=None):
    """add_frames over the bench.py scan in chunks of keyframe_time_lag
    frames, then the checks; every counter in ``kernels`` must have been
    launched by the scan.  K1's launches are also counted per call site,
    and its calls recorded into the list ``k1_calls`` when given."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine import SfMEngine, run_pending_mapping
    from sfm_tpu_torch.engine.state import scalar
    from sfm_tpu_torch.synthetic import (SpriteScene, keyframe_ate,
                                         strafe_trajectory)

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    H, W = cfg.image_size
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rvecs, tvecs = strafe_trajectory(n_frames, step=0.06, yaw_rate=0.001)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], H, W)
                       for i in range(n_frames)])
    chunk = cfg.keyframe_time_lag
    eng = SfMEngine(K, (H, W), config=cfg, device=dev, seed=0)
    staged = [torch.as_tensor(frames[i:i + chunk], device=dev)
              for i in range(0, n_frames, chunk)]
    sync()

    k1_sites, restore = count_k1_sites(native, k1_calls)
    try:
        native.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = eng.add_frames(staged[0])
        sync()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for ch in staged[1:]:
            metrics += eng.add_frames(ch)
        sync()
        steady_s = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
    finally:
        restore()

    status = np.array([int(m["status"]) for m in metrics])
    boot = int(np.argmax(status == 1)) if (status == 1).any() else None
    if boot is None:
        raise AssertionError("the scan never bootstrapped")
    post = status[boot + 1:]
    running = float((post == 1).mean())
    n_kf = int(eng.state.kfs.valid.sum())
    traj, fns = eng.get_trajectory(), eng.keyframe_numbers()
    ate, extent = keyframe_ate(traj, fns, rvecs, tvecs)
    pts, _ = eng.get_reconstruction()
    fps = (n_frames - chunk) / steady_s
    dropped = int(eng.state.ba_dropped_obs)
    log(f"[{label}] bootstrap on frame {boot}; {running:.1%} of later "
        f"frames RUNNING; {n_kf} keyframes {fns.tolist()}; {len(pts)} "
        f"landmarks; ATE {ate:.5f} over extent {extent:.3f} "
        f"({100 * ate / extent:.3f}%); ba_dropped_obs {dropped} (the last "
        f"mapping pass); launches {launches}; K1 launches by call site "
        f"{k1_sites}")
    log(f"[{label}] first chunk {first_s:.3f} s; amortised {fps:.3f} "
        f"frames/s over frames {chunk}-{n_frames - 1} (tracking + deferred "
        f"mapping)")

    # the mapping pass alone, re-run on the final map's newest keyframe
    slot = int(np.argmax(np.where(eng.state.kfs.valid.cpu().numpy(),
                                  eng.state.kfs.frames.frame_no.cpu().numpy(),
                                  -1)))
    st = eng.state
    map_ms = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        st = run_pending_mapping(cfg, eng.cam, st.replace(
            pending_map_slot=scalar(slot, dev)))
        sync()
        map_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"[{label}] mapping pass {np.mean(map_ms):.3f} ms mean of 5 "
        f"({', '.join(f'{x:.3f}' for x in map_ms)})")

    checks = {
        "post-bootstrap frames RUNNING >= 90%": running >= 0.9,
        "keyframes >= 4": n_kf >= 4,
        "sim(3) keyframe ATE < 2% of extent": ate < 0.02 * extent,
        "state on the engine's device": eng.state.lms.xyz.device.type
        == torch.device(dev).type == eng.state.kfs.frames.desc.device.type,
        "landmarks finite": len(pts) > 0 and bool(np.isfinite(pts).all()),
    }
    for name in kernels:
        checks[f"{name} launched by the scan"] = launches[name] > 0
    for name, ok in checks.items():
        log(f"check [{label}] {name}: {'pass' if ok else 'FAIL'}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} checks failed: {failed}")
    return dict(launches=launches, k1_sites=k1_sites, fps=fps,
                map_ms=float(np.mean(map_ms)),
                ate_pct=100 * ate / extent, keyframes=n_kf,
                running=running, bootstrap_frame=boot,
                ba_dropped_obs=dropped)


def run_live(torch, dev, cfg, kernels, K=K, before=LIVE_BEFORE,
             after=LIVE_AFTER, label="live"):
    """The live path: per-frame add_frame (inline mapping) on RGB frames
    with scan guidance: ``before`` strafe frames, max_lost_frames + 2
    blank frames (the engine goes LOST), then ``after`` more strafe frames
    (relocalization through K1's windowless match and P3P, then tracking
    again).  Checks the LOST -> RUNNING recovery, the reloc frame's inliers
    and K1 launch, the kernels of ``kernels``, the keyframe ATE, the
    guidance metrics and the landmark colours."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine import LOST, RUNNING, SfMEngine
    from sfm_tpu_torch.guidance import update_guidance
    from sfm_tpu_torch.synthetic import (SpriteScene, keyframe_ate,
                                         strafe_trajectory)

    H, W = cfg.image_size
    n_blank = cfg.max_lost_frames + 2
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rv, tv = strafe_trajectory(before + after, step=0.06, yaw_rate=0.001)
    frames = [scene.render(K, rv[i], tv[i], H, W, rgb=True)
              for i in range(before + after)]
    blank = np.full((H, W, 3), 40.0, np.float32)
    seq = frames[:before] + [blank] * n_blank + frames[before:]
    # ground truth by frame number (the blank frames hold the last pose)
    rv_fn = np.concatenate([rv[:before], np.repeat(rv[before - 1:before],
                                                   n_blank, 0), rv[before:]])
    tv_fn = np.concatenate([tv[:before], np.repeat(tv[before - 1:before],
                                                   n_blank, 0), tv[before:]])
    staged = [torch.as_tensor(f, device=dev) for f in seq]
    eng = SfMEngine(K, (H, W), config=cfg, device=dev, seed=0)
    sync(torch, dev)

    native.reset_launch_counts()
    metrics, secs, k1 = [], [], []
    for img in staged:
        n0 = native.LAUNCHES["hamming_match"]
        t0 = time.perf_counter()
        metrics.append(eng.add_frame(img))      # fetches the metrics: synced
        secs.append(time.perf_counter() - t0)
        k1.append(native.LAUNCHES["hamming_match"] - n0)
    launches = dict(native.LAUNCHES)

    status = np.array([int(m["status"]) for m in metrics])
    end = before + n_blank                      # the first frame after
    lost = np.nonzero(status == LOST)[0]
    back = [i for i in range(end, len(seq)) if status[i] == RUNNING]
    rec = back[0] if back else None
    boot = int(np.argmax(status == RUNNING))
    running_after = status[rec:] == RUNNING if rec is not None else [False]
    traj, fns = eng.get_trajectory(), eng.keyframe_numbers()
    ate, extent = keyframe_ate(traj, fns, rv_fn, tv_fn)
    pts, cols = eng.get_reconstruction()
    guid = [m for m in metrics if int(m["status"]) == RUNNING]
    guid_ok = all(
        all(np.isfinite(m[k]).all() for k in ("guid_centroid",
                                              "guid_bbox_center",
                                              "guid_bbox_axes",
                                              "guid_bbox_extent"))
        and 0 <= m["guid_bbox_center"][0] < W
        and 0 <= m["guid_bbox_center"][1] < H for m in guid)
    guid_filled = sum(bool(m["guid_bbox_extent"].any()) for m in guid)
    # guidance alone on the last frame's state, timed on the device
    st = eng.state
    img = staged[-1]
    guid_ms = dev_ms(torch, dev, lambda: update_guidance(
        cfg, st.guidance, img, st.lms.xyz, st.lms.valid, eng.cam.Kopt,
        st.prev.rvec, st.prev.tvec))
    steady = secs[10:]
    fps = len(steady) / sum(steady)
    reloc_ms = 1e3 * secs[rec] if rec is not None else float("nan")
    log(f"[{label}] bootstrap on frame {boot}; LOST on frames "
        f"{lost.tolist()}; blanks {before}-{end - 1}; RUNNING again on frame "
        f"{rec} ({metrics[rec]['n_inliers'] if rec else 0} inliers, "
        f"{metrics[rec]['n_matches'] if rec else 0} matches, K1 launches "
        f"{k1[rec] if rec else 0}, {reloc_ms:.3f} ms); {len(fns)} keyframes; "
        f"{len(pts)} landmarks; ATE {ate:.5f} over extent {extent:.3f} "
        f"({100 * ate / extent:.3f}%); guidance box on {guid_filled} of "
        f"{len(guid)} RUNNING frames; launches {launches}")
    log(f"[{label}] amortised {fps:.3f} frames/s over frames 10-"
        f"{len(seq) - 1} (per-frame add_frame, inline mapping, guidance); "
        f"guidance {guid_ms:.4f} ms per frame; reloc frame {reloc_ms:.3f} ms")
    checks = {
        "LOST during the blanks": len(lost) > 0 and before <= lost[0] < end,
        "RUNNING again within 3 frames": rec is not None and rec < end + 3,
        "RUNNING after the recovery": bool(np.all(running_after)),
        "reloc inliers >= reloc_min_inliers": rec is not None
        and int(metrics[rec]["n_inliers"]) >= cfg.reloc_min_inliers,
        "K1 launched on the reloc frame": rec is not None and k1[rec] > 0,
        "sim(3) keyframe ATE < 2% of extent": ate < 0.02 * extent,
        "guidance metrics finite, box centre in the image": guid_ok
        and guid_filled > 0,
        "landmark colours not grey": bool(
            ((cols[:, 0] != cols[:, 1]) | (cols[:, 1] != cols[:, 2])).any()),
    }
    for name in kernels:
        checks[f"{name} launched by the phase"] = launches[name] > 0
    run_checks(label, checks)
    return dict(launches=launches, fps=fps, reloc_ms=reloc_ms,
                reloc_frame=rec, reloc_inliers=int(metrics[rec]["n_inliers"]),
                reloc_k1_launches=k1[rec], guidance_ms=guid_ms,
                ate_pct=100 * ate / extent, keyframes=len(fns),
                lost_frames=lost.tolist())


def time_flow(torch, dev, cfg, K=K):
    """lk_flow alone at the configuration's shape (every keypoint of one
    frame tracked into the next), ms per call."""
    from sfm_tpu_torch.features.detect import detect
    from sfm_tpu_torch.features.flow import lk_flow
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    H, W = cfg.image_size
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rv, tv = strafe_trajectory(2, step=0.06, yaw_rate=0.001)
    i0, i1 = (torch.as_tensor(scene.render(K, rv[i], tv[i], H, W),
                              device=dev) for i in range(2))
    kps = detect(i0, max_keypoints=cfg.max_keypoints,
                 levels=cfg.pyramid_levels)
    res = lk_flow(i0, i1, kps.xy, kps.valid, levels=cfg.flow_levels,
                  iters=cfg.flow_iters)
    n_ok = int(res.valid.sum())
    ms = dev_ms(torch, dev, lambda: lk_flow(
        i0, i1, kps.xy, kps.valid, levels=cfg.flow_levels,
        iters=cfg.flow_iters))
    log(f"[flow] lk_flow {kps.xy.shape[0]} points on {H}x{W}: {ms:.4f} ms, "
        f"{n_ok} of {int(kps.valid.sum())} tracked")
    return ms


CLI_CAPS = dict(max_keypoints=512, max_keyframes=32, max_landmarks=8192)


def run_cli(torch, dev, H=480, W=640, K=K, n=24, resume_frames=8,
            caps=CLI_CAPS):
    """``python -m sfm_tpu_torch.cli scan`` through ``cli.main`` on an .npy
    of ``n`` RGB frames in a temporary directory, with metrics, a
    checkpoint and the overlay video; then a ``--resume`` run from that
    checkpoint on the scan's next ``resume_frames`` frames; then the PLY
    files read back.  ``caps`` are the capacity flags of both runs (the
    CLI's defaults unless given)."""
    import shutil
    import tempfile

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine import METRIC_FIELDS, RUNNING
    from sfm_tpu_torch.io import NativeY4MSource, Y4MSource, load_state
    from sfm_tpu_torch.io import read_ply
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory

    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rv, tv = strafe_trajectory(n + resume_frames, step=0.06,
                               yaw_rate=0.001)
    d = tempfile.mkdtemp(prefix="sfm_cli_")
    try:
        p = lambda name: f"{d}/{name}"  # noqa: E731
        stack = np.stack([scene.render(K, rv[i], tv[i], H, W, rgb=True)
                          for i in range(n + resume_frames)]).astype(np.uint8)
        np.save(p("scan.npy"), stack[:n])
        np.save(p("more.npy"), stack[n:])
        cam = ["--fx", str(K[0, 0]), "--fy", str(K[1, 1]), "--cx",
               str(K[0, 2]), "--cy", str(K[1, 2]), "--device", str(dev)]
        for k, v in caps.items():
            cam += ["--" + k.replace("_", "-"), str(v)]
        t0 = time.perf_counter()
        rc = cli.main(["scan", "--input", p("scan.npy"), "--output",
                       p("a.ply"), "--metrics", p("a.jsonl"),
                       "--checkpoint", p("a.npz"), "--video", p("a.y4m"),
                       *cam])
        sync(torch, dev)
        scan_s = time.perf_counter() - t0
        rc2 = cli.main(["scan", "--input", p("more.npy"), "--output",
                        p("b.ply"), "--metrics", p("b.jsonl"),
                        "--checkpoint", p("b.npz"), "--resume", p("a.npz"),
                        *cam])
        # the configuration the CLI builds: the capacities at the frames'
        # size
        cfg = SfMConfig(image_height=H, image_width=W, **caps)
        out = {}
        for run, frames in (("a", n), ("b", resume_frames)):
            xyz, rgb = read_ply(p(f"{run}.ply"), native=True)
            xyz_np, rgb_np = read_ply(p(f"{run}.ply"), native=False)
            st = load_state(p(f"{run}.npz"), cfg, "cpu")
            lines = [json.loads(ln) for ln in open(p(f"{run}.jsonl"))]
            out[run] = dict(points=len(xyz), landmarks=int(st.lms.valid.sum()),
                            max_abs=float(np.abs(xyz).max()) if len(xyz)
                            else 0.0, lines=lines, frames=frames,
                            same_read=np.array_equal(xyz, xyz_np)
                            and np.array_equal(rgb, rgb_np))
        video = list(Y4MSource(p("a.y4m")))
        video_native = list(NativeY4MSource(p("a.y4m")))
    finally:
        shutil.rmtree(d)
    keys = [f[0] for f in METRIC_FIELDS]
    a, b = out["a"], out["b"]
    log(f"[cli] scan of {n} frames {scan_s:.3f} s ({n / scan_s:.3f} frames/s, "
        f"per-frame, overlay video); {a['points']} points (max |xyz| "
        f"{a['max_abs']:.3f}); resume of {resume_frames} frames: "
        f"{b['points']} points; last status {a['lines'][-1]['status']} / "
        f"{b['lines'][-1]['status']}")
    checks = {"scan and resume exit 0": rc == 0 and rc2 == 0}
    for run, r in out.items():
        checks.update({
            f"{run}: PLY points == reconstruction": r["points"]
            == r["landmarks"] > 0,
            f"{run}: max |xyz| == 500 +- 1": abs(r["max_abs"] - 500) <= 1,
            f"{run}: both PLY readers agree": r["same_read"],
            f"{run}: one metrics line per frame": len(r["lines"])
            == r["frames"],
            f"{run}: metrics carry the StepMetrics keys": all(
                list(ln) == keys for ln in r["lines"]),
        })
    checks["the scan ends RUNNING"] = a["lines"][-1]["status"] == RUNNING
    checks["the resumed scan tracks on from the checkpoint"] = all(
        ln["status"] == RUNNING and ln["n_inliers"] >= 15
        for ln in b["lines"])
    checks["one video frame per input frame"] = len(video) == n
    checks["the C++ y4m reader agrees"] = len(video_native) == n and all(
        np.array_equal(u[0], v[0]) and np.array_equal(u[1], v[1])
        for u, v in zip(video, video_native))
    run_checks("cli", checks)
    return dict(scan_s=scan_s, fps=n / scan_s, points=a["points"],
                resume_points=b["points"])


def main(argv):
    calls = "--calls" in argv
    if calls:
        # time another tree's sfm_tpu_torch (e.g. a git archive of the
        # parent commit) with this script's code
        tree = argv[argv.index("--calls") + 1:][:1] or ["."]
        sys.path.insert(0, tree[0])
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    from sfm_tpu_torch import native
    if calls:
        log(f"timing the calls of {native.__file__}")
        print(json.dumps({"calls": time_calls(torch, dev)}))
        print(card[0])
        return 0
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    native.library()
    log(f"kernel build: {native.BUILD_INFO['seconds']:.2f} s "
        f"({native.BUILD_INFO['path']})")
    log(native.BUILD_INFO.get("ptxas", ""))
    from sfm_tpu_torch.config import FLAGSHIP, SLICE, SfMConfig
    k1_calls = []
    flagship = run_slice(torch, dev, SfMConfig(**FLAGSHIP), "flagship",
                         MAIN_PATH, k1_calls=k1_calls)
    dense = run_slice(torch, dev, SfMConfig(**SLICE), "dense",
                      ("hamming_match", "patch_sampler"))
    bench, bench_once = run_bench_ba(torch, dev)
    live = run_live(torch, dev, SfMConfig(**FLAGSHIP), MAIN_PATH)
    flow_cfg = SfMConfig(**FLAGSHIP, track_with_flow=True)
    flow = run_slice(torch, dev, flow_cfg, "flow", MAIN_PATH, n_frames=30)
    flow["lk_flow_ms"] = time_flow(torch, dev, flow_cfg)
    cli = run_cli(torch, dev)
    # the kernels against their plain versions, with the timings under
    # torch.profiler last: a profiler session leaves the host slower for
    # the host-bound phases after it
    rows = check_kernels(torch, dev)
    k1_sites = k1_by_site(torch, k1_calls)
    if sum(r["calls"] for r in k1_sites.values()) \
            != flagship["launches"]["hamming_match"]:
        raise AssertionError("K1: the recorded calls are not the scan's "
                             "launches")
    rows.update(check_ba_kernels(torch, dev))
    bench.update(bench_ba_device(torch, bench_once))
    kernels = []
    for name, source, replaces in KERNEL_ROWS:
        r = rows[name]
        measured = ("ms", "plain_ms") + (
            ("library_ms",) if name == "patch_sampler" else ())
        unrecorded = [k for k in measured if r[k] is None]
        if unrecorded:
            raise AssertionError(f"{name}: torch.profiler recorded no device "
                                 f"time for {unrecorded}")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=flagship["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"],
            event_ms=r["event_ms"], plain_event_ms=r["plain_event_ms"],
            ops_per_call=r["ops_per_call"]))
    print(json.dumps({
        "flagship": {k: v for k, v in flagship.items() if k != "launches"},
        "dense": {k: v for k, v in dense.items() if k != "launches"},
        "dense_launches": dense["launches"], "run_large_ba": bench,
        "k1_bounds": {r["shape"]: dict(bound_ms=r["bound_ms"],
                                       bound_by=r["bound_by"])
                      for r in rows["hamming_match"]["per_shape"]},
        "k1_by_site": k1_sites,
        "k1_lost_ms_per_scan": sum(r["lost_ms"] for r in k1_sites.values()),
        "live": live, "flow": {k: v for k, v in flow.items()
                               if k != "launches"}, "cli": cli,
        "per_shape": {k: r["per_shape"] for k, r in rows.items()
                      if "per_shape" in r}}))
    print(json.dumps({"kernels": kernels}))
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
