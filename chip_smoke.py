"""GPU smoke run of the PyTorch/CUDA port (sfm_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --calls DIR   # K1 / K5 call times of DIR's package
    python3 chip_smoke.py --ring N      # the ring phase alone, N runs
    python3 chip_smoke.py --fleet N     # the fleet phase alone, N runs
    python3 chip_smoke.py --dist        # the dist phase alone
    python3 chip_smoke.py --raytrace    # the raytrace and anchor phases
    python3 chip_smoke.py --sanitize-target   # the kernel driver alone
    python3 chip_smoke.py --pose        # the pose refinement kernel alone

1. requires CUDA (exits non-zero without a card) and prints the card's
   name and power limit;
2. builds the CUDA kernels from sfm_tpu_torch/csrc (one nvcc per source,
   all in parallel, sm_90a);
2a. "sanitize": the kernel driver (``sanitize_target``) launches every
   __global__ function of csrc/ through the port's wrappers, at the main
   path's shapes (K1's five and the fleet's 64x512x512, K5 on a frame's
   canvas and on 4 canvases, K2 / K3 in every mode at C=32 L=2048 and
   C=512 L=16384, kmax 8) and at edge shapes (K1: 37x53, 1x1, B=3 with
   an expanded operand, every source or target invalid, centres far out,
   NaN and inf, the cells route at 37x53 and at 2048 targets; K5: centres
   within 16 px of every border and past it, a batch of 3 x 37 on
   97x211; K2 / K3: C=1, L=37, kmax 1, 16 and 40, empty rows, camera
   indices -1 and C + 3), each call twice inside guard bands of two
   poisons: every input copied into the middle of a buffer of poison and
   every torch.empty of the wrappers made so (``guarded_run``); a band
   or an input written, the two runs unequal, or a result unequal to the
   plain version fails; K1's wrapper must refuse an empty batch; every
   function must be launched.  Then compute-sanitizer (found as nvcc is,
   its absence raises) runs ``chip_smoke.py --sanitize-target`` under
   memcheck, racecheck, initcheck and synccheck with the port's
   functions only and PyTorch's caching allocator off, each exiting 0
   with 0 errors and every function launched; a card the tool answers
   "Device not supported" for is recorded, and the tools are not run;
3. drives the main path: SfMEngine.add_frames on the synthetic 80-frame
   480x640 strafe scan (the JAX package's bench.py workload) under the
   FLAGSHIP configuration (the large implicit-Schur BA solver), on the card,
   and checks tracking, keyframes, trajectory accuracy (sim(3) keyframe ATE
   against the ground-truth poses), finite landmarks, no NaN in any
   floating tensor of the state (every slot) or the metrics after any
   chunk (``feed_chunks``, off the clock; every add_frames scan of
   ``run_slice`` and the raytrace scan walk so), and that K1, K5, K2,
   K3 and K3-gather were launched by the run (K1's launches also by call
   site);
4. the same scan under SLICE (the dense BA solver), with its own checks,
   twice: the rerun must give the same statuses, keyframes and landmarks
   bit for bit (the solver sums in a fixed order);
5. the large solver's second entry point, run_large_ba, at bench_ba.py's
   operating point (1000 cameras, 100k landmarks, 8 LM x 25 CG
   iterations): ms per LM iteration, and the cost must decrease;
6. "live": FLAGSHIP on RGB frames through per-frame SfMEngine.add_frame
   (scan guidance in the step): 40 strafe frames, max_lost_frames + 2
   blank frames, 20 more; the engine must go LOST, relocalize through K1
   and P3P within 3 frames, and meet the ATE, guidance and colour checks;
7. "flow": FLAGSHIP with track_with_flow on 30 frames, and lk_flow timed;
8. "cli": ``cli.main(["scan", ...])`` on the card with metrics, checkpoint
   and overlay video, then a --resume run, then the PLY files read back
   (the C++ runtime is built before the clock starts);
8a. "pipeline": the offline scan frame by frame through
   parallel.pipeline.AsyncMappingEngine (merge_lag 2: the mapping pass on a
   worker thread's own CUDA stream, merged after two tracked frames), then
   flush; twice, and once through SfMEngine.add_frame for the inline rate
   beside it; the offline checks, the merged links and view counts, K2 /
   K3 / K3-gather launched only from the mapping stream, and the rerun
   equal bit for bit; prints frames/s, the mapping passes' ms and the
   share of their time hidden behind tracking; then the scan's first 24
   frames with tracking on the CPU and the mapping pass on the card
   (``track_device="cpu"``: S0 copied to the card at each dispatch, M
   back at each join), with the offline checks and every K2 / K3 /
   K3-gather launch from the mapping stream;
8b. "serve": serving.ScanServer on 127.0.0.1 on the card with two clients
   at once (threads), each INIT with FLAGSHIP minus its image size, 40
   uint8 RGB strafe frames (16 by FRAME, 24 by FRAMES in chunks of
   keyframe_time_lag), GET_CLOUD, CLOSE; each served scan equal to the
   same frames fed in-process to SfMEngine (every frame's metrics, the
   keyframes, the cloud bit for bit), the cloud coloured, the kernels
   launched, and FRAME before INIT answered with MSG_ERROR; prints the
   round trip per frame beside in-process add_frame and the aggregate
   frames/s;
9. "cg": the offline scan under FLAGSHIP with ``ba_solver="cg"`` (the
   per-observation PCG solver, torch ops), 40 frames, with the SLICE
   checks and its mapping pass beside the large and dense solvers';
10. "longscan": LONGSCAN (benchmarks/bench_longscan.py's LARGE: 512
   keyframes, 65536 landmarks, windowed-local mapping BA, global BA every
   32 keyframe insertions) on bench_longscan's serpentine sweep, 512 of
   its 2048 frames through add_frames in chunks of 4, each chunk rendered
   just before it is fed (by three processes ahead of the engine), ended
   by two global_ba calls; checks RUNNING, keyframes, the global BA
   schedule and costs, K2 / K3 / K3-gather in every global BA call, K1 and
   K5, and the ATE; prints the time split into tracking, mapping passes
   and global BA, and global BA ms per LM iteration; K1's calls are
   recorded by call site, as in the FLAGSHIP scan;
11. "ring": RING (benchmarks/bench_loop_closure.py's configuration:
   LONGSCAN with a loop probe every 8 keyframe insertions) on its
   outward-looking orbit, all 1280 frames, as the long scan is driven;
   besides the long scan's checks (the ATE under 5%): at least one loop
   closure, every closure past 300 degrees of the orbit, the end-of-loop
   drift after the final global BA under 1.2 m, two global BA calls per
   closure, none raising its cost, with K2 / K3 / K3-gather, and two K1
   launches per probe at the probe's call site (whose calls are
   recorded); prints the closures, the drift before and after the final
   global BA, the split with loop probes and closures as their own phases
   and the host ms per probe and per closure;
12. "fleet": benchmarks/bench_multiscan.py --flagship field for field:
   MultiScanDriver(FLAGSHIP, batch=64, bucket=8) on its 64 scans (scan b:
   SpriteScene seed 100 + b, strafe step 0.06 + 0.004 (b % 8)), 40 of its
   48 frames in chunks of keyframe_time_lag staged as uint8; chunk 0
   untimed, the others timed, then probe_loops; then scan 0 alone as a
   fleet of one; checks: every scan bootstraps, >= 90% of the
   scan-frames after chunk 0 RUNNING, each scan's ATE under 2%, no
   pending mapping slot after a chunk, no loop closed, exactly 2 K1 and
   1 K5 launches in every batched tracking step (in the fleet of 64 and
   in the fleet of one), scan 0 alone with the same statuses, keyframes
   (+-1) and poses within FLEET_CENTRE_TOL / FLEET_ROT_TOL; prints aggregate frames/s
   beside the FLAGSHIP single-scan rate of this run, the time split and
   max_memory_allocated; K1's calls in the timed tracking steps are
   recorded;
12a. "dist": distributed BA and the sharded fleet over torch.distributed.
   The pod (benchmarks/bench_dist_model.py's 5120 cameras, 2**20
   landmarks, kmax 8, by benchmarks/bench_dist_scaling.py's generator;
   8.4 M observations) through ``build_dist_large_ba``, 10 LM x 25 CG,
   its tables from ``partition_tables(device=)``: as a world of one
   under NCCL (torchrun's variables, ``initialize_hosts`` and
   ``make_scan_map_mesh`` on their defaults), then as 4 gloo ranks
   sharing the card (NCCL refuses two ranks on one card), mesh (1, 4);
   checks: the cost falls, every rank's poses equal bit for bit, 4 ranks
   against 1 within 1e-3 in rvec and 1% in the final cost, K2 / K3 /
   K3-gather launched on every rank exactly as the loop runs them;
   prints the host ms per LM iteration and per CG all-reduce.  The same
   4 ranks run ``build_dist_ba`` on a FLAGSHIP-width dense problem (32
   keyframes, 2048 landmarks), held to ``run_ba`` at
   tests/test_parallel.py's limits, and ``dryrun_multichip(4)``.  Then 2
   gloo ranks step the fleet phase's first 8 scans, 10 frames, through
   ``build_sharded_step`` (each rank's block left by
   ``shard_batched_state``'s default on the card it was made on): each
   rank's 4 scans equal a fleet of those 4 in one process bit for bit,
   with 2 K1 and 1 K5 launches per batched tracking step; rank 0's K1
   calls at the tracking step are recorded;
12b. "raytrace": benchmarks/bench_independent_accuracy.py's workload field
   for field on the card: FLAGSHIP through a real lens model (the engine
   given the distortion coefficients), 60 frames of 480x640 rendered by
   the ray-traced validation renderer (sfm_tpu_torch/raytrace.py: the
   24-box scene of seed 11 on its orbit arc, whole-frame lens
   distortion, sensor noise 2.5) in 7 processes, fed through add_frames
   in chunks of keyframe_time_lag; checks: RUNNING >= 90%, >= 6
   keyframes, extent > 1 m, sim(3) keyframe ATE <= 2% of it, Kopt != K,
   K1, K5, K2, K3 and K3-gather launched; then "acceptance":
   benchmarks/bench_acceptance.py's step on the same 60 frames, written
   as a y4m: ``python -m sfm_tpu_torch.cli scan --chunk 10`` with its
   command line as a subprocess on the card, and its gates (RUNNING on
   >= 90% of the metrics lines, >= 5 keyframes in the checkpoint, extent
   > 1 m, sim(3) ATE <= 2%, >= 85% of the live landmarks within 0.15 m
   of a scene surface, the PLY holding exactly the live landmarks with
   colours; a non-zero exit fails);
12c. "anchor": every port solver (run_ba, run_ba_cg, run_large_ba with
   precond "jacobi_u" and "schur_diag") on the card against the float64
   reference solver (sfm_tpu_torch/ba/reference.py, numpy on the host,
   computed in a process of its own during the raytrace phase) on
   tests/test_ba_reference.py's 4x60 and 10x300 problems and one at
   FLAGSHIP's BA width (32 cameras, 2048 landmarks, kmax 8): final cost
   within 1%, free rvecs within 2e-3, tvecs within 5e-3, K2 / K3 /
   K3-gather launched; then run_large_ba at bench_ba's problem with
   precond="schur_diag" twice beside "jacobi_u": the cost must fall and
   the rerun repeat bit for bit (ms per LM iteration printed, no speed
   gate);
13. holds each kernel against its plain PyTorch version at the main path's
   shapes and times both, in device time (torch.profiler) and with CUDA
   events, beside the kernel's bound (bytes over the memory rate or
   operations over the core rate, from this run's inputs; the card's clock
   raised by a busy burst before each profile): K1 bit for bit (raw
   outputs and MatchResult) and timed as the whole match_features_pallas
   call, three device ops, at its five shapes (relocalization's
   windowless 8192x512 match included), with the route its rule did not
   pick held and timed too where the window admits both; K1 again on the
   FLAGSHIP scan's and the long scan's own calls and on the ring's loop
   probe calls (65536 windowless sources) and on the fleet's batched
   calls (64x512x512, 64x2048x512), replayed by call site
   and route (bit for bit, device time per call beside the plain
   version's, bound, the other route, device time lost per scan); K5 bit
   for bit (with F.grid_sample at the same sample
   positions as the library yardstick), also at the fleet's batch of 64
   canvases, and the BA kernels K2
   (linearizer) and K3 (Schur apply:
   full, gather and scatter modes) within 1e-4 of the largest entry and
   bit-identical on a rerun, at the flagship's mapping-BA shape (dead rows
   included), at benchmarks/bench_ba.py's 1000-camera problem and, for
   equality only, at its layout with 4096 cameras, and K2 / K3 /
   K3-gather at the pod's two shapes (5120 cameras, kmax 8: the world of
   one's 2**20 landmarks, a gloo rank's shard of 262144); K1 on the
   sharded fleet's rank 0's own tracking calls and K5 on its block's
   canvases (4 scans x 512 keypoints); then run_large_ba once
   more under the profiler; then global BA on the long scan's state (host
   and device ms per LM iteration), and K2, K3 full and K3-gather on the
   long scan's own last global-BA and mapping-pass problems, where the
   witness is the plain version run in float64 (the kernel no farther
   from it, in root mean square, than twice the f32 plain version; K2's
   gradients also entry by entry, each within GRAD_TOL of the magnitude
   of its own terms); then
   the long scan's last 8 frames fed again from the state before them
   under torch.profiler, for the card's busy share, and the fleet's last
   chunk (its tracking steps alone, then the whole chunk) and the
   pipeline's scan likewise.  This comes last
   because a profiler session leaves the host slower for the host-bound
   phases after it (and a long one disturbs the sessions after it);
   "pose" (``run_pose``, with the kernel checks): csrc/pose.cu at the
   main path's calls (POSE_SHAPES: the tracking PnP's gated rounds and
   the refinement at 512 matches, the fleet's 64 x 512, relocalisation
   at 8192 slots and the loop probe at 65536) against its plain version
   on the card, every pose's final cost by the pose check
   (``pose_within``), its device time beside its bound, the host's time
   to return from the call and the plain version's synchronised time;
   then the same check on far-started problems, which the kernel must
   pass and two planted faults (one iteration fewer, the first gated
   round alone) must fail (``pose_faults``);
13a. "helpers", on the FLAGSHIP scan's final engine: ``match_pairs`` on
   K1's MatchResult at the tracking shape (512x512) against the plain
   matcher's pairs, exactly; ``run_ba`` in POSE_ONLY and STRUCT_ONLY on
   the final map (the cost must not rise, ``total_cost`` must give the
   solver's costs, the frozen block must come back bit for bit);
   ``ransac_homography`` on a plane's matches against its CPU run with
   the same samples; ``remove_keyframe`` of the newest keyframe; one more
   frame tracked inside ``utils.device_trace``, whose trace must hold a
   K1 or K5 kernel event (after every profiled measurement: the trace is
   a profiler session);
14. prints a JSON line with the phases' numbers, a JSON line with the
   kernels' numbers (the six kernels, with their launches by phase, the
   dist phase's over every rank; then K2 / K3 / K3-gather at the long
   scan's two shapes and at the pod's two shapes, then K1 at the long
   scan's call sites, at the
   ring's loop probe and at the fleet's two sites, then K5 at the fleet's
   shape, then K1 and K5 at the sharded fleet's per-rank batch, then the
   pose kernel at POSE_SHAPES, with the launches of the phase that makes
   each call, counted by call site and shape, and by phase), then the
   card line, then {"ok": true, "device":
   {...}} as the last line.
With ``--calls DIR`` it only times K1's whole call at its five shapes and
K5's call (device time and device ops per call) for the sfm_tpu_torch
package under DIR, and prints them as JSON and the card line: the way to
compare two commits in one run on one card.  With ``--ring N`` it runs
only the ring phase, N times, and prints each run's checks and numbers
as a JSON line, then the card line (exit 1 when a run failed a check):
the spread of a scan over runs, and whether the runs' final maps agree
bit for bit (exit 1 when they do not).  ``--fleet N``
runs one FLAGSHIP single scan (for the rate beside the fleet's) and the
fleet phase N times, likewise.  ``--dist`` runs the dist phase and its
kernel rows (the pod's two shapes, the sharded fleet's batch) alone, and
``--raytrace`` the raytrace phase (with its acceptance step) and the
anchor phase alone; ``--pose`` the pose phase alone.
``--sanitize-target`` runs only the kernel driver and prints its
launches by function as JSON (no card line): the program to run under
compute-sanitizer, e.g. ``PYTORCH_NO_CUDA_MEMORY_CACHING=1
compute-sanitizer --tool memcheck --error-exitcode 99 --kernel-name
'regex=dense_kernel|cells_kernel|init_keys|epilogue_kernel|patch_kernel|landmark_phase|camera_phase'
python3 chip_smoke.py --sanitize-target``.
Any failed check raises, and the script exits non-zero."""

import contextlib
import json
import subprocess
import sys
import tempfile
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
# K2's gradients on a scan's own problems, entry by entry: the distance
# from the plain version run in float64 over the entry's own term
# magnitude (``_gradient_terms``), at most this.  On the long scan's last
# global-BA and mapping problems (NVIDIA H100 80GB HBM3, 700 W) the f32
# versions read at most 1.5e-7 on g_cam (2.4 units of f32 rounding; a
# camera sums hundreds of terms, whose rounding partly cancels) and 2.5e-6
# on g_lm (42 units; a landmark sums at most kmax).  Each limit leaves 3x
# or more.  An observation missing from an entry moves it by about
# |r| / |uv| / (its observations) of its magnitude: ~5e-6 for a camera
# with 350 observations at 0.5 px residuals, ~5e-4 for a landmark.  Both
# f32 versions sum p = R X + t in float64: in float32 a keyframe ~50 units
# from the world's origin lost a near point's depth to cancellation, and
# g_cam read up to 1.4e-6 (kernel) and 9.9e-7 (f32 plain) on that problem.
GRAD_TOL = {"g_cam": 2.0 ** -20, "g_lm": 2.0 ** -17}
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
# K1 calls a profiler session times in the replay of a scan's calls
K1_REPLAY_BATCH = 128
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
              ops_ok=float.is_integer, counts=None):
    """Device milliseconds per call of ``fn``: the self device time of
    every device op torch.profiler records over ``reps`` calls, summed (all
    the kernels and copies a wrapper launches), after warm_clocks.  A
    session now and then records no device event at all, or drops some;
    it is repeated, up to ``attempts`` sessions, and None returned when
    none was whole.  A session is whole when it recorded a device event
    and ``ops_ok(device ops per call)`` holds: by default a whole number
    of ops per call (a session that dropped events rarely leaves one).
    ``by_kernel``, a dict, receives the same per kernel name; ``counts``,
    a dict, the device ops per call by kernel name; ``ops``, a dict, the
    device ops per call under "per_call"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        warm_clocks(torch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times, names, count = {}, {}, 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None) \
                or getattr(e, "self_cuda_time_total", 0)
            if t > 0:
                name = _short(e.key)
                times[name] = times.get(name, 0.0) + t / reps / 1e3
                names[name] = names.get(name, 0) + e.count / reps
                count += e.count
        if times and ops_ok(count / reps):
            if by_kernel is not None:
                by_kernel.update(times)
            if counts is not None:
                counts.update(names)
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
    only pixels it reads; per canvas for a batch [B, Hc, Wc]), cx and cy
    read once, the patches written once; 9 operations (6 multiplies, 3
    adds) per patch value."""
    from sfm_tpu_torch.features.patches_pallas import PATCH, PATCH_RADIUS
    Hc, Wc = canvas_s.shape[-2:]
    cx2, cy2 = cx.reshape(-1, cx.shape[-1]), cy.reshape(-1, cy.shape[-1])
    rr = torch.arange(PATCH + 1, device=cx.device)
    xs = torch.floor(cx2).long()[..., None] - PATCH_RADIUS + rr
    ys = torch.floor(cy2).long()[..., None] - PATCH_RADIUS + rr
    inside = (((ys >= 0) & (ys < Hc))[..., :, None]
              & ((xs >= 0) & (xs < Wc))[..., None, :])
    base = torch.arange(cx2.shape[0], device=cx.device)[:, None, None, None]
    covered = torch.zeros(cx2.shape[0] * Hc * Wc, dtype=torch.bool,
                          device=cx.device)
    covered[((base * Hc + ys[..., :, None]) * Wc
             + xs[..., None, :])[inside]] = True
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


def ba_bound(name, lm_cam, lm_w, C):
    """The bound of a BA kernel on a table lm_cam / lm_w [L, kmax]: its
    inputs read and outputs written once (f32 / int32; K3 with g and x
    given), and its flops on the live slots (K2 ~300 per slot; K3 36 per
    slot and half of the full mode, 18 per landmark for Vinv t)."""
    L, kmax = lm_cam.shape
    slots, live = L * kmax, int((lm_w != 0).sum())
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


def _to_f64(torch, *ts):
    return [t.double() if torch.is_tensor(t) and t.is_floating_point() else t
            for t in ts]


def _gradient_terms(torch, args, dtype):
    """The per-observation terms of K2's gradients, as its plain version
    forms them, in ``dtype``: (cam [O], lm [O], the g_cam terms [O, 6], the
    g_lm terms [O, 3], their magnitudes [O, 6] and [O, 3]).  A term's
    magnitude is |J|^T w (|r| + |uv|): the pixels whose difference makes
    the residual r enter at their own size, so this bounds what rounding
    them leaves in the term, however small r is."""
    from sfm_tpu_torch.ba.residuals import (Observations, huber_weights,
                                            residuals_and_jacobians)
    K, R, t, X, lm_free_f, cam_free_f, lm_cam, lm_uv, lm_w, huber = [
        a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args]
    C = R.shape[0]
    L, kmax = lm_cam.shape
    cam = lm_cam.reshape(-1).to(torch.int64).clamp(0, C - 1)
    lm = torch.arange(L, device=X.device).repeat_interleave(kmax)
    uv = lm_uv.reshape(-1, 2)
    obs = Observations(cam, lm, uv, lm_w.reshape(-1))
    r, A, B = residuals_and_jacobians(K, R, t, X, obs)
    w = obs.w * huber_weights(r, huber)
    live = (obs.w != 0)[:, None]
    A = A * (w * cam_free_f[cam])[:, None, None]
    B = B * (w * lm_free_f[lm])[:, None, None]
    rw = (r * w[:, None])[:, :, None]
    m = ((r.abs() + uv.abs()) * w.abs()[:, None])[:, :, None]
    zero = torch.zeros((), dtype=dtype, device=X.device)
    return (cam, lm,
            torch.where(live, -(A.transpose(1, 2) @ rw)[..., 0], zero),
            torch.where(live, -(B.transpose(1, 2) @ rw)[..., 0], zero),
            torch.where(live, (A.abs().transpose(1, 2) @ m)[..., 0], zero),
            torch.where(live, (B.abs().transpose(1, 2) @ m)[..., 0], zero))


def _kernel_terms(torch, args):
    """K2's own per-observation gradient terms: one launch on the live
    observations of ``args`` laid out one to a landmark row and one to a
    camera (its pose copied), so that each g_cam and g_lm entry it returns
    is a single term, unsummed.  Returns (g_cam terms [O, 6], g_lm terms
    [O, 3]) in ``_gradient_terms``' order, zero at the empty slots."""
    from sfm_tpu_torch.ba import linearize_pallas as lp
    K, R, t, X, lm_free_f, cam_free_f, lm_cam, lm_uv, lm_w, huber = args
    kmax = lm_cam.shape[1]
    o = torch.nonzero(lm_w.reshape(-1) != 0)[:, 0]
    cam, lm, n = lm_cam.reshape(-1)[o].long(), o // kmax, len(o)
    ids = torch.arange(n, dtype=torch.int32, device=X.device)[:, None]
    out = lp.ba_linearize_kernel(
        K, R[cam].contiguous(), t[cam].contiguous(), X[lm].contiguous(),
        lm_free_f[lm].contiguous(), cam_free_f[cam].contiguous(),
        ids.contiguous(), lm_uv.reshape(-1, 2)[o][:, None].contiguous(),
        lm_w.reshape(-1)[o][:, None].contiguous(), huber)
    tc = X.new_zeros((lm_w.numel(), 6)).index_copy_(0, o, out[4])
    tl = X.new_zeros((lm_w.numel(), 3)).index_copy_(0, o, out[2])
    return tc, tl


def gradient_witness(torch, label, args, kern, plain, exact):
    """K2's g_cam and g_lm entry by entry: each entry's distance from the
    plain version run in float64 (``exact``), over the magnitude of its own
    terms (``_gradient_terms``), for the kernel (``kern``), the f32 plain
    version (``plain``), and each one's terms summed in float64 (what
    rounding its terms alone leaves; the kernel's from ``_kernel_terms``);
    each at most GRAD_TOL of the output.  Logs the kernel's worst entry:
    its camera or landmark, observations, value and each distance.
    Returns {output: readings}."""
    cam, lm, tc, tl, *_ = _gradient_terms(torch, args, torch.float32)
    *_, mc, ml = _gradient_terms(torch, args, torch.float64)
    kc, kl = _kernel_terms(torch, args)
    C, L = args[1].shape[0], args[3].shape[0]
    live = (args[8].reshape(-1) != 0).double()
    f64 = dict(dtype=torch.float64, device=live.device)
    out = {}
    for name, j, idx, terms, kterms, mag, n in (
            ("g_cam", 4, cam, tc, kc, mc, C), ("g_lm", 2, lm, tl, kl, ml, L)):
        def summed(x):
            return torch.zeros((n, x.shape[1]), **f64).index_add_(
                0, idx, x.double())
        scale = summed(mag)
        n_obs = torch.zeros(n, **f64).index_add_(0, idx, live)
        ref = exact[j]
        dist = {k: (v.double() - ref).abs() / scale.clamp(min=1e-30)
                for k, v in (("kernel", kern[j]), ("f32 plain", plain[j]),
                             ("kernel terms", summed(kterms)),
                             ("f32 terms", summed(terms)))}
        e, c = divmod(int(torch.argmax(dist["kernel"])), terms.shape[1])
        r = dict(entry=(e, c), obs=int(n_obs[e]), value=float(ref[e, c]),
                 scale=float(scale[e, c]), largest=float(ref.abs().max()),
                 max={k: float(v.max()) for k, v in dist.items()},
                 abs_at_worst={k: float(v[e, c] * scale[e, c])
                               for k, v in dist.items()})
        out[name] = r
        log(f"  {name} {label}: distance from f64 over the entry's own term "
            f"magnitude, max (kernel / f32 plain / kernel terms and f32 terms"
            f" summed in f64) "
            + " / ".join(f"{v:.2e}" for v in r["max"].values())
            + f" (tolerance {GRAD_TOL[name]:.2e}); the kernel's worst entry "
            f"[{e}, {c}] ({r['obs']} observations): value {r['value']:.4e}, "
            f"term magnitude {r['scale']:.4e} (largest entry "
            f"{r['largest']:.4e}), distance "
            + " / ".join(f"{v:.3e}" for v in r["abs_at_worst"].values()))
    bad = {k: v["max"] for k, v in out.items()
           if not max(v["max"].values()) <= GRAD_TOL[k]}
    if bad:
        raise AssertionError(f"ba_linearize {label}: gradient entries "
                             f"farther from f64 than {GRAD_TOL} of their "
                             f"term magnitude: {bad}")
    return out


def ba_kernel_rows(torch, label, args, cs, timed_shape,
                   names=("ba_linearize", "schur_apply", "schur_gather",
                          "schur_scatter"), witness=False):
    """K2 and the K3 modes of ``names`` against their plain versions on
    one problem: ``args`` are K2's (K, R, t, xyz, lm_free_f, cam_free_f,
    lm_cam, lm_uv, lm_w, Huber delta), ``cs`` the table's camera_slots;
    K3 runs on the plain K2's W, V (damped at 1e-3) and g_lm with a random
    x.  Each kernel is run twice and must give the same bits, and be
    within BA_REL_TOL of the largest entry of the plain output; or, with
    ``witness`` (a scan's own problems: near a converged map the
    gradients are sums of much larger terms that cancel, so both f32
    versions' errors are the rounding of the residuals, up to 4% of the
    largest entry of g_lm in a mapping pass), no farther from the plain
    version run in float64 than twice the f32 plain version's distance,
    in root mean square over the output's entries, plus 1e-6 of its
    largest entry; and K2's g_cam and g_lm also entry by entry, each
    within GRAD_TOL of its own term magnitude (``gradient_witness``).  With
    ``timed_shape`` each is timed with torch.profiler beside its bound and
    the earlier design's time.  Returns {name: row}."""
    from sfm_tpu_torch.ba import linearize_pallas as lp
    from sfm_tpu_torch.ba import schur_pallas as sp
    C = args[1].shape[0]
    lm_cam, lm_w = args[6], args[8]
    rows = {}

    def to_largest(a, ref, rms=False):
        ref = ref.double()
        d = (a.double() - ref).abs()
        d = d.pow(2).mean().sqrt() if rms else d.max()
        return float(d) / max(float(ref.abs().max()), 1e-30)

    def check(name, kern, plain, plain64):
        a, b = kern(), plain()
        sync(torch, lm_cam.device)
        if witness:
            c = plain64()
            errs = [(float((u.double() - v.double()).abs().max()),
                     to_largest(u, v)) for u, v in zip(a, b)]
            far = [(to_largest(u, w, True), to_largest(v, w, True))
                   for u, v, w in zip(a, b, c)]
            if not all(k <= 2 * p + 1e-6 for k, p in far):
                raise AssertionError(f"{name} {label}: rms from the f64 "
                                     f"plain version (kernel, f32 plain) "
                                     f"{far}")
            if name == "ba_linearize":
                grad = gradient_witness(torch, label, args, a, b, c)
        else:
            errs = [_rel_err(u, v) for u, v in zip(a, b)]
        err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        again = kern()
        same = all(torch.equal(u, v) for u, v in zip(a, again))
        if not same:
            raise AssertionError(f"{name} {label}: two launches differ")
        row = dict(shape=label, max_abs_err=err, max_rel_err=rel,
                   bit_identical=same, library_ms=None,
                   **ba_bound(name, lm_cam, lm_w, C))
        msg = (f"{name} {label}: max abs err {err:.3e} (rel {rel:.3e}"
               f"{'; ' + ' '.join(f'{e[1]:.1e}' for e in errs) if len(errs) > 2 else ''}"
               f"), rerun bit-identical")
        if witness:
            row["from_f64"] = far
            if name == "ba_linearize":
                row["gradients"] = grad
            msg += ("; rms from the f64 plain version, kernel / f32 plain: "
                    + " ".join(f"{k:.1e}/{p:.1e}" for k, p in far))
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
        rows[name] = row
        log(msg)

    check("ba_linearize", lambda: lp.ba_linearize_kernel(*args, slots=cs),
          lambda: lp.ba_linearize_plain(*args),
          lambda: lp.ba_linearize_plain(*_to_f64(torch, *args)))
    W, V, g_lm = lp.ba_linearize_plain(*args)[:3]
    Vinv = lp.damped_vinv(V, 1e-3)
    x = torch.as_tensor(np.random.default_rng(1).normal(0, 1, (C, 6)),
                        dtype=torch.float32, device=W.device)
    z_ref = sp.schur_gather_plain(lm_cam, W, Vinv, g_lm, x)
    W64, Vinv64, g64, x64, z64 = _to_f64(torch, W, Vinv, g_lm, x, z_ref)
    cases = {
        "schur_apply": (
            lambda: sp.schur_kernel("full", lm_cam, W, Vinv, g_lm, x,
                                    slots=cs),
            lambda: sp.schur_apply_fused_plain(lm_cam, W, Vinv, g_lm, x, C),
            lambda: sp.schur_apply_fused_plain(lm_cam, W64, Vinv64, g64,
                                               x64, C)),
        "schur_gather": (
            lambda: (sp.schur_kernel("gather", lm_cam, W, Vinv, g_lm, x),),
            lambda: (sp.schur_gather_plain(lm_cam, W, Vinv, g_lm, x),),
            lambda: (sp.schur_gather_plain(lm_cam, W64, Vinv64, g64, x64),)),
        "schur_scatter": (
            lambda: (sp.schur_kernel("scatter", lm_cam, W, z=z_ref,
                                     n_cams=C, slots=cs),),
            lambda: (sp.schur_scatter_plain(lm_cam, W, z_ref, C),),
            lambda: (sp.schur_scatter_plain(lm_cam, W64, z64, C),))}
    for name in names[1:]:
        check(name, *cases[name])
    return rows


def ba_kernel_args(torch, pr, huber, mask):
    """K2's arguments on a ``ba_problem`` (Huber delta ``huber``; with
    ``mask`` every 7th landmark frozen too, camera 0 being frozen
    already) and the table's camera_slots."""
    from sfm_tpu_torch.ba.large import camera_slots
    from sfm_tpu_torch.geometry.rotations import exp_so3
    tb = pr["tables"]
    lm_free = pr["lm_free"].float()
    if mask:
        lm_free[::7] = 0.0
    args = (pr["K"], exp_so3(pr["rv"]).contiguous(), pr["tv"], pr["X"],
            lm_free, pr["cam_free"].float(), tb.lm_cam, tb.lm_uv, tb.lm_w,
            huber)
    return args, camera_slots(tb.lm_cam, tb.lm_w, pr["cam_free"].shape[0])


def check_ba_kernels(torch, dev):
    """K2 and the three K3 modes against their plain versions at the
    flagship's mapping-BA shape (32 cameras, 2048 landmark rows of which
    the first 20% are live, as after compaction on the scan's map; kmax 8,
    Huber 2.0, free masks), at bench_ba.py's (1000, 100k, 6) and, for
    equality only, at bench_ba's layout with 4096 cameras (above the camera
    caps of the earlier shared-memory design), with ``ba_kernel_rows``."""
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
    for label, C, L, kmax, huber, mask, extra, timed_shape in shapes:
        pr = ba_problem(torch, dev, C, L, kmax, **extra)
        args, cs = ba_kernel_args(torch, pr, huber, mask)
        log(f"[BA kernels] {label}: {pr['n_obs']} observations")
        for name, row in ba_kernel_rows(torch, label, args, cs,
                                        timed_shape).items():
            per[name].append(row)
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

    def once(precond="jacobi_u"):
        return run_large_ba(pr["K"], pr["rv"], pr["tv"], pr["X"],
                            pr["tables"], cam_free=pr["cam_free"],
                            lm_free=pr["lm_free"], iterations=iterations,
                            cg_iterations=cg_iterations, tol=0.0,
                            precond=precond)

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
    iteration, and that of the K2 / K3 phases by kernel; then one with
    precond="schur_diag" (its device ms per LM iteration)."""
    parts = {}
    dev_iter = (device_ms(torch, once, 1, parts) or float("nan")) / iterations
    ba = {k: v / iterations for k, v in parts.items()
          if k.startswith(("landmark_phase", "camera_phase"))}
    log(f"run_large_ba under torch.profiler: device {dev_iter:.3f} ms per LM "
        f"iteration, of which the K2 / K3 phases {sum(ba.values()):.3f} ms ("
        + ", ".join(f"{k} {v:.3f}" for k, v in ba.items()) + ")")
    sd_iter = (device_ms(torch, lambda: once(precond="schur_diag"), 1)
               or float("nan")) / iterations
    log(f"run_large_ba precond=schur_diag under torch.profiler: device "
        f"{sd_iter:.3f} ms per LM iteration (jacobi_u {dev_iter:.3f})")
    return dict(device_ms_per_lm_iter=dev_iter, ba_kernels_ms_per_lm_iter=ba,
                schur_diag_device_ms_per_lm_iter=sd_iter)


def _kept(torch, t):
    """A copy of a recorded K1 operand; an expanded one (batch stride 0)
    stays expanded."""
    if not torch.is_tensor(t):
        return t
    if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
        return t[:1].clone().expand_as(t)
    return t.clone()


def count_k1_sites(native, record=None, record_sites=None):
    """Wrap the matcher entry of each engine module so that K1's launches
    are also counted by calling function ("module.function"); returns the
    counts and a function that undoes the wrapping.  The wrapper counts
    what the kernel's own counter adds, nothing else.  With a list
    ``record``, each K1 call also appends (site, a copy of the kernel's
    arguments), taken at the K1 dispatch ``match_pallas.hamming_match``,
    for the replay in ``k1_by_site``; with ``record_sites`` (site name
    prefixes), only the calls of those sites."""
    import importlib

    import torch

    from sfm_tpu_torch.features import match_pallas as mp
    sites, undo, current = {}, [], [None]
    for stem in ("bootstrap", "tracking", "mapping", "reloc", "loop"):
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
            if record_sites is None or (current[0] or "").startswith(
                    tuple(record_sites)):
                record.append((current[0], tuple(_kept(torch, x) for x in a)))
            return dispatch(*a)
        mp.hamming_match = recorded
        undo.append((mp, "hamming_match", dispatch))

    def restore():
        for mod, name, real in undo:
            setattr(mod, name, real)
    return sites, restore


def count_pose_sites(native):
    """Wrap the pose refinement's entries in the engine modules that call
    them (the tracking PnP and refinement, relocalisation, the loop probe)
    so that the pose kernel's launches are also counted by calling
    function and shape: ("module.function", poses, points) -> launches.
    Returns the counts and a function that undoes the wrapping.  The
    wrapper counts what the kernel's own counter adds, nothing else."""
    import importlib
    sites, undo = {}, []
    # (module, entry, the argument whose shape is [..., points])
    for stem, name, arg in (("tracking", "ransac_pnp", 4),
                            ("tracking", "refine_pose", 5),
                            ("reloc", "ransac_pnp", 4),
                            ("loop", "ransac_pnp", 4)):
        mod = importlib.import_module(f"sfm_tpu_torch.engine.{stem}")
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _stem=stem, _arg=arg, **kw):
            site = f"{_stem}.{sys._getframe(1).f_code.co_name}"
            lead = a[_arg].shape[:-1]
            if _arg == 5:  # refine_pose: the pose may carry the batch
                lead = np.broadcast_shapes(lead, a[1].shape[:-1])
            key = (site, int(np.prod(lead)), a[_arg].shape[-1])
            n0 = native.LAUNCHES["pose_refine"]
            out = _real(*a, **kw)
            n = native.LAUNCHES["pose_refine"] - n0
            if n:
                sites[key] = sites.get(key, 0) + n
            return out
        setattr(mod, name, wrapped)
        undo.append((mod, name, real))

    def restore():
        for mod, name, real in undo:
            setattr(mod, name, real)
    return sites, restore


def k1_by_site(torch, calls, scan="FLAGSHIP"):
    """K1 on a scan's own calls (``calls``: (site, kernel arguments) as
    ``count_k1_sites`` recorded them), replayed after the scan, grouped by
    call site and route.  Each call is held bit for bit against the plain
    version.  Per group: the calls, the device us per call (every device
    op of the calls under torch.profiler, exactly three a call) and the
    plain version's, the bound (``k1_bound``, mean over the calls), the
    device us a call takes on the route the rule did not pick where the
    window admits both, and launches x (us - bound), the device time the
    group loses per scan."""
    from sfm_tpu_torch.features import match_pallas as mp
    groups = {}
    for site, args in calls:
        route = mp.k1_route(args[7], *args[0].shape[:2], args[3].shape[1])
        groups.setdefault((site, route), []).append(args)
    out = {}
    for (site, route), group in groups.items():
        label = f"{site} [{route}]"
        refs = [mp.match_result_plain(*args) for args in group]

        def check(what):
            for args, ref in zip(group, refs):
                for x, y in zip(mp.match_result_kernel(*args), ref):
                    if not torch.equal(x, y):
                        raise AssertionError(f"K1 {scan} {label}: {what} "
                                             f"differs from the plain version")

        def total_ms(fn, kernel=True, group=group):
            """Device ms of ``fn`` over every call of the group, profiled
            K1_REPLAY_BATCH calls a session.  For the kernel: the sum over
            its K1_MAX_OPS device ops of each op's mean time, times the
            calls, from sessions that recorded each op once a call, or
            all but one op of the session (the profiler drops one now and
            then in a session of long calls: 767 of 768 in every session
            at the long scan's widen); None where a batch had no such
            session.  For the plain version, one pass per session."""
            tot = 0.0
            for i in range(0, len(group), K1_REPLAY_BATCH):
                part = group[i:i + K1_REPLAY_BATCH]
                m, parts, per = len(part), {}, {}
                reps, want = (2 if kernel else 1), K1_MAX_OPS * m
                ms = device_ms(
                    torch, lambda part=part: [fn(*a) for a in part],
                    reps=reps, by_kernel=parts, counts=per,
                    ops_ok=(lambda c, want=want, reps=reps:
                            0 <= (want - c) * reps <= 1) if kernel
                    else float.is_integer)
                if ms is None or (kernel and (len(parts) != K1_MAX_OPS
                                              or min(per.values()) < m - 1)):
                    return None
                tot += m * sum(parts[k] / per[k] for k in parts) \
                    if kernel else ms
            return tot
        n = len(group)
        check("the kernel")
        ms = total_ms(mp.match_result_kernel)
        plain = total_ms(mp.match_result_plain, kernel=False)
        if ms is None or plain is None:
            raise AssertionError(f"K1 {scan} {label}: no whole profiler "
                                 f"session")
        bounds = [k1_bound(torch, a) for a in group]
        bound_us = 1e3 * float(np.mean([b["bound_ms"] for b in bounds]))
        by = [b["bound_by"] for b in bounds]
        row = dict(site=site, route=route, calls=n, us=1e3 * ms / n,
                   plain_us=1e3 * plain / n, bound_us=bound_us,
                   bound_by=max(set(by), key=by.count),
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
                o = total_ms(mp.match_result_kernel)
            row.update(other_route=other,
                       other_route_us=None if o is None else 1e3 * o / n)
            msg = f"; the {other} route {us(o and o / n)}"
        out[label] = row
        log(f"K1 on the {scan} scan's calls, {label}: {n} calls "
            f"{row['shapes']} radius {row['max_r']}, exact, {us(ms / n)} "
            f"device per call{msg}; plain {us(plain / n)}; bound "
            f"{row['bound_us']:.2f} us ({row['bound_by']}); lost per scan "
            f"{row['lost_ms']:.4f} ms")
    return out


def feed_chunks(torch, dev, eng, staged, label):
    """add_frames over the staged chunks, each on the clock up to a
    synchronise; after each, off the clock, ``nonfinite_fields`` of the
    engine's whole state (every slot, valid or not) and of the chunk's
    metrics: a NaN fails.  Returns (metrics, the first chunk's seconds,
    the others' seconds, {field: chunks holding an infinity}, chunks
    walked)."""
    from sfm_tpu_torch.engine.state import nonfinite_fields
    metrics, secs, infinite = [], [], {}
    for i, ch in enumerate(staged):
        t0 = time.perf_counter()
        m = eng.add_frames(ch)
        sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        metrics += m
        bad = nonfinite_fields(eng.state, "state")
        bad.update(nonfinite_fields(m, "metrics"))
        nan = {k: c for k, c in bad.items() if c[0]}
        if nan:
            raise AssertionError(f"[{label}] NaN after chunk {i} (frames up "
                                 f"to {len(metrics) - 1}): {nan}")
        for k, c in bad.items():
            infinite[k] = infinite.get(k, 0) + 1
    if infinite:
        log(f"[{label}] +-inf (no NaN) in {infinite} (field: chunks)")
    return metrics, secs[0], sum(secs[1:]), infinite, len(staged)


def run_slice(torch, dev, cfg, label, kernels, K=K, n_frames=N_FRAMES,
              k1_calls=None, keep=False):
    """add_frames over the bench.py scan in chunks of keyframe_time_lag
    frames, then the checks; every counter in ``kernels`` must have been
    launched by the scan.  K1's launches are also counted per call site,
    and its calls recorded into the list ``k1_calls`` when given.  With
    ``keep`` the engine comes back under "keep" (for the helpers
    phase)."""
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
        metrics, first_s, steady_s, infinite, walked = feed_chunks(
            torch, dev, eng, staged, label)
        launches = dict(native.LAUNCHES)
    finally:
        restore()

    digest = state_digest(eng.state)
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
        f"mapping); no NaN in the state or the metrics after any of the "
        f"{walked} chunks")

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
    out = dict(launches=launches, k1_sites=k1_sites, fps=fps,
               map_ms=float(np.mean(map_ms)),
               ate_pct=100 * ate / extent, keyframes=n_kf,
               running=running, bootstrap_frame=boot,
               ba_dropped_obs=dropped, digest=digest,
               statuses="".join(map(str, status.tolist())),
               nan_free_chunks=walked, infinite_fields=infinite)
    if keep:
        out["keep"] = eng
    return out


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


# the longscan phase: frames fed (benchmarks/bench_longscan.py feeds
# 2048), the keyframes it must insert, the BA kernels every global BA call
# must launch, and the processes that render its frames ahead of the engine
LONGSCAN_FRAMES = 512
LONGSCAN_MIN_KEYFRAMES = 64
GLOBAL_BA_KERNELS = ("ba_linearize", "schur_apply", "schur_gather")
RENDER_WORKERS = 3
# the long scan's last chunks, fed again from the state before them under
# torch.profiler for the card's busy share
TAIL_CHUNKS = 2
# the ring phase: benchmarks/bench_loop_closure.py's default orbit (1280
# frames over 1.12 turns); a closure is true only past 300 degrees of it
# (the start region's landmarks come back into view after ~330), and the
# end-of-loop drift after the final global BA must stay under 10% of the
# orbit's 12 m diameter
RING_FRAMES = 1280
RING_TURNS = 1.12
RING_CLOSURE_DEG = 300.0
RING_MAX_DRIFT = 1.2
RING_ATE = 0.05
# the fleet phase: benchmarks/bench_multiscan.py --flagship (64 scans of
# 48 frames), cut to whole chunks of keyframe_time_lag (40 frames); its
# gates: RUNNING on >= 90% of the scan-frames after the bootstrap chunk
# (the single-scan gate), and scan 0 re-run alone within these of its
# fleet run (PERF.md section 2): camera centres, after the least-squares
# scale (both runs' world is scan 0's first camera, and monocular scale
# is free), as a share of the scan's extent (the ATE gate's 2%: each run
# is held to that against the truth), and rotations in radians.  The
# runs do not agree bit for bit: the descriptor's products over 64 x 512
# rows round apart from those over 512 (another cuBLAS kernel), and
# the bootstrap's dense BA sums with atomics, parting even two runs of one
# scan; tracking carries the difference on (0.53-0.93% of the extent
# unscaled and 0.002-0.004 rad in four runs, NVIDIA H100 80GB HBM3,
# 700 W)
FLEET_BATCH = 64
FLEET_ORBIT = 48
FLEET_FRAMES = 40
FLEET_RUNNING = 0.9
FLEET_CENTRE_TOL = 0.02
FLEET_ROT_TOL = 0.01
_RENDER = {}


def scan_scene(name, n_frames):
    """(scene, rvecs, tvecs) of a scan phase: "longscan" (bench_longscan's
    serpentine sweep over its scene), "ring" (bench_loop_closure's
    outward-looking orbit of ``n_frames`` frames inside its sprite ring) or
    "raytrace" (bench_independent_accuracy's orbit arc of ``n_frames``
    frames over its ray-traced 24-box scene)."""
    from sfm_tpu_torch import raytrace, synthetic
    if name == "raytrace":
        return (raytrace.RayScene(seed=11, n_boxes=24),
                *raytrace.orbit_arc_trajectory(
                    n_frames, radius=5.5, arc=0.7 * n_frames / 60.0))
    if name == "ring":
        return (synthetic.ring_scene(),
                *synthetic.ring_loop_trajectory(n_frames, turns=RING_TURNS))
    return synthetic.longscan_scene(n_frames)


def fleet_scans(n_frames, batch):
    """benchmarks/bench_multiscan.py --flagship's fleet: scan b's
    (SpriteScene of seed 100 + b, 260 sprites, spread 2.4; its strafe of
    ``n_frames`` frames at 0.06 + 0.004 (b % 8) per frame)."""
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    return [(SpriteScene(np.random.default_rng(100 + b), n_sprites=260,
                         spread=2.4),
             *strafe_trajectory(n_frames, step=0.06 + 0.004 * (b % 8),
                                yaw_rate=0.001)) for b in range(batch)]


def _render_init(name, n_frames, K, H, W, batch=None):
    scans = fleet_scans(n_frames, batch) if name == "fleet" \
        else [scan_scene(name, n_frames)]
    _RENDER.update(scans=scans, fleet=name == "fleet",
                   raytrace=name == "raytrace", K=K, H=H, W=W)


def _render_chunk(lo, hi):
    K, H, W = _RENDER["K"], _RENDER["H"], _RENDER["W"]
    if _RENDER["fleet"]:
        # [frames, scans, H, W] uint8, as bench_multiscan stages them
        return np.stack([np.stack([s.render(K, rv[i], tv[i], H, W)
                                   for s, rv, tv in _RENDER["scans"]])
                         for i in range(lo, hi)]).astype(np.uint8)
    scene, rv, tv = _RENDER["scans"][0]
    if _RENDER["raytrace"]:
        # the lens's distortion, sensor noise, and the frame's index
        return np.stack([scene.render(K, rv[i], tv[i], H, W, d=RAYTRACE_DIST,
                                      noise_std=RAYTRACE_NOISE, frame_no=i)
                         for i in range(lo, hi)])
    return np.stack([scene.render(K, rv[i], tv[i], H, W)
                     for i in range(lo, hi)])


def rendered_chunks(n_frames, chunk, K, H, W, workers, scene="longscan",
                    orbit=None, batch=None):
    """The first ``n_frames`` frames of a scan phase (``scan_scene`` of
    ``scene`` over ``orbit`` frames, by default ``n_frames``; "fleet":
    the ``batch`` scans of ``fleet_scans``, each chunk uint8 [frames,
    batch, H, W]), chunk by chunk, each rendered shortly before it is fed:
    by ``workers`` processes at most 8 chunks ahead, or here when
    ``workers`` is 0.  The processes end with the generator."""
    init = (scene, orbit or n_frames, K, H, W, batch)
    spans = [(lo, min(lo + chunk, n_frames))
             for lo in range(0, n_frames, chunk)]
    if workers == 0:
        _render_init(*init)
        for lo, hi in spans:
            yield _render_chunk(lo, hi)
        return
    import collections
    import itertools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(workers,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_render_init,
                             initargs=init) as pool:
        todo = iter(spans)
        pending = collections.deque(
            pool.submit(_render_chunk, *span)
            for span in itertools.islice(todo, 8))
        while pending:
            frames = pending.popleft().result()
            span = next(todo, None)
            if span is not None:
                pending.append(pool.submit(_render_chunk, *span))
            yield frames


def periodic_schedule(inserted, closed, every):
    """The chunks after which the engine runs a periodic global BA: per
    chunk, a loop closure in it (its two global BA calls) restarts the
    count, then the chunk's insertions add to it, and a count of
    ``every`` runs the call and restarts it (the JAX engine's
    ``_maybe_global_ba``)."""
    since, out = 0, []
    for i, (n, c) in enumerate(zip(inserted, closed)):
        since = (0 if c else since) + n
        if every > 0 and since >= every:
            out.append(i)
            since = 0
    return out


def run_longscan(torch, dev, cfg, kernels, gba_kernels=GLOBAL_BA_KERNELS,
                 K=K, n_frames=LONGSCAN_FRAMES,
                 min_keyframes=LONGSCAN_MIN_KEYFRAMES,
                 workers=RENDER_WORKERS, k1_calls=None, scene="longscan",
                 orbit=None, ate_limit=0.02, k1_record_sites=None,
                 check=True):
    """A long scan: ``add_frames`` in chunks of keyframe_time_lag over the
    first ``n_frames`` frames of ``scan_scene(scene, orbit)``: by default
    the serpentine sweep of ``synthetic.longscan_scene`` (benchmarks/
    bench_longscan.py's scene), with periodic global BA (and loop probes
    and closures when the configuration has them), ended by two
    ``global_ba`` calls as bench_longscan ends.  The time splits into
    tracking, mapping passes, global BA calls and, with loop closure,
    loop probes and closures (``PhaseTimer``, the host clock around
    synchronised calls); each global BA call's launches are counted.
    Checks: RUNNING on >= 95% of the post-bootstrap frames, >=
    ``min_keyframes`` keyframes inserted, a periodic global BA after
    exactly the chunks the schedule names (``periodic_schedule``), no
    global BA call raising the cost, two global BA calls per closure,
    ``gba_kernels`` launched in every global BA call and ``kernels`` by
    the phase, and the sim(3) keyframe ATE after the final global BA
    under ``ate_limit`` of the trajectory's extent (its largest
    coordinate range, as bench_longscan measures it).  K1's launches are
    also counted per call site, and its calls (of the sites
    ``k1_record_sites`` only, when given) recorded into the list
    ``k1_calls`` when given (copies on the device: the peak memory is
    then read per chunk, less the copies held when the chunk began).  With
    ``check`` False the checks are returned under "checks", not raised.
    Returns the numbers, and under "keep" (for ``longscan_device`` and
    ``run_ring``) the state before the final global BA calls, the
    arguments of the first K2 call of the last mapping pass and of the
    last periodic global BA call, the engine, the state before the last
    TAIL_CHUNKS chunks with their frames, the keyframe trajectory before
    the final calls and the ground-truth poses."""
    import importlib

    from sfm_tpu_torch import native
    from sfm_tpu_torch.ba.large import CameraSlots
    from sfm_tpu_torch.engine import SfMEngine
    from sfm_tpu_torch.np_geometry import rodrigues_np
    from sfm_tpu_torch.synthetic import umeyama_ate
    from sfm_tpu_torch.utils import PhaseTimer
    step = importlib.import_module("sfm_tpu_torch.engine.step")
    large = importlib.import_module("sfm_tpu_torch.ba.large")

    label = scene
    H, W = cfg.image_size
    chunk = cfg.keyframe_time_lag
    n_frames -= n_frames % chunk
    _, rvecs, tvecs = scan_scene(scene, orbit or n_frames)
    eng = SfMEngine(K, (H, W), config=cfg, device=dev, seed=0)
    timer = PhaseTimer()
    recorded, current, fed, at_chunk = {}, [None], [0], [0]
    gba, map_launches = [], {k: 0 for k in native.LAUNCHES}
    # the loop probes' results (``seen``), each probe's numbers, and the
    # index and close_loop ms of the closure under way
    probes, seen, closing = [], [], [None, 0.0]
    real_lin, real_map, real_gba, real_probe, real_close, real_build = (
        large.ba_linearize, step.run_pending_mapping, eng.global_ba,
        eng.probe_loop_closure, step.close_loop, step.build_loop_probe)

    def copy(x):
        return x.clone() if torch.is_tensor(x) else x

    def linearize(*a, **kw):
        if current[0] is not None:
            recorded[current[0]] = (tuple(map(copy, a)),
                                    CameraSlots(*map(copy, kw["slots"])))
            current[0] = None
        return real_lin(*a, **kw)

    def mapping(cfg, cam, state):
        if int(state.pending_map_slot) < 0:     # no keyframe: a no-op
            return real_map(cfg, cam, state)
        sync(torch, dev)
        n0 = dict(native.LAUNCHES)
        with timer.phase("mapping pass"):
            current[0] = "mapping"
            out = real_map(cfg, cam, state)
            sync(torch, dev)
        current[0] = None
        for k in map_launches:
            map_launches[k] += native.LAUNCHES[k] - n0[k]
        return out

    def global_ba():
        sync(torch, dev)
        n0 = dict(native.LAUNCHES)
        t0 = time.perf_counter()
        with timer.phase("global BA"):
            # the periodic calls' problems are recorded: the final calls
            # start at a converged map, where the gradients are f32 noise
            current[0] = "global" if fed[0] < n_frames \
                and closing[0] is None else None
            out = real_gba()
            sync(torch, dev)
        ms = 1e3 * (time.perf_counter() - t0)
        current[0] = None
        launches = {k: native.LAUNCHES[k] - n0[k] for k in n0}
        n_lin = launches["ba_linearize"]
        call = dict(after_frame=fed[0], chunk=at_chunk[0], ms=ms,
                    closure=closing[0], launches=launches,
                    lm_iterations=n_lin - 1 if n_lin else None,
                    **{k: float(v) for k, v in out.items()})
        gba.append(call)
        log(f"[{label}] global BA after frame {fed[0]}"
            + ("" if closing[0] is None else f" (closure {closing[0]})")
            + f": cost {call['initial_cost']:.6e} -> {call['final_cost']:.6e}"
            f", {int(call['accepted'])} accepted, dropped_obs "
            f"{int(call['dropped_obs'])}, {ms:.3f} ms on the host clock"
            + (f" ({ms / (n_lin - 1):.3f} ms per LM iteration)"
               if n_lin > 1 else "")
            + f", launches {dict((k, v) for k, v in launches.items() if v)}")
        return out

    def build_loop_probe(cfg, cam, generator):
        # each probe's result, for the log
        probe = real_build(cfg, cam, generator)

        def recorded(state, slot, pnp_samples=None):
            out = probe(state, slot, pnp_samples)
            seen.append(dict(
                frame=int(state.kfs.frames.frame_no[slot]),
                n_inliers=int(out.n_inliers), drift=float(out.drift),
                scale=float(out.scale), scale_ok=bool(out.scale_ok),
                n_pairs=int(out.n_pairs)))
            return out
        return recorded

    def close_loop(*a, **kw):
        # inside probe_loop_closure; the closure's two global BA calls follow
        closing[0] = sum(p["closed"] for p in probes)
        sync(torch, dev)
        t0 = time.perf_counter()
        out = real_close(*a, **kw)
        sync(torch, dev)
        closing[1] = 1e3 * (time.perf_counter() - t0)
        return out

    def probe_loop_closure():
        sync(torch, dev)
        n_gba, n_seen = len(gba), len(seen)
        t0 = time.perf_counter()
        with timer.phase("loop probe"):
            out = real_probe()
            sync(torch, dev)
        ms = 1e3 * (time.perf_counter() - t0)
        p = dict(seen[-1] if len(seen) > n_seen else {}, closed=out,
                 after_frame=fed[0], chunk=at_chunk[0], ms=ms)
        if out:
            # the closure: close_loop and its two global BA calls
            p.update(close_ms=closing[1], global_ba_calls=len(gba) - n_gba,
                     closure_ms=closing[1] + sum(c["ms"] for c in gba[n_gba:]))
            log(f"[{label}] loop closure {closing[0]} at frame {p['frame']} "
                f"(fed {fed[0]}): drift {p['drift']:.3f}, {p['n_inliers']} "
                f"inliers, scale {p['scale']:.4f} (ok {p['scale_ok']}, "
                f"{p['n_pairs']} pairs); close_loop {p['close_ms']:.3f} ms, "
                f"with its global BA calls {p['closure_ms']:.3f} ms; the "
                f"probe {ms - p['closure_ms']:.3f} ms")
        closing[0] = None
        p["probe_ms"] = ms - p.get("closure_ms", 0.0)
        probes.append(p)
        return out

    cuda = torch.device(dev).type == "cuda"
    # the engine's peak memory: per chunk, the peak less the recorded K1
    # copies held when the chunk began (they only grow)
    mem = dict(peak=0, held=0, counted=0, slack=0)

    def held_bytes():
        for _, a in (k1_calls or [])[mem["counted"]:]:
            mem["held"] += sum(x.untyped_storage().nbytes() for x in a
                               if torch.is_tensor(x))
        mem["counted"] = len(k1_calls or [])
        return mem["held"]

    @contextlib.contextmanager
    def peak_memory():
        if not cuda:
            yield
            return
        held0 = held_bytes()
        torch.cuda.reset_peak_memory_stats()
        yield
        mem["peak"] = max(mem["peak"], torch.cuda.max_memory_allocated()
                          - held0)
        mem["slack"] = max(mem["slack"], held_bytes() - held0)

    eng.global_ba = global_ba
    eng.probe_loop_closure = probe_loop_closure
    step.run_pending_mapping = mapping
    step.close_loop = close_loop
    step.build_loop_probe = build_loop_probe
    large.ba_linearize = linearize
    k1_sites, restore_k1 = count_k1_sites(native, k1_calls, k1_record_sites)
    # the state before the last chunks and their frames, which
    # longscan_device feeds again under torch.profiler
    tail_from = len(range(0, n_frames, chunk)) - TAIL_CHUNKS
    tail = dict(frames=[], s=0.0)
    metrics, steady_s, first_s, per_chunk = [], 0.0, 0.0, []
    try:
        native.reset_launch_counts()
        for i, frames in enumerate(rendered_chunks(
                n_frames, chunk, K, H, W, workers, scene, orbit)):
            if i == tail_from:
                tail.update(state=eng.state, since=eng._kfs_since_global_ba)
            imgs = torch.as_tensor(frames, device=dev)
            sync(torch, dev)
            at_chunk[0] = i
            t0 = time.perf_counter()
            with timer.phase("add_frames"), peak_memory():
                out = eng.add_frames(imgs)     # fetches: synced
            dt = time.perf_counter() - t0
            metrics += out
            per_chunk.append(sum(int(m["keyframe_added"]) for m in out))
            if i:
                steady_s += dt
            else:
                first_s = dt
            if i >= tail_from:
                tail["frames"].append(frames)
                tail["s"] += dt
            fed[0] += len(frames)
            if fed[0] % 128 == 0:
                st = np.array([int(m["status"]) for m in metrics[-128:]])
                log(f"[{label}] frame {fed[0]}: RUNNING {(st == 1).mean():.1%}"
                    f" of the last 128, {int(eng.state.kfs.valid.sum())} "
                    f"keyframes, {int(eng.state.lms.valid.sum())} landmarks,"
                    f" {steady_s:.1f} s in the engine")
        n_scan = len(gba)
        kept_state = eng.state
        before = dict(traj=eng.get_trajectory(),
                      frame_nos=eng.keyframe_numbers())
        for _ in range(2):
            with peak_memory():
                eng.global_ba()
        launches = dict(native.LAUNCHES)
    finally:
        restore_k1()
        step.run_pending_mapping = real_map
        step.close_loop = real_close
        step.build_loop_probe = real_build
        large.ba_linearize = real_lin
        eng.global_ba = real_gba
        eng.probe_loop_closure = real_probe

    status = np.array([int(m["status"]) for m in metrics])
    boot = int(np.argmax(status == 1)) if (status == 1).any() else None
    if boot is None:
        raise AssertionError(f"{label}: the scan never bootstrapped")
    running = float((status[boot + 1:] == 1).mean())
    inserted = sum(per_chunk)
    kfs = eng.state.kfs
    valid = kfs.valid.cpu().numpy()
    fns = kfs.frames.frame_no.cpu().numpy()[valid]
    rv = kfs.frames.rvec.cpu().numpy()[valid]
    tv = kfs.frames.tvec.cpu().numpy()[valid]
    order = np.argsort(fns)
    est_c = np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in order])
    gt_c = np.stack([-rodrigues_np(rvecs[f]).T @ tvecs[f]
                     for f in fns[order]])
    ate = umeyama_ate(est_c, gt_c)
    extent = float(np.ptp(gt_c, axis=0).max())
    pts, _ = eng.get_reconstruction()
    closures = [p for p in probes if p["closed"]]
    periodic = [c for c in gba[:n_scan] if c["closure"] is None]
    summ = timer.summary()
    tot = {k: summ.get(k, {}).get("total_s", 0.0)
           for k in ("add_frames", "mapping pass", "global BA",
                     "loop probe")}
    periodic_s = sum(c["ms"] for c in periodic) / 1e3
    closure_s = sum(p["closure_ms"] for p in closures) / 1e3
    probe_s = tot["loop probe"] - closure_s
    split = {"tracking": tot["add_frames"] - tot["mapping pass"]
             - periodic_s - tot["loop probe"],
             "mapping passes": tot["mapping pass"],
             "global BA (periodic)": periodic_s,
             "global BA (final two)": sum(c["ms"] for c in gba[n_scan:]) / 1e3}
    if cfg.loop_detect_every > 0:
        split.update({"loop probes": probe_s, "loop closures": closure_s})
    per_iter = [c["ms"] / c["lm_iterations"] for c in gba
                if c["lm_iterations"]]
    fps = (n_frames - chunk) / steady_s
    peak = mem["peak"] if cuda else None
    log(f"[{label}] {n_frames} frames; bootstrap on frame {boot}; "
        f"{running:.1%} of later frames RUNNING; {inserted} keyframes "
        f"inserted, {int(valid.sum())} live; {len(pts)} landmarks; "
        f"{len(periodic)} periodic global BA calls; ATE {ate:.5f} over extent "
        f"{extent:.3f} ({100 * ate / extent:.3f}%); launches {launches}; K1 "
        f"launches by call site {k1_sites}")
    log(f"[{label}] first chunk {first_s:.3f} s; amortised {fps:.3f} "
        f"frames/s over frames {chunk}-{n_frames - 1}; split (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" ({timer.counts['mapping pass']} mapping passes); global BA "
        f"{np.mean(per_iter) if per_iter else float('nan'):.3f} ms per LM "
        f"iteration on the host clock (mean of {len(per_iter)} calls); "
        f"max_memory_allocated {peak} B (less the recorded K1 copies; at "
        f"most {mem['slack']} B of them were made during one chunk)")
    if probes:
        log(f"[{label}] loop probes (frame, PnP inliers, drift) with >= 10 "
            f"inliers: " + str([(p["frame"], p["n_inliers"],
                                 round(p["drift"], 3)) for p in probes
                                if p.get("n_inliers", 0) >= 10]))
        log(f"[{label}] {len(probes)} loop probes, {len(closures)} closures; "
            f"host ms per probe {1e3 * probe_s / len(probes):.3f}, per "
            f"closure (close_loop and its two global BA calls) "
            + (f"{1e3 * closure_s / len(closures):.3f}" if closures
               else "none"))
    log(timer.report())
    schedule = periodic_schedule(
        per_chunk, [any(p["closed"] and p["chunk"] == i for p in probes)
                    for i in range(len(per_chunk))], cfg.global_ba_every)
    checks = {
        "post-bootstrap frames RUNNING >= 95%": running >= 0.95,
        f"keyframes inserted >= {min_keyframes}": inserted >= min_keyframes,
        "a periodic global BA after each chunk the schedule names":
            [c["chunk"] for c in periodic] == schedule,
        "every global BA: finite final_cost <= initial_cost": all(
            np.isfinite(c["final_cost"])
            and c["final_cost"] <= c["initial_cost"] for c in gba),
        "two global BA calls per loop closure": all(
            p["global_ba_calls"] == 2 for p in closures),
        f"sim(3) keyframe ATE < {ate_limit:.0%} of extent":
            ate < ate_limit * extent,
        "landmarks finite": len(pts) > 0 and bool(np.isfinite(pts).all()),
    }
    for name in gba_kernels:
        checks[f"{name} launched in every global BA call"] = all(
            c["launches"][name] > 0 for c in gba)
    for name in kernels:
        checks[f"{name} launched by the phase"] = launches[name] > 0
    if check:
        run_checks(label, checks)
    return dict(
        checks=checks, frames=n_frames, fps=fps, first_chunk_s=first_s,
        running=running, bootstrap_frame=boot, keyframes_inserted=inserted,
        keyframes_live=int(valid.sum()), landmarks=len(pts),
        ate_pct=100 * ate / extent, extent=extent, split_s=split,
        mapping_passes=timer.counts["mapping pass"],
        global_ba_calls=gba, periodic_global_ba_calls=len(periodic),
        global_ba_host_ms_per_lm_iter=float(np.mean(per_iter))
        if per_iter else None, max_memory_allocated=peak,
        max_memory_slack=mem["slack"] if cuda else None,
        launches=launches, mapping_launches=map_launches, k1_sites=k1_sites,
        loop_probes=probes,
        keep=dict(state=kept_state, cam=eng.cam, recorded=recorded,
                  engine=eng, tail=tail, before=before,
                  truth=(rvecs, tvecs)))


def loop_k1_launches(k1_sites):
    """K1's launches at the loop probe's call sites (engine/loop.py)."""
    return sum(n for site, n in k1_sites.items() if site.startswith("loop."))


def run_ring(torch, dev, cfg, kernels, gba_kernels=GLOBAL_BA_KERNELS, K=K,
             n_frames=RING_FRAMES, orbit=RING_FRAMES, workers=RENDER_WORKERS,
             k1_calls=None, min_closures=1, closure_deg=RING_CLOSURE_DEG,
             max_drift=RING_MAX_DRIFT, min_keyframes=LONGSCAN_MIN_KEYFRAMES,
             check=True):
    """The ring: ``RING`` (bench_loop_closure's configuration) over the
    first ``n_frames`` frames of its outward-looking orbit of ``orbit``
    frames, through ``run_longscan`` (its checks, with the ATE under 5% of
    the extent), with K1's calls at the loop probe's site recorded into
    ``k1_calls``.  Then: >= ``min_closures`` loop closures, each at a frame
    past ``closure_deg`` degrees of the orbit; the end-of-loop drift after
    the final global BA (``synthetic.loop_drift``: a similarity fitted on
    the first quarter of the keyframes) under ``max_drift``; two K1
    launches at the probe's site per probe.  Also logged: the largest
    rotation error of one keyframe relative to the next against the
    ground truth.  Every number is logged before a check can raise; with
    ``check`` False the checks are returned under "checks"."""
    from sfm_tpu_torch.np_geometry import rodrigues_np
    from sfm_tpu_torch.synthetic import loop_drift
    out = run_longscan(torch, dev, cfg, kernels, gba_kernels, K=K,
                       n_frames=n_frames,
                       min_keyframes=min_keyframes, workers=workers,
                       k1_calls=k1_calls, scene="ring", orbit=orbit,
                       ate_limit=RING_ATE, k1_record_sites=("loop.",),
                       check=False)
    keep = out.pop("keep")
    eng, (rvecs, tvecs), b = keep["engine"], keep["truth"], keep["before"]
    d_before = loop_drift(b["traj"], b["frame_nos"], rvecs, tvecs)
    traj, fns = eng.get_trajectory(), eng.keyframe_numbers()
    d_after = loop_drift(traj, fns, rvecs, tvecs)
    # keyframe-to-keyframe rotation against the ground truth's (no
    # alignment needed): a pose gone wrong shows as a step
    rel = [rodrigues_np(traj[i + 1, :3]) @ rodrigues_np(traj[i, :3]).T
           @ (rodrigues_np(rvecs[fns[i + 1]])
              @ rodrigues_np(rvecs[fns[i]]).T).T for i in range(len(fns) - 1)]
    rot_deg = [np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
               for r in rel]
    worst = int(np.argmax(rot_deg))
    closures = [p for p in out["loop_probes"] if p["closed"]]
    first_true = orbit * (closure_deg / 360.0) / RING_TURNS
    n_probes = len(out["loop_probes"])
    rows = [(p["frame"], round(p["drift"], 4), p["n_inliers"],
             round(p["scale"], 4), p["scale_ok"], p["n_pairs"])
            for p in closures]
    log(f"[ring] loop closures (frame, drift in map units, inliers, scale, "
        f"scale_ok, pairs): {rows}; {n_probes} probes; end-of-loop drift "
        f"before the final global "
        f"BA {d_before[0]:.4f} m (max {d_before[1]:.4f}), after "
        f"{d_after[0]:.4f} m (max {d_after[1]:.4f}) over {d_after[2]} "
        f"keyframes; {out['keyframes_live']} keyframes live, "
        f"{out['landmarks']} landmarks; K1 at the probe "
        f"{loop_k1_launches(out['k1_sites'])} launches; largest keyframe-to-"
        f"keyframe rotation error {rot_deg[worst]:.3f} deg (frames "
        f"{fns[worst]}-{fns[worst + 1]})")
    out["checks"].update({
        f"loop closures >= {min_closures}": len(closures) >= min_closures,
        f"every closure past {closure_deg:.0f} degrees of the orbit (frame "
        f">= {first_true:.1f})": all(p["frame"] >= first_true
                                     for p in closures),
        f"end-of-loop drift after the final global BA < {max_drift} m":
            d_after[0] < max_drift,
        "K1 launched twice per probe at loop.*":
            loop_k1_launches(out["k1_sites"]) == 2 * n_probes > 0,
    })
    out.update(drift_before_m=d_before[0], drift_max_before_m=d_before[1],
               drift_after_m=d_after[0], drift_max_after_m=d_after[1],
               closures=closures, probes=n_probes,
               max_kf_step_rotation_err_deg=rot_deg[worst],
               digest=state_digest(eng.state))
    if check:
        run_checks("ring", out["checks"])
    return out


def _centres(rvec, tvec):
    """Camera centres -R^T t of poses [..., 3] (numpy, float64)."""
    from sfm_tpu_torch.np_geometry import rodrigues_np
    rv = np.asarray(rvec, np.float64).reshape(-1, 3)
    tv = np.asarray(tvec, np.float64).reshape(-1, 3)
    return np.stack([-rodrigues_np(r).T @ t for r, t in zip(rv, tv)])


def _rot_err(rv0, rv1):
    """Angles (rad) between rotations given as Rodrigues vectors [n, 3]."""
    from sfm_tpu_torch.np_geometry import rodrigues_np
    out = []
    for a, b in zip(np.asarray(rv0, np.float64), np.asarray(rv1, np.float64)):
        r = rodrigues_np(a) @ rodrigues_np(b).T
        out.append(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
    return np.asarray(out)


def run_fleet(torch, dev, cfg, K=K, batch=FLEET_BATCH, n_frames=FLEET_FRAMES,
              orbit=FLEET_ORBIT, workers=RENDER_WORKERS, k1_calls=None,
              single_fps=None, check=True):
    """The fleet: ``MultiScanDriver(cfg, cam, batch, bucket=8)`` on
    benchmarks/bench_multiscan.py --flagship's scans (``fleet_scans``; the
    first ``n_frames`` of their ``orbit`` frames, whole chunks of
    keyframe_time_lag), every chunk rendered first by the worker pool and
    staged on the device as uint8 [T, batch, H, W].  ``warmup``, chunk 0
    untimed (the bootstrap), the other chunks timed one by one as
    bench_multiscan times its groups (aggregate frames/s: batch x T over
    the fastest chunk, and over the median), then ``probe_loops`` once.
    The launches of K1 and K5 are counted in each batched tracking step
    (and K1's by call site), and K1's calls in the timed steps recorded
    into ``k1_calls`` when given.  Then scan 0 alone, as a fleet of one,
    on the same frames.  Checks: every scan bootstraps; >= FLEET_RUNNING
    of the scan-frames after chunk 0 RUNNING; each scan with >= 3
    keyframes under 2% sim(3) keyframe ATE; no pending mapping slot after
    any chunk; no loop closed; K1 launched twice and K5 once in every
    batched tracking step, in the fleet and in the fleet of one; scan 0
    alone with the same status on every frame, the same keyframes but at
    most one, and its tracked poses within FLEET_CENTRE_TOL (centres,
    after the least-squares scale) and FLEET_ROT_TOL.  Returns the
    numbers (the checks under "checks"; raised unless ``check`` is False)
    and under "keep" the state before the last chunk with its frames."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine.state import RUNNING, CameraParams, index_state
    from sfm_tpu_torch.mapstore import tree_map
    from sfm_tpu_torch.parallel import MultiScanDriver
    from sfm_tpu_torch.synthetic import keyframe_ate
    from sfm_tpu_torch.utils import PhaseTimer

    H, W = cfg.image_size
    T = cfg.keyframe_time_lag
    n_frames -= n_frames % T
    cuda = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    staged = [torch.as_tensor(c, device=dev) for c in rendered_chunks(
        n_frames, T, K, H, W, workers, scene="fleet", orbit=orbit,
        batch=batch)]
    render_s = time.perf_counter() - t0
    truth = [(rv, tv) for _, rv, tv in fleet_scans(orbit, batch)]
    Kt = torch.as_tensor(K)
    cam = CameraParams(K=Kt, d=torch.zeros(5), Kopt=Kt)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def counted(drv, steps, rec=None, recording=None, k1_sites=None):
        """Wrap drv's batched tracking step: per call, the K1 and K5
        launches (and K1's by site), and the K1 calls recorded meanwhile
        while ``recording[0]``."""
        real = drv._track

        def track(images):
            n0 = dict(native.LAUNCHES)
            s0 = dict(k1_sites or {})
            r0 = len(rec) if rec is not None else 0
            out = real(images)
            steps.append(dict(
                hamming_match=native.LAUNCHES["hamming_match"]
                - n0["hamming_match"],
                patch_sampler=native.LAUNCHES["patch_sampler"]
                - n0["patch_sampler"],
                sites={k: v - s0.get(k, 0) for k, v in (k1_sites or {}).items()
                       if v != s0.get(k, 0)}))
            if rec is not None and recording[0]:
                k1_calls.extend(rec[r0:])
            return out
        drv._track = track

    drv = MultiScanDriver(cfg, cam, batch=batch, bucket=8, device=dev)
    drv.warmup(staged[0])
    steps, recording = [], [False]
    rec = [] if k1_calls is not None else None
    k1_sites, restore = count_k1_sites(native, rec)
    counted(drv, steps, rec, recording, k1_sites)
    ms, pending_ok, group_s = [], [], []
    try:
        native.reset_launch_counts()
        t0 = time.perf_counter()
        ms.append(drv.step_chunk(staged[0]))
        sync(torch, dev)
        boot_s = time.perf_counter() - t0
        pending_ok.append(bool((drv.states.pending_map_slot == -1).all()))
        n_boot_steps = len(steps)
        drv.timer = PhaseTimer()
        recording[0] = True
        for i, ch in enumerate(staged[1:]):
            if i == len(staged) - 2:
                kept = tree_map(torch.clone, drv.states)
            if rec is not None:
                del rec[:]
            t0 = time.perf_counter()
            ms.append(drv.step_chunk(ch))
            sync(torch, dev)
            group_s.append(time.perf_counter() - t0)
            pending_ok.append(bool(
                (drv.states.pending_map_slot == -1).all()))
        recording[0] = False
        launches = dict(native.LAUNCHES)
        t0 = time.perf_counter()
        closed = drv.probe_loops()
        probe_s = time.perf_counter() - t0
    finally:
        restore()
        del drv._track
    peak = torch.cuda.max_memory_allocated() if cuda else None
    split = drv.timer.summary()

    status = np.concatenate([m["status"].cpu().numpy() for m in ms])
    # each keyframe inserted in a timed chunk is one mapping pass there
    passes = int(sum(m["keyframe_added"].sum() for m in ms[1:]))
    post = status[T:]
    running = float((post == RUNNING).mean())
    booted = bool((status == RUNNING).any(0).all())
    kfs_n = drv.states.kfs.valid.sum(-1).cpu().numpy()
    ates, kf_numbers = [], []
    for b in range(batch):
        kfs = index_state(drv.states, b).kfs
        valid = kfs.valid.cpu().numpy()
        fns = kfs.frames.frame_no.cpu().numpy()[valid]
        order = np.argsort(fns)
        kf_numbers.append(fns[order].tolist())
        if valid.sum() < 3:
            ates.append(None)
            continue
        traj = np.concatenate([kfs.frames.rvec.cpu().numpy()[valid],
                               kfs.frames.tvec.cpu().numpy()[valid]],
                              1)[order]
        ate, extent = keyframe_ate(traj, fns[order], *truth[b])
        ates.append(ate / extent)
    ate_pct = [100 * a for a in ates if a is not None]
    rates = [T / s for s in group_s]
    timed = steps[n_boot_steps:]
    per_step = {(s["hamming_match"], s["patch_sampler"]) for s in timed}
    sites = {}
    for s in timed:
        for k, v in s["sites"].items():
            sites[k] = sites.get(k, 0) + v
    fps_best = batch * max(rates)
    fps_median = batch * float(np.median(rates))
    log(f"[fleet] {batch} scans x {n_frames} frames ({len(staged)} chunks "
        f"of {T}; rendered and staged as uint8 in {render_s:.1f} s); "
        f"bootstrap chunk {boot_s:.2f} s; every scan bootstrapped: "
        f"{booted}; {running:.1%} of the {post.size} scan-frames after it "
        f"RUNNING; keyframes per scan {int(kfs_n.min())}-{int(kfs_n.max())}"
        f"; ATE {min(ate_pct):.3f}-{max(ate_pct):.3f}% of extent over "
        f"{len(ate_pct)} scans (median {np.median(ate_pct):.3f}%)")
    log(f"[fleet] timed chunks {', '.join(f'{x:.3f}' for x in group_s)} s: "
        f"aggregate {fps_best:.1f} frames/s (fastest chunk), "
        f"{fps_median:.1f} (median)"
        + (f"; the single-scan FLAGSHIP rate of this run {single_fps:.2f} "
           f"frames/s ({fps_best / single_fps:.1f}x)" if single_fps else ""))
    map_ms = 1e3 * split["mapping"]["total_s"] / max(passes, 1)
    step_ms = 1e3 * split["tracking"]["total_s"] / max(len(timed), 1)
    log(f"[fleet] split over the timed chunks: " + ", ".join(
        f"{k} {v['total_s']:.3f} s ({v['count']} calls)"
        for k, v in split.items()) + f"; {passes} mapping passes "
        f"({map_ms:.1f} ms each), {step_ms:.1f} ms per batched tracking "
        f"step; probe_loops {probe_s:.3f} s, "
        f"closed {closed}; peak memory "
        + (f"{peak / 2 ** 30:.2f} GiB" if peak is not None else "n/a"))
    log(f"[fleet] K1 / K5 launches per batched tracking step "
        f"{sorted(per_step)}; K1 by site over the timed steps {sites}; "
        f"the phase's launches {launches}")

    # scan 0 alone, as a fleet of one, on the same frames
    one = MultiScanDriver(cfg, cam, batch=1, bucket=8, device=dev)
    one_steps = []
    counted(one, one_steps)
    try:
        ms1 = [one.step_chunk(ch[:, :1]) for ch in staged]
    finally:
        del one._track
    status1 = np.concatenate([m["status"].cpu().numpy() for m in ms1])[:, 0]
    kfs1 = one.states.kfs
    v1 = kfs1.valid[0].cpu().numpy()
    kf1 = np.sort(kfs1.frames.frame_no[0].cpu().numpy()[v1]).tolist()
    both = (status[:, 0] == RUNNING) & (status1 == RUNNING)
    pose = {k: np.concatenate([m[k][:, 0].cpu().numpy() for m in ms])[both]
            for k in ("rvec", "tvec")}
    pose1 = {k: np.concatenate([m[k][:, 0].cpu().numpy() for m in ms1])[both]
             for k in ("rvec", "tvec")}
    c0 = _centres(pose["rvec"], pose["tvec"])
    c1 = _centres(pose1["rvec"], pose1["tvec"])
    extent0 = float(np.linalg.norm(c0[-1] - c0[0])) if len(c0) else 0.0
    # both runs anchor their world at scan 0's first camera, so scale is
    # the one free gauge (monocular): centres are compared after the
    # least-squares scale, rotations as they are
    sc = float((c0 * c1).sum() / max(float((c1 * c1).sum()), 1e-12)) \
        if len(c0) else 1.0
    d_centre = float(np.abs(c0 - sc * c1).max()) if len(c0) else 0.0
    raw_centre = float(np.abs(c0 - c1).max()) if len(c0) else 0.0
    d_rot = float(_rot_err(pose["rvec"], pose1["rvec"]).max()) \
        if len(c0) else 0.0
    one_per_step = {(s["hamming_match"], s["patch_sampler"])
                    for s in one_steps}
    log(f"[fleet] scan 0 alone: status equal on "
        f"{int((status[:, 0] == status1).sum())} of {n_frames} frames; "
        f"keyframes {kf1} (in the fleet {kf_numbers[0]}); over the "
        f"{int(both.sum())} frames both track, the largest difference of "
        f"a camera centre after the scale {sc:.6f} {d_centre:.3e} "
        f"({d_centre / max(extent0, 1e-12):.3e} of the extent "
        f"{extent0:.3f}; unscaled {raw_centre:.3e}), of a rotation "
        f"{d_rot:.3e} rad; K1 / K5 launches per tracking step "
        f"{sorted(one_per_step)}")
    checks = {
        "every scan bootstraps": booted,
        f"scan-frames after the bootstrap chunk RUNNING >= "
        f"{FLEET_RUNNING:.0%}": running >= FLEET_RUNNING,
        "sim(3) keyframe ATE < 2% of extent for every scan with >= 3 "
        "keyframes": bool(ate_pct) and max(ate_pct) < 2.0,
        "no pending mapping slot after any chunk": all(pending_ok),
        "probe_loops closes nothing": closed == [],
        "K1 twice and K5 once in every batched tracking step":
            per_step == {(2, 1)},
        "the same per tracking step in a fleet of one":
            one_per_step == {(2, 1)},
        "scan 0 alone: the same status on every frame":
            bool((status[:, 0] == status1).all()),
        "scan 0 alone: the same keyframes but at most one":
            len(set(kf1) ^ set(kf_numbers[0])) <= 1,
        f"scan 0 alone: tracked camera centres within {FLEET_CENTRE_TOL} of "
        f"the extent (after the least-squares scale) and rotations within "
        f"{FLEET_ROT_TOL} rad":
            d_centre <= FLEET_CENTRE_TOL * extent0
            and d_rot <= FLEET_ROT_TOL,
        "fleet state on the device": drv.states.lms.xyz.device.type
        == torch.device(dev).type,
    }
    out = dict(
        batch=batch, frames=n_frames, chunk=T, render_s=render_s,
        bootstrap_chunk_s=boot_s, chunk_s=group_s,
        aggregate_fps=fps_best, aggregate_fps_median=fps_median,
        single_scan_fps=single_fps, running=running, booted=booted,
        keyframes_min=int(kfs_n.min()), keyframes_max=int(kfs_n.max()),
        ate_pct_max=max(ate_pct), ate_pct_median=float(np.median(ate_pct)),
        split={k: v["total_s"] for k, v in split.items()},
        mapping_passes=passes, probe_s=probe_s, closed=closed, max_memory_allocated=peak,
        k1_sites=sites, launches=launches,
        tracking_steps=len(timed),
        alone=dict(max_centre_diff=d_centre, extent=extent0,
                   max_rot_diff_rad=d_rot, scale=sc,
                   max_centre_diff_unscaled=raw_centre, keyframes=kf1,
                   fleet_keyframes=kf_numbers[0]),
        checks=checks,
        keep=dict(state=kept, chunk=staged[-1], driver=drv))
    if check:
        run_checks("fleet", checks)
    return out


def fleet_k5_row(torch, cfg, images, what="fleet"):
    """K5 at a fleet's batched shape: the canvases and keypoints of one
    fleet frame ``images`` [B, H, W] under ``cfg`` (the fleet phase's last
    frame: 64 x [480, 1200], 64 x 512 keypoints), held bit for bit
    against the plain version and against one kernel call per canvas,
    and timed beside F.grid_sample on the same samples."""
    from sfm_tpu_torch.features import patches_pallas as pp
    from sfm_tpu_torch.features.descriptor import patch_inputs
    from sfm_tpu_torch.features.detect import detect
    imgs = images.to(torch.float32)
    kps, canvas = detect(imgs, max_keypoints=cfg.max_keypoints,
                         levels=cfg.pyramid_levels,
                         threshold=cfg.fast_threshold,
                         nms_radius=cfg.nms_radius, return_canvas=True)
    canvas_s, cx, cy = patch_inputs(canvas, kps, cfg.pyramid_levels,
                                    cfg.image_width)
    a = pp.extract_patches_kernel(canvas_s, cx, cy)
    b = pp.extract_patches_plain(canvas_s, cx, cy)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    if not torch.equal(a, b):
        raise AssertionError(f"K5 {what}: differs from the plain version "
                             f"(max abs err {err})")
    for i in range(canvas_s.shape[0]):
        if not torch.equal(a[i], pp.extract_patches_kernel(
                canvas_s[i], cx[i], cy[i])):
            raise AssertionError(f"K5 {what}: canvas {i} differs from its "
                                 f"own call")
    t = timed(torch, lambda: pp.extract_patches_plain(canvas_s, cx, cy),
              lambda: pp.extract_patches_kernel(canvas_s, cx, cy),
              ops_ok=lambda n: n == 1)
    F = torch.nn.functional
    B, Hc, Wc = canvas_s.shape
    r = torch.arange(-pp.PATCH_RADIUS, pp.PATCH_RADIUS + 1, device="cuda",
                     dtype=torch.float32)
    gx = (cx[..., None, None] + r[None, None, None, :]).expand(
        -1, -1, pp.PATCH, -1)
    gy = (cy[..., None, None] + r[None, None, :, None]).expand(
        -1, -1, -1, pp.PATCH)
    grid = torch.stack([2 * gx / (Wc - 1) - 1, 2 * gy / (Hc - 1) - 1], -1)
    grid = grid.reshape(B, -1, pp.PATCH, 2).contiguous()
    img = canvas_s[:, None]

    def library():
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    lib_err = float((library().reshape(a.shape) - b).abs().max())
    lib_ms = device_ms(torch, library)
    bd = k5_bound(torch, canvas_s, cx, cy, a)
    row = dict(shape=f"{what} {B} x {cx.shape[-1]} kp, canvases "
                     f"{tuple(canvas_s.shape)}",
               max_abs_err=err, library_ms=lib_ms,
               library_max_abs_err=lib_err, **t, **bd)
    log(f"K5 {row['shape']}: equal to the plain version and to one call "
        f"per canvas, kernel {us(t['ms'])} device ({t['event_ms']:.4f} ms "
        f"events), plain {us(t['plain_ms'])} device; F.grid_sample "
        f"{us(lib_ms)} device (max abs diff {lib_err:.2e}); bound "
        f"{us(bd['bound_ms'])} ({bd['bound_by']}: {bd['bytes']} B of which "
        f"{bd['window_bytes']} B of canvas windows, {bd['ops']} ops)"
        f"{share(bd['bound_ms'], t['ms'])}")
    return row


def fleet_device(torch, out):
    """Last of all (a profiler session spoils the host-bound phases after
    it): from the fleet's state before its last chunk, the chunk's batched
    tracking steps alone and then the whole chunk, each under
    torch.profiler: the card's busy share of each."""
    from torch.profiler import ProfilerActivity, profile

    from sfm_tpu_torch.mapstore import tree_map
    keep = out.pop("keep")
    drv, chunk = keep["driver"], keep["chunk"]
    res = {}
    for what in ("tracking steps", "chunk"):
        drv.states = tree_map(torch.clone, keep["state"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "chunk":
                drv.step_chunk(chunk)
            else:
                for img in chunk:
                    drv.states, _ = drv._track(img.to(torch.float32))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0)
                   for e in prof.key_averages()) / 1e6
        res[what] = dict(profiled_s=wall, busy_s=busy, busy_share=busy / wall)
        log(f"[fleet] the last chunk's {what} again under torch.profiler: "
            f"{wall:.3f} s, the card busy {busy:.3f} s ({busy / wall:.1%})")
    return res


def longscan_device(torch, cfg, out):
    """After the profiled kernel checks: global BA on the long scan's state
    before its final calls, once on the host clock (its LM iterations
    counted by K2's launches) and once under torch.profiler (device ms per
    LM iteration, by kernel); then K2, K3 full and K3-gather against their
    plain versions, and timed, on the arguments of the scan's last
    mapping-pass BA and periodic global BA (``ba_kernel_rows``), with their
    launches per global BA call; last, the long scan's last TAIL_CHUNKS
    chunks fed again from the state before them, under torch.profiler:
    the card's busy share."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine.global_ba import run_global_ba
    keep = out.pop("keep")

    def once():
        return run_global_ba(cfg, keep["cam"], keep["state"])
    once()
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    once()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    n_iter = native.LAUNCHES["ba_linearize"] - 1
    parts = {}
    dev_ms_call = device_ms(torch, once, 1, parts) or float("nan")
    ba = {k: v / n_iter for k, v in parts.items()
          if k.startswith(("landmark_phase", "camera_phase"))}
    res = dict(lm_iterations=n_iter, host_ms_per_lm_iter=host_ms / n_iter,
               device_ms_per_lm_iter=dev_ms_call / n_iter,
               ba_kernels_ms_per_lm_iter=ba)
    log(f"[longscan] global BA on the state before the final calls: "
        f"{n_iter} LM iterations, {host_ms / n_iter:.3f} ms per LM iteration "
        f"on the host clock, {dev_ms_call / n_iter:.3f} ms on the device, of "
        f"which the K2 / K3 phases {sum(ba.values()):.3f} ms ("
        + ", ".join(f"{k} {v:.3f}" for k, v in ba.items()) + ")")
    periodic = out["global_ba_calls"][:out["periodic_global_ba_calls"]]
    rows = {}
    for key in ("global", "mapping"):
        args, cs = keep["recorded"][key]
        C = args[1].shape[0]
        L, kmax = args[6].shape
        live = float((args[8] != 0).float().mean())
        label = f"{key} C={C} L={L} kmax={kmax} ({live:.1%} live slots)"
        log(f"[BA kernels] {label}")
        for name, row in ba_kernel_rows(torch, label, args, cs, True,
                                        GLOBAL_BA_KERNELS,
                                        witness=True).items():
            if key == "global":
                row["launches"] = sum(c["launches"][name]
                                      for c in out["global_ba_calls"])
                row["launches_per_global_ba"] = float(np.mean(
                    [c["launches"][name] for c in periodic]))
            else:
                row["launches"] = out["mapping_launches"][name]
                row["launches_per_mapping_pass"] = \
                    row["launches"] / out["mapping_passes"]
            rows[(name, key)] = row
    res["rows"] = rows
    # last, as the other profiled parts: the long scan's last chunks fed
    # again from the state before them, under torch.profiler
    from torch.profiler import ProfilerActivity, profile
    eng, tail = keep["engine"], keep["tail"]
    eng.state, eng._kfs_since_global_ba = tail["state"], tail["since"]
    imgs = [torch.as_tensor(f, device="cuda") for f in tail["frames"]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in imgs:
            eng.add_frames(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages()) / 1e6
    n = sum(len(f) for f in tail["frames"])
    res.update(tail_frames=n, tail_busy_s=busy, tail_profiled_s=wall,
               tail_scan_s=tail["s"])
    log(f"[longscan] the last {n} frames fed again from the state before "
        f"them under torch.profiler: {wall:.3f} s, the card busy {busy:.3f} s"
        f" ({busy / wall:.1%}; {busy / tail['s']:.1%} of the {tail['s']:.3f}"
        f" s the same frames took in the scan)")
    return res


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
    from sfm_tpu_torch.io import read_ply, runtime
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
        # the C++ runtime (PLY writer, y4m reader) is built at its first
        # use: here, not inside the timed scan
        runtime.library()
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


# the pipeline phase: tracked frames between a dispatch and its join; the
# serve phase: frames per client, of which the first go one by one (FRAME)
# and the rest in chunks of keyframe_time_lag (FRAMES), and the scene
# seeds of its two clients
PIPELINE_LAG = 2
SERVE_FRAMES, SERVE_SINGLE = 40, 16
SERVE_SEEDS = (11, 12)
# the kernels that the pipeline's mapping pass launches (all of their
# launches must come from its stream); K1 runs on both streams
MAPPING_KERNELS = ("ba_linearize", "schur_apply", "schur_gather")
# the pipeline's frames profiled for the card's busy share: a keyframe at
# frame 34 (bit for bit the same in every run) starts a mapping pass
PIPELINE_PROFILED = (34, 46)
# the pipeline phase's split run (tracking on the CPU, mapping on the card):
# the scan's first frames, through the keyframe at frame 21, the fourth
# (the offline gates ask for 4 keyframes)
SPLIT_FRAMES = 24


def state_digest(state):
    """A hash of a state's map: keyframe validity, frame numbers, poses and
    links, landmark validity and positions, and the status.  Equal digests
    are the same map bit for bit."""
    import hashlib
    h = hashlib.sha256()
    kfs, lms = state.kfs, state.lms
    for t in (state.status, kfs.valid, kfs.frames.frame_no, kfs.frames.rvec,
              kfs.frames.tvec, kfs.frames.landmark, lms.valid, lms.xyz):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:24]


def strafe_frames(n_frames, H, W, K=K, rgb=False, seed=11):
    """The offline phase's scene and strafe (bench.py's workload): frames
    [n] float32, and the ground-truth (rvecs, tvecs)."""
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    scene = SpriteScene(np.random.default_rng(seed), n_sprites=260,
                        spread=2.4)
    rvecs, tvecs = strafe_trajectory(n_frames, step=0.06, yaw_rate=0.001)
    return ([scene.render(K, rvecs[i], tvecs[i], H, W, rgb=rgb)
             for i in range(n_frames)], rvecs, tvecs)


def state_trajectory(state):
    """(keyframe poses [n, 6] sorted by frame number, the frame numbers),
    as ``SfMEngine.get_trajectory`` and ``keyframe_numbers`` give them."""
    kfs = state.kfs
    valid = kfs.valid.cpu().numpy()
    fn = kfs.frames.frame_no.cpu().numpy()[valid]
    order = np.argsort(fn)
    traj = np.concatenate([kfs.frames.rvec.cpu().numpy()[valid],
                           kfs.frames.tvec.cpu().numpy()[valid]], 1)
    return traj[order], fn[order]


def links_consistent(state):
    """No keyframe or ``prev`` link to an invalid landmark slot."""
    ok = state.lms.valid.cpu().numpy()
    pairs = [(state.prev.landmark, state.prev.kp_valid)]
    kv = state.kfs.valid.cpu().numpy()
    pairs += [(state.kfs.frames.landmark[s], state.kfs.frames.kp_valid[s])
              for s in np.nonzero(kv)[0]]
    for landmark, kp_valid in pairs:
        lk = landmark.cpu().numpy()
        lk = lk[(lk >= 0) & kp_valid.cpu().numpy()]
        if not ok[lk].all():
            return False
    return True


def run_pipeline(torch, dev, cfg, kernels, K=K, n_frames=N_FRAMES,
                 merge_lag=PIPELINE_LAG, label="pipeline",
                 split_frames=SPLIT_FRAMES):
    """The offline phase's grey strafe, frame by frame through
    ``AsyncMappingEngine(merge_lag)`` (the mapping pass on the worker
    thread's own CUDA stream), then ``flush``; twice, and once through
    ``SfMEngine.add_frame`` (inline mapping) for the rate beside it.
    Checks the offline phase's gates, the merged map's links and view
    counts, the kernels of ``kernels`` launched by the first run, every
    launch of the BA kernels from the mapping stream (on the card), and
    the second run equal to the first bit for bit.  Logs frames/s beside
    the inline rate, the mapping passes' wall ms and the share of their
    time hidden behind tracking: 1 - (the caller's ms waiting in joins) /
    (the worker's ms in mapping passes).  Then the first ``split_frames``
    frames again with tracking on the CPU (``run_split_pipeline``)."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine import CameraParams, SfMEngine
    from sfm_tpu_torch.parallel.pipeline import AsyncMappingEngine
    from sfm_tpu_torch.synthetic import keyframe_ate

    H, W = cfg.image_size
    frames, rvecs, tvecs = strafe_frames(n_frames, H, W, K)
    staged = [torch.as_tensor(f, device=dev) for f in frames]
    Kt = torch.as_tensor(K, device=dev)
    cam = CameraParams(K=Kt, d=torch.zeros(5, device=dev), Kopt=Kt)
    skip = min(10, n_frames // 3)      # frames left out of the rates

    t_phase = time.perf_counter()
    inline = SfMEngine(K, (H, W), config=cfg, device=dev, seed=0)
    sync(torch, dev)
    secs = []
    for img in staged:
        t0 = time.perf_counter()
        inline.add_frame(img)               # fetches the metrics: synced
        secs.append(time.perf_counter() - t0)
    inline_fps = (n_frames - skip) / sum(secs[skip:])

    runs = []
    for _ in range(2):
        eng = AsyncMappingEngine(cfg, cam, merge_lag=merge_lag, device=dev,
                                 seed=0)
        sync(torch, dev)
        native.reset_launch_counts()
        secs, metrics = [], []
        for img in staged:
            t0 = time.perf_counter()
            metrics.append(eng.step(img))
            secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng.flush()
        sync(torch, dev)
        runs.append(dict(
            eng=eng, status=[int(m["status"]) for m in metrics],
            fps=(n_frames - skip) / sum(secs[skip:]),
            flush_ms=1e3 * (time.perf_counter() - t0),
            launches=dict(native.LAUNCHES),
            by_stream=dict(native.STREAM_LAUNCHES),
            digest=state_digest(eng.state)))
    first, eng = runs[0], runs[0]["eng"]
    status = np.array(first["status"])
    boot = int(np.argmax(status == 1)) if (status == 1).any() else None
    if boot is None:
        raise AssertionError(f"{label}: the scan never bootstrapped")
    running = float((status[boot + 1:] == 1).mean())
    traj, fns = state_trajectory(eng.state)
    ate, extent = keyframe_ate(traj, fns, rvecs, tvecs)
    lv = eng.state.lms.valid
    n_views = int(eng.state.lms.n_views[lv].max()) if bool(lv.any()) else 0
    t = eng.timer
    map_s, wait_s = t.totals["mapping"], t.totals["join_wait"]
    hidden = 1.0 - wait_s / map_s if map_s > 0 else float("nan")
    map_stream = eng._stream.cuda_stream if eng._stream is not None else None
    on_map = {k: first["by_stream"].get((k, map_stream), 0)
              for k in first["launches"]}
    log(f"[{label}] merge_lag {merge_lag}: bootstrap on frame {boot}; "
        f"{running:.1%} of later frames RUNNING; {len(fns)} keyframes "
        f"{fns.tolist()}; {int(lv.sum())} landmarks; ATE {ate:.5f} over "
        f"extent {extent:.3f} ({100 * ate / extent:.3f}%); "
        f"{t.counts['mapping']} mapping passes, "
        f"{1e3 * map_s / max(t.counts['mapping'], 1):.3f} ms each on the "
        f"worker; the caller waited {1e3 * wait_s:.3f} ms in "
        f"joins and {1e3 * t.totals['merge']:.3f} ms in merges: "
        f"{hidden:.1%} of the mapping time hidden behind tracking; "
        f"launches {first['launches']}, from the mapping stream {on_map}")
    log(f"[{label}] {first['fps']:.3f} frames/s over frames {skip}-"
        f"{n_frames - 1} (flush {first['flush_ms']:.3f} ms after them; the "
        f"rerun {runs[1]['fps']:.3f}), beside {inline_fps:.3f} frames/s "
        f"inline (SfMEngine.add_frame on the same frames); the phase "
        f"{time.perf_counter() - t_phase:.3f} s")
    checks = {
        "post-bootstrap frames RUNNING >= 90%": running >= 0.9,
        "keyframes >= 4": len(fns) >= 4,
        "sim(3) keyframe ATE < 2% of extent": ate < 0.02 * extent,
        "no keyframe or prev link to an invalid landmark":
            links_consistent(eng.state),
        "view counts survive the merges (max n_views >= 5)": n_views >= 5,
        "mapping passes merged": t.counts["mapping"] == t.counts["merge"]
        > 0,
        "a rerun gives the same statuses, keyframes and landmarks bit for "
        "bit": runs[1]["digest"] == first["digest"]
        and runs[1]["status"] == first["status"],
    }
    for name in kernels:
        checks[f"{name} launched by the phase"] = first["launches"][name] > 0
    if map_stream is not None:
        for name in MAPPING_KERNELS:
            checks[f"{name}: every launch from the mapping stream"] = \
                on_map[name] == first["launches"][name] > 0
        checks["hamming_match launched from the mapping stream"] = \
            on_map["hamming_match"] > 0
    run_checks(label, checks)
    split = run_split_pipeline(torch, dev, cfg, frames[:split_frames],
                               rvecs, tvecs, K=K, merge_lag=merge_lag,
                               label=f"{label} split")
    return dict(
        split=split,
        launches=first["launches"], launches_mapping_stream=on_map,
        fps=first["fps"], rerun_fps=runs[1]["fps"], inline_fps=inline_fps,
        mapping_passes=t.counts["mapping"],
        mapping_ms=1e3 * map_s / max(t.counts["mapping"], 1),
        join_wait_ms=1e3 * wait_s, merge_ms=1e3 * t.totals["merge"],
        tracking_ms=1e3 * t.totals["tracking"] / n_frames,
        hidden_share=hidden, ate_pct=100 * ate / extent, keyframes=len(fns),
        running=running, digest=first["digest"],
        keep=dict(staged=staged, cam=cam, cfg=cfg, merge_lag=merge_lag))


def run_split_pipeline(torch, dev, cfg, frames, rvecs, tvecs, K=K,
                       merge_lag=PIPELINE_LAG, label="pipeline split"):
    """``AsyncMappingEngine(track_device="cpu", map_device=dev)`` on the
    first frames of the pipeline's scan: the tracking state and the
    frames on the CPU, S0 copied to the card at each dispatch and M back
    at each join.  Checks the offline gates (on the frames there are),
    the merged state on the CPU, and K2 / K3 / K3-gather launched, every
    launch from the mapping stream.  On the CPU (a rehearsal) the mapping
    device is ``torch.device("cpu", 0)``, which differs from the
    tracking device's ``torch.device("cpu")``, so the copies run too."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine import CameraParams
    from sfm_tpu_torch.parallel.pipeline import AsyncMappingEngine
    from sfm_tpu_torch.synthetic import keyframe_ate

    on_card = torch.device(dev).type == "cuda"
    map_dev = torch.device(dev) if on_card else torch.device("cpu", 0)
    Kt = torch.as_tensor(K)
    cam = CameraParams(K=Kt, d=torch.zeros(5), Kopt=Kt)
    t0 = time.perf_counter()
    eng = AsyncMappingEngine(cfg, cam, track_device="cpu", map_device=map_dev,
                             merge_lag=merge_lag, seed=0)
    native.reset_launch_counts()
    status = [int(eng.step(f)["status"]) for f in frames]
    eng.flush()
    sync(torch, dev)
    secs = time.perf_counter() - t0
    launches, by_stream = dict(native.LAUNCHES), dict(native.STREAM_LAUNCHES)
    status = np.array(status)
    boot = int(np.argmax(status == 1)) if (status == 1).any() else None
    if boot is None:
        raise AssertionError(f"{label}: the scan never bootstrapped")
    running = float((status[boot + 1:] == 1).mean())
    traj, fns = state_trajectory(eng.state)
    ate, extent = keyframe_ate(traj, fns, rvecs, tvecs)
    passes = eng.timer.counts["mapping"]
    log(f"[{label}] tracking on the CPU, mapping on {map_dev}: "
        f"{len(frames)} frames in {secs:.3f} s; bootstrap on frame {boot}; "
        f"{running:.1%} of later frames RUNNING; {len(fns)} keyframes "
        f"{fns.tolist()}; ATE {ate:.5f} over extent {extent:.3f} "
        f"({100 * ate / extent:.3f}%); {passes} mapping passes "
        f"({1e3 * eng.timer.totals['mapping'] / max(passes, 1):.3f} ms each "
        f"on the worker); launches {launches}")
    checks = {
        "post-bootstrap frames RUNNING >= 90%": running >= 0.9,
        "keyframes >= 4": len(fns) >= 4,
        "sim(3) keyframe ATE < 2% of extent": ate < 0.02 * extent,
        "no keyframe or prev link to an invalid landmark":
            links_consistent(eng.state),
        "mapping passes merged": eng.timer.counts["merge"] == passes > 0,
        "the tracked state on the CPU": eng.state.lms.xyz.device.type
        == eng.state.kfs.frames.desc.device.type == "cpu",
    }
    if on_card:
        ours = eng._stream.cuda_stream
        for name in MAPPING_KERNELS:
            checks[f"{name}: launched, every launch from the mapping "
                   f"stream"] = by_stream.get((name, ours), 0) \
                == launches[name] > 0
    run_checks(label, checks)
    return dict(frames=len(frames), seconds=secs, running=running,
                keyframes=len(fns), ate_pct=100 * ate / extent,
                mapping_passes=passes, launches=launches)


def pipeline_device(torch, out, window=PIPELINE_PROFILED):
    """After the profiled kernel checks: the pipeline phase's scan once
    more, frames ``window[0]`` to ``window[1] - 1`` under torch.profiler
    (a whole scan's trace takes minutes to read back): the card's busy
    share, the kernels' device time summed over both streams over the
    window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from sfm_tpu_torch.parallel.pipeline import AsyncMappingEngine
    keep = out.pop("keep")
    eng = AsyncMappingEngine(keep["cfg"], keep["cam"],
                             merge_lag=keep["merge_lag"], device="cuda",
                             seed=0)
    lo, hi = window
    for img in keep["staged"][:lo]:
        eng.step(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in keep["staged"][lo:hi]:
            eng.step(img)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.flush()
    busy = sum(getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages()) / 1e6
    log(f"[pipeline] frames {lo}-{hi - 1} of the scan again under "
        f"torch.profiler (a keyframe's mapping pass in them): {wall:.3f} "
        f"s, the card busy {busy:.3f} s ({busy / wall:.1%}"
        f", both streams' kernel time summed)")
    return dict(frames=[lo, hi], profiled_s=wall, busy_s=busy,
                busy_share=busy / wall)


def _wire(metrics):
    """Metrics as a scan client receives them (the server's JSON)."""
    return json.loads(json.dumps(
        {k: (v.tolist() if hasattr(v, "tolist") else v)
         for k, v in metrics.items()}))


def _feed(add_frame, add_frames, frames, single, chunk, to_wire):
    """``single`` frames one by one, the rest in chunks of ``chunk``:
    (metrics as JSON dicts, ms per single frame, seconds in chunks)."""
    metrics, single_ms = [], []
    for f in frames[:single]:
        t0 = time.perf_counter()
        metrics.append(to_wire(add_frame(f)))
        single_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    for s in range(single, len(frames), chunk):
        metrics += [to_wire(m) for m in add_frames(frames[s:s + chunk])]
    return metrics, single_ms, time.perf_counter() - t0


def run_serve(torch, dev, overrides, kernels, K=K, n_frames=SERVE_FRAMES,
              n_single=SERVE_SINGLE, seeds=SERVE_SEEDS, label="serve"):
    """``ScanServer`` on 127.0.0.1 (port 0) on ``dev``: two clients at once,
    each on its own thread, each INIT with ``overrides`` (a configuration
    without the image size), then ``n_frames`` uint8 RGB frames of a
    strafe (scene seed ``seeds[i]``): ``n_single`` by FRAME, the rest by
    FRAMES in chunks of keyframe_time_lag; then GET_CLOUD and CLOSE.  A
    third connection sends FRAME before INIT.  Each served scan must equal
    the same frames fed in the same way to an in-process ``SfMEngine``:
    every frame's metrics, its keyframes, and the cloud bit for bit.  Also
    checked: some cloud colour is not grey, the kernels of ``kernels``
    launched by the served scans, and MSG_ERROR for the early FRAME.
    Logs the per-frame round trip beside in-process add_frame, the FRAMES
    rate and the two clients' aggregate frames/s."""
    import threading

    from sfm_tpu_torch import native
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.engine import SfMEngine
    from sfm_tpu_torch.serving import ScanClient, ScanServer

    cfg = SfMConfig(**overrides)
    H, W = cfg.image_size
    wire_cfg = {k: v for k, v in overrides.items()
                if k not in ("image_height", "image_width")}
    lag = cfg.keyframe_time_lag
    scans = [np.stack(strafe_frames(n_frames, H, W, K, rgb=True,
                                    seed=sd)[0]).astype(np.uint8)
             for sd in seeds]
    refs = []
    for frames in scans:
        eng = SfMEngine(K, (H, W), None, cfg, device=dev)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        metrics, single_ms, chunk_s = _feed(
            lambda f: eng.add_frame(f32(f)),
            lambda fs: eng.add_frames(f32(fs)), frames, n_single, lag, _wire)
        refs.append(dict(metrics=metrics, single_ms=single_ms,
                         chunk_s=chunk_s, cloud=eng.get_reconstruction()))

    served, errors = [None] * len(scans), []
    sync(torch, dev)
    native.reset_launch_counts()
    with ScanServer(device=dev) as srv:
        def client(i):
            try:
                cli = ScanClient("127.0.0.1", srv.port)
                cli.init(H, W, float(K[0, 0]), float(K[1, 1]),
                         float(K[0, 2]), float(K[1, 2]), config=wire_cfg)
                metrics, single_ms, chunk_s = _feed(
                    cli.add_frame, cli.add_frames, scans[i], n_single, lag,
                    lambda m: m)
                served[i] = dict(metrics=metrics, single_ms=single_ms,
                                 chunk_s=chunk_s, cloud=cli.get_cloud())
                cli.close()
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(scans))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        early = ScanClient("127.0.0.1", srv.port)
        try:
            early.add_frame(scans[0][0])
            early_error = None
        except RuntimeError as e:
            early_error = str(e)
        early._sock.close()
    if errors:
        raise errors[0]

    def kf_frames(ms):
        return [i for i, m in enumerate(ms) if m["keyframe_added"]]
    checks = {}
    rtt = np.concatenate([s["single_ms"] for s in served])
    local = np.concatenate([r["single_ms"] for r in refs])
    for i, (s, r) in enumerate(zip(served, refs)):
        status = [m["status"] for m in s["metrics"]]
        diff = [k for k, (a, b) in enumerate(zip(s["metrics"], r["metrics"]))
                if a != b]
        (xyz, rgb), (pts, cols) = s["cloud"], r["cloud"]
        log(f"[{label}] client {i} (scene seed {seeds[i]}): statuses "
            f"{''.join(map(str, status))}; keyframes at frames "
            f"{kf_frames(s['metrics'])}; {len(xyz)} cloud points; frames "
            f"whose metrics differ from in-process: {diff}")
        checks.update({
            f"client {i}: the scan bootstraps and ends RUNNING":
                1 in status and status[-1] == 1,
            f"client {i}: the same status on every frame as in-process":
                status == [m["status"] for m in r["metrics"]],
            f"client {i}: the same keyframe frames as in-process":
                kf_frames(s["metrics"]) == kf_frames(r["metrics"]),
            f"client {i}: every frame's metrics equal in-process": not diff,
            f"client {i}: cloud xyz and rgb bit for bit as in-process":
                np.array_equal(xyz, pts) and np.array_equal(rgb, cols)
                and len(xyz) > 0,
            f"client {i}: some cloud colour is not grey": bool(
                ((rgb[:, 0] != rgb[:, 1]) | (rgb[:, 1] != rgb[:, 2])).any()),
        })
    checks["FRAME before INIT gives MSG_ERROR"] = \
        early_error == "FRAME before INIT"
    for name in kernels:
        checks[f"{name} launched by the served scans"] = launches[name] > 0
    n_chunked = n_frames - n_single
    frames_rate = n_chunked * len(scans) / sum(s["chunk_s"] for s in served)
    agg = n_frames * len(scans) / wall
    log(f"[{label}] FRAME round trip median {np.median(rtt):.3f} ms, p95 "
        f"{np.percentile(rtt, 95):.3f} ms (two clients at once) beside "
        f"in-process add_frame median {np.median(local):.3f} ms, p95 "
        f"{np.percentile(local, 95):.3f} ms (alone); FRAMES "
        f"{frames_rate:.3f} frames/s per client; {agg:.3f} frames/s over "
        f"both clients ({wall:.3f} s); launches {launches}")
    run_checks(label, checks)
    return dict(launches=launches, rtt_median_ms=float(np.median(rtt)),
                rtt_p95_ms=float(np.percentile(rtt, 95)),
                local_median_ms=float(np.median(local)),
                local_p95_ms=float(np.percentile(local, 95)),
                frames_fps_per_client=frames_rate, aggregate_fps=agg,
                wall_s=wall)


# the "dist" phase's sizes, handed to its ranks: benchmarks/
# bench_dist_model.py's pod (5120 cameras, 2**20 landmarks, kmax 8) for the
# distributed implicit-Schur solver, 10 LM x 25 CG, as one rank under NCCL
# and as 4 gloo ranks sharing the card; the dense solver at FLAGSHIP's
# width (32 keyframes, its ba_landmark_capacity of 2048 landmarks, each
# seen by 8 keyframes), 12 LM iterations; the sharded fleet (the fleet
# phase's scans, 8 of them over 2 ranks, 10 frames, FLAGSHIP)
# the helpers phase: match_pairs' caps (each a share of the matches: one
# that holds them all, one that they overflow), the BA modes' LM iterations,
# the homography RANSAC's plane (outliers, hypotheses), and K1's and K5's
# kernels, which the traced frame's trace must show
HELPERS_CAPS = (2.0, 0.5)
HELPERS_BA_ITERATIONS = 10
HELPERS_OUTLIERS, HELPERS_HYPOTHESES = 0.25, 128
TRACE_KERNELS = ("cells_kernel", "dense_kernel", "epilogue_kernel",
                 "patch_kernel")


def homography_problem(rng, K=K, n=400, outliers=HELPERS_OUTLIERS):
    """A plane seen from two poses (an exact homography between the views),
    a share of the second view's points replaced by outliers, 0.3 px
    noise: (uv0, uv1, valid, outlier) in numpy."""
    from sfm_tpu_torch.np_geometry import project_np, rodrigues_np
    xy = rng.uniform(-2, 2, (n, 2))
    X = np.stack([xy[:, 0], xy[:, 1], 5.0 + 0.2 * xy[:, 0] - 0.1 * xy[:, 1]],
                 1)
    uv0 = project_np(K, np.eye(3), np.zeros(3), X)
    uv1 = project_np(K, rodrigues_np(np.array([0.02, -0.05, 0.01])),
                     np.array([0.4, 0.05, -0.03]), X)
    out = rng.uniform(0, 1, n) < outliers
    uv1[out] = rng.uniform(0, [2 * K[0, 2], 2 * K[1, 2]], (out.sum(), 2))
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    return (uv0.astype(np.float32), uv1.astype(np.float32),
            rng.uniform(0, 1, n) < 0.95, out)


def trace_kernels(logdir):
    """The kernel events of every Chrome trace under ``logdir``, by the
    kernels' short names."""
    import pathlib
    names = []
    for path in pathlib.Path(logdir).glob("*.json"):
        for e in json.loads(path.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                names.append(_short(e.get("name", "")))
    return names


def run_helpers(torch, dev, eng, trace_dir, K=K, n_frames=N_FRAMES,
                label="helpers"):
    """The public helpers no engine path calls, on the card, around the
    FLAGSHIP scan's final engine ``eng`` (``n_frames`` frames in):

    - ``match_pairs`` on K1's MatchResult at the tracking shape (512x512),
      with caps that hold every match and that the matches overflow,
      against the pairs of the plain matcher's result on the CPU, exactly;
    - ``run_ba`` in POSE_ONLY and STRUCT_ONLY on the final map (every
      keyframe and live landmark, the scan's Huber delta): the cost must
      not rise, ``total_cost`` must give the solver's costs, and the
      frozen block must come back bit for bit;
    - ``ransac_homography`` on a plane's matches on the card, against its
      plain run on the CPU with the card's samples injected (the same
      inliers, H within 2e-3 normalised) and against the truth;
    - ``remove_keyframe`` of the newest keyframe on the card's store: that
      slot alone invalid, every other leaf the same tensor, the
      landmarks' view counts down by its links, the next insertion in it;
    - one more strafe frame tracked by ``eng.add_frame`` inside
      ``device_trace(trace_dir)``: the trace written must hold a K1 or K5
      kernel event (on the card).

    Every check gates; K1 must have been launched by the phase."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.ba import (BAMode, observations_from_keyframes, run_ba,
                                  total_cost)
    from sfm_tpu_torch.features.match import match_pairs
    from sfm_tpu_torch.features.match_pallas import match_features_pallas
    from sfm_tpu_torch.mapstore import (insert_keyframe, kf_view_counts,
                                        remove_keyframe)
    from sfm_tpu_torch.ransac import ransac_homography, sample_masked
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory
    from sfm_tpu_torch.utils import device_trace

    on_card = torch.device(dev).type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    checks = {}
    native.reset_launch_counts()

    # match_pairs on K1's result
    args, kw = k1_inputs(torch, np.random.default_rng(21), K1_CASES[0], dev)
    res = match_features_pallas(*(a[0] for a in args[:6]), **kw)
    ref = match_features_pallas(*(a[0].to(cpu) for a in args[:6]), **kw)
    n_match = int(ref.mask.sum())
    caps = [max(1, int(c * n_match)) for c in HELPERS_CAPS]
    pairs_equal = all(torch.equal(a.cpu(), b) for a, b in zip(res, ref))
    for cap in caps:
        ours, plain = match_pairs(res, cap), match_pairs(ref, cap)
        pairs_equal &= all(torch.equal(a.cpu(), b)
                           for a, b in zip(ours, plain))
        pairs_equal &= int(ours[2].sum()) == min(cap, n_match)
    checks["match_pairs on K1's result equals the plain matcher's pairs "
           "exactly"] = pairs_equal
    log(f"[{label}] match_pairs on K1's {K1_CASES[0][0]} result: "
        f"{n_match} matches, caps {caps}: "
        f"{'exact' if pairs_equal else 'DIFFER'}")

    # the BA modes on the final map
    st, cfg = eng.state, eng.config
    obs = observations_from_keyframes(st.kfs, st.lms.valid)
    fr = st.kfs.frames
    ba_out = {}
    for mode in (BAMode.POSE_ONLY, BAMode.STRUCT_ONLY):
        sync(torch, dev)
        t0 = time.perf_counter()
        rv, tv, xyz, stats = run_ba(
            eng.cam.Kopt, fr.rvec, fr.tvec, st.lms.xyz, obs,
            cam_free=st.kfs.valid, lm_free=st.lms.valid, mode=mode,
            iterations=HELPERS_BA_ITERATIONS, huber_delta=cfg.ba_huber_delta)
        sync(torch, dev)
        ms = 1e3 * (time.perf_counter() - t0)
        c0, c1 = float(stats.initial_cost), float(stats.final_cost)
        tc0 = float(total_cost(eng.cam.Kopt, fr.rvec, fr.tvec, st.lms.xyz,
                               obs, cfg.ba_huber_delta))
        tc1 = float(total_cost(eng.cam.Kopt, rv, tv, xyz, obs,
                               cfg.ba_huber_delta))
        if mode == BAMode.POSE_ONLY:
            frozen = torch.equal(xyz, st.lms.xyz)
            step = (rv - fr.rvec)[st.kfs.valid].norm(dim=-1)
        else:
            frozen = torch.equal(rv, fr.rvec) and torch.equal(tv, fr.tvec)
            step = (xyz - st.lms.xyz)[st.lms.valid].norm(dim=-1)
        moved = (float(step.median()), float(step.max()))
        log(f"[{label}] run_ba {mode.name} on the final map "
            f"({int(st.kfs.valid.sum())} keyframes, "
            f"{int(st.lms.valid.sum())} landmarks, {int(obs.w.sum())} "
            f"observations): cost {c0:.6e} -> {c1:.6e} in "
            f"{int(stats.accepted)} accepted steps, {ms:.3f} ms; the free "
            f"block moved {moved[0]:.3e} (median), {moved[1]:.3e} (most); "
            f"the frozen block "
            f"{'unchanged bit for bit' if frozen else 'CHANGED'}; total_cost "
            f"{tc0:.6e} -> {tc1:.6e}")
        checks[f"run_ba {mode.name}: the cost does not rise"] = c1 <= c0
        checks[f"run_ba {mode.name}: the frozen block unchanged bit for "
               f"bit"] = frozen
        checks[f"run_ba {mode.name}: total_cost gives the solver's costs "
               f"(rel 1e-5)"] = (abs(tc0 - c0) <= 1e-5 * c0
                                 and abs(tc1 - c1) <= 1e-5 * max(c1, 1e-30))
        ba_out[mode.name] = dict(initial_cost=c0, final_cost=c1,
                                 accepted=int(stats.accepted), ms=ms,
                                 moved_median=moved[0], moved_max=moved[1])

    # ransac_homography
    uv0, uv1, valid, out = homography_problem(np.random.default_rng(22), K)
    t = [torch.as_tensor(a, device=dev) for a in (uv0, uv1, valid)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    samples = sample_masked(gen, t[2], HELPERS_HYPOTHESES, 4)
    hom = ransac_homography(None, *t, samples=samples)
    hom_cpu = ransac_homography(None, *(a.to(cpu) for a in t),
                                samples=samples.to(cpu))

    def unit(H):
        h = H.double().cpu().reshape(-1)
        h = h / torch.linalg.norm(h)
        return h * torch.sign(h[torch.argmax(h.abs())])
    inl = hom.inliers.cpu().numpy()
    h_gap = float((unit(hom.model) - unit(hom_cpu.model)).abs().max())
    checks["ransac_homography on the card: the CPU run's inliers, H within "
           "2e-3 normalised"] = (torch.equal(hom.inliers.cpu(),
                                             hom_cpu.inliers)
                                 and h_gap <= 2e-3)
    true_share = float(inl[~out & valid].mean())
    checks["ransac_homography: >= 95% of the true inliers, < 5% of the "
           "outliers"] = true_share >= 0.95 and inl[out].mean() < 0.05
    log(f"[{label}] ransac_homography on {len(uv0)} matches "
        f"({HELPERS_OUTLIERS:.0%} outliers, {HELPERS_HYPOTHESES} "
        f"hypotheses): {int(hom.n_inliers)} inliers, {true_share:.1%} of "
        f"the true ones; H {h_gap:.2e} from the CPU run's")

    # remove_keyframe
    kfs = st.kfs
    slot = int(np.argmax(np.where(kfs.valid.cpu().numpy(),
                                  fr.frame_no.cpu().numpy(), -1)))
    kfs2 = remove_keyframe(kfs, slot)
    want = kfs.valid.clone()
    want[slot] = False
    L = st.lms.valid.shape[0]
    links = fr.landmark[slot][(fr.landmark[slot] >= 0)
                              & fr.kp_valid[slot]].long()
    drop = torch.zeros(L, dtype=torch.int32, device=kfs.valid.device)
    drop.index_add_(0, links, torch.ones_like(links, dtype=torch.int32))
    same_leaves = all(getattr(kfs2.frames, f) is getattr(fr, f)
                      for f in ("xy", "desc", "landmark", "rvec", "tvec"))
    _, again = insert_keyframe(kfs2, eng.state.prev)
    lowest_free = int(torch.nonzero(~kfs2.valid)[0])
    checks["remove_keyframe: that slot alone invalid, every other leaf "
           "unchanged"] = torch.equal(kfs2.valid, want) and same_leaves
    checks["remove_keyframe: view counts down by its links, the slot on "
           "the free list"] = (torch.equal(
               kf_view_counts(kfs, L) - drop, kf_view_counts(kfs2, L))
               and int(again) == lowest_free <= slot)
    log(f"[{label}] remove_keyframe of slot {slot} (frame "
        f"{int(fr.frame_no[slot])}, {len(links)} links) on {dev}; "
        f"the next insertion takes slot {int(again)}")

    # one tracked frame under device_trace
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rvecs, tvecs = strafe_trajectory(n_frames + 1, step=0.06,
                                     yaw_rate=0.001)
    H, W = cfg.image_size
    img = torch.as_tensor(scene.render(K, rvecs[n_frames], tvecs[n_frames],
                                       H, W), device=dev)
    with device_trace(trace_dir):
        m = eng.add_frame(img)
    names = trace_kernels(trace_dir)
    shown = sorted({n for n in names if n in TRACE_KERNELS})
    checks["the traced frame RUNNING"] = int(m["status"]) == 1
    if on_card:
        checks["the trace holds a K1 or K5 kernel event"] = bool(shown)
    launches = dict(native.LAUNCHES)
    checks["hamming_match launched by the phase"] = \
        launches["hamming_match"] > 0
    log(f"[{label}] frame {n_frames} tracked under device_trace: "
        f"{len(names)} kernel events, of K1 and K5 {shown}; launches "
        f"{launches}; the phase {time.perf_counter() - t_phase:.3f} s")
    run_checks(label, checks)
    return dict(matches=n_match, caps=caps, ba=ba_out,
                homography_inliers=int(hom.n_inliers),
                removed_slot=slot, trace_kernels=shown, launches=launches,
                seconds=time.perf_counter() - t_phase)


DIST_SIZE = dict(C=5120, L=1 << 20, kmax=8, ranks=4, lm=10, cg=25,
                 dense_c=32, dense_l=2048, dense_obs=8, dense_lm=12,
                 fleet_scans=8, fleet_ranks=2, fleet_frames=10, cfg=None, K=K)
# the seconds a spawned world of ranks may take
DIST_TIMEOUT = 400.0
DIST_KERNELS = ("ba_linearize", "schur_apply", "schur_gather")


def pod_problem(torch, dev, C, L, kmax, ranks, seed=0):
    """benchmarks/bench_dist_scaling.py's problem (landmark l seen by the
    kmax consecutive cameras from its home camera l (C - kmax) // L; uv
    projected at f 525; the cameras 0.002 rad off, camera 0 frozen; X
    moved by N(0, 0.05)) with C cameras and L landmarks (DIST_SIZE:
    benchmarks/bench_dist_model.py's pod, 8.4 M observations), on
    ``dev``; with nmax for 1 and ``ranks`` shards."""
    from sfm_tpu_torch.ba.residuals import Observations
    rng = np.random.default_rng(seed)
    home = (np.arange(L) * (C - kmax) // L).astype(np.int32)
    cam_idx = (home[:, None] + np.arange(kmax)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(L, dtype=np.int32), kmax)
    X = np.stack([rng.uniform(-40, 40, L), rng.uniform(-8, 8, L),
                  rng.uniform(20, 50, L)], 1).astype(np.float32)
    cam_t = np.stack([np.linspace(-35, 35, C), np.zeros(C),
                      np.zeros(C)], 1).astype(np.float32)
    p = X[lm_idx] + cam_t[cam_idx]
    uv = ((p[:, :2] / p[:, 2:]) * 525.0
          + np.array([320.0, 240.0])).astype(np.float32)
    rv0 = np.zeros((C, 3), np.float32)
    rv0[1:] += 0.002
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=dev)
    cam_free = torch.ones(C, dtype=torch.bool, device=dev)
    cam_free[0] = False
    # nmax: the most observations of one camera in one shard, per count of
    # shards (a shard's landmarks have contiguous home cameras)
    nmax = {n: int(np.bincount((lm_idx // (L // n)).astype(np.int64) * C
                               + cam_idx).max()) for n in (1, ranks)}
    return dict(K=t(K), rv=t(rv0), tv=t(cam_t), X=t(X0),
                obs=Observations(t(cam_idx, torch.int64),
                                 t(lm_idx, torch.int64), t(uv),
                                 torch.ones(len(cam_idx), device=dev)),
                cam_free=cam_free,
                lm_free=torch.ones(L, dtype=torch.bool, device=dev),
                nmax=nmax, C=C, L=L, kmax=kmax)


def all_reduce_ms(torch, mesh, C, dev, reps=50):
    """Host ms per all-reduce of a [C, 6] f32 vector over "map" (what a CG
    iteration of the distributed solver sends), on the host clock around
    synchronised calls."""
    from sfm_tpu_torch.parallel.dist_ba import all_sum
    group = mesh.get_group("map")
    v = torch.zeros((C, 6), device=dev)
    for _ in range(5):
        all_sum(group, v)
    sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        all_sum(group, v)
    sync(torch, dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def pod_solve(torch, mesh, pr, dev, lm, cg):
    """``build_dist_large_ba`` on the pod problem over "map" of ``mesh``
    (``lm`` LM x ``cg`` CG iterations): the tables by ``partition_tables``
    on the device with the problem's nmax; one untimed run, then one run
    timed on the host clock with this rank's launches of K2, K3 and
    K3-gather counted from 0; then the all-reduce of a CG iteration."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.parallel import build_dist_large_ba, partition_tables
    from sfm_tpu_torch.parallel.dist_ba import axis_shard
    _, pos, n = axis_shard(mesh, "map")
    C, L = pr["C"], pr["L"]
    t0 = time.perf_counter()
    tabs, shard = partition_tables(pr["obs"], C, L, n, pr["nmax"][n],
                                   pr["kmax"], device=dev)
    sync(torch, dev)
    part_s = time.perf_counter() - t0
    fn = build_dist_large_ba(mesh, "map", C, shard, iterations=lm,
                             cg_iterations=cg)
    args = (pr["K"], pr["rv"], pr["tv"], pr["X"], tabs, pr["cam_free"],
            pr["lm_free"])
    fn(*args)
    sync(torch, dev)
    native.reset_launch_counts()
    t0 = time.perf_counter()
    rv, tv, X_l, st = fn(*args)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    launches = {k: native.LAUNCHES[k] for k in DIST_KERNELS}
    return dict(ranks=n, map_rank=pos, shard_size=shard,
                nmax=pr["nmax"][n], table_shape=list(tabs.cam_lm.shape),
                partition_s=part_s, ms_per_lm_iter=1e3 * secs / lm,
                all_reduce_ms=all_reduce_ms(torch, mesh, C, dev),
                initial_cost=float(st.initial_cost),
                final_cost=float(st.final_cost), accepted=int(st.accepted),
                launches=launches, landmarks_finite=bool(
                    torch.isfinite(X_l).all()),
                rv=rv.cpu().numpy(), tv=tv.cpu().numpy())


def dense_problem(C, L, obs_per_lm, seed=1, noise_px=0.0):
    """A dense BA problem at FLAGSHIP's width, in numpy: C keyframes along
    a strafe, landmark l seen by obs_per_lm consecutive keyframes from a
    random first one, pixels with ``noise_px`` of noise (none, as in
    tests/test_parallel.py's scenes: the minimum is the truth, where two
    f32 LM runs meet; with noise, steps that change the cost by its
    rounding are taken or refused by chance and the runs wander apart
    along flat directions); poses moved by N(0, 0.005) rad and
    N(0, 0.01), landmarks by N(0, 0.05); keyframes 0 and 1 frozen (pose
    and scale gauge)."""
    from sfm_tpu_torch.np_geometry import rodrigues_np
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                  rng.uniform(4, 10, L)], 1)
    rv = rng.uniform(-0.02, 0.02, (C, 3))
    tv = np.stack([-0.06 * np.arange(C), rng.uniform(-0.02, 0.02, C),
                   rng.uniform(-0.02, 0.02, C)], 1)
    first = rng.integers(0, C - obs_per_lm + 1, L)
    lm_idx = np.repeat(np.arange(L), obs_per_lm)
    cam_idx = (first[:, None] + np.arange(obs_per_lm)[None, :]).reshape(-1)
    R = np.stack([rodrigues_np(r) for r in rv])
    p = np.einsum("oab,ob->oa", R[cam_idx], X[lm_idx]) + tv[cam_idx]
    uv = p[:, :2] / p[:, 2:] * 525.0 + np.array([320.0, 240.0])
    uv += rng.normal(0, noise_px, uv.shape)
    frozen = np.arange(C) < 2
    f = np.float32
    return dict(K=K, rv=np.where(frozen[:, None], rv, rv + rng.normal(
        0, 0.005, rv.shape)).astype(f),
        tv=np.where(frozen[:, None], tv, tv + rng.normal(
            0, 0.01, tv.shape)).astype(f),
        X=(X + rng.normal(0, 0.05, X.shape)).astype(f),
        obs=(cam_idx, lm_idx, uv.astype(f), np.ones(len(uv), f)),
        cam_free=~frozen, lm_free=np.ones(L, bool))


def dense_solve(torch, mesh, dev, size):
    """``build_dist_ba`` on ``dense_problem`` over "map" (size["dense_lm"]
    iterations): this rank's poses, landmark shard and costs."""
    from sfm_tpu_torch.ba.residuals import Observations
    from sfm_tpu_torch.parallel import build_dist_ba, partition_observations
    from sfm_tpu_torch.parallel.dist_ba import axis_shard
    _, pos, n = axis_shard(mesh, "map")
    C, L, n_obs = size["dense_c"], size["dense_l"], size["dense_obs"]
    p = dense_problem(C, L, n_obs)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    obs_sh, shard = partition_observations(
        Observations(*map(torch.as_tensor, p["obs"])), L, n,
        L // n * n_obs)
    fn = build_dist_ba(mesh, "map", C, shard, iterations=size["dense_lm"])
    t0 = time.perf_counter()
    rv, tv, X_l, st = fn(t(p["K"]), t(p["rv"]), t(p["tv"]), t(p["X"]),
                         Observations(*map(t, obs_sh)), t(p["cam_free"]),
                         t(p["lm_free"]))
    sync(torch, dev)
    return dict(map_rank=pos, ms_per_lm_iter=1e3 * (time.perf_counter() - t0)
                / size["dense_lm"], initial_cost=float(st.initial_cost),
                final_cost=float(st.final_cost), accepted=int(st.accepted),
                rv=rv.cpu().numpy(), tv=tv.cpu().numpy(),
                X=X_l.cpu().numpy())


def _dist_rank(rank, world, tmp, dev, size):
    """A rank of the dist phase's world of size["ranks"] gloo ranks on
    ``dev`` (the card): the pod solve, the dense solve, then
    dryrun_multichip; writes its numbers to ``tmp``/dist.{rank}.pkl."""
    import pickle

    import torch

    from sfm_tpu_torch import native
    from sfm_tpu_torch.entry import dryrun_multichip
    from sfm_tpu_torch.parallel import make_scan_map_mesh
    mesh = make_scan_map_mesh(1, device=dev)
    pr = pod_problem(torch, dev, size["C"], size["L"], size["kmax"], world)
    pod = pod_solve(torch, mesh, pr, dev, size["lm"], size["cg"])
    del pr
    dense = dense_solve(torch, mesh, dev, size)
    native.reset_launch_counts()
    dry = dryrun_multichip(world, device=dev)
    sync(torch, dev)
    dry = dict(launches={k: v for k, v in native.LAUNCHES.items() if v},
               status=dry["metrics"]["status"].tolist(),
               dense=[float(dry["dist_ba"][3].initial_cost),
                      float(dry["dist_ba"][3].final_cost)],
               large=[float(dry["dist_large_ba"][3].initial_cost),
                      float(dry["dist_large_ba"][3].final_cost)],
               engine_status=int(dry["large_engine"]["status"]))
    with open(f"{tmp}/dist.{rank}.pkl", "wb") as f:
        pickle.dump(dict(pod=pod, dense=dense, dryrun=dry), f)


def fleet_record(torch, step, states, frames, native=None, sites=None):
    """Step a fleet through ``frames`` (uint8 [T, B, H, W] on the card):
    per frame the statuses, keyframe counts and poses, at the end the
    keyframes and landmarks; with ``native`` and ``sites``
    (``count_k1_sites``), per step the scans RUNNING before it and the
    K1 launches at the tracking step's sites and the K5 launches in it."""
    from sfm_tpu_torch.engine.state import RUNNING
    rec = {k: [] for k in ("status", "n_keyframes", "rvec", "tvec")}
    steps = []
    for images in frames:
        running = int((states.status == RUNNING).sum())
        if native is not None:
            n0, s0 = dict(native.LAUNCHES), dict(sites)
        states, m = step(states, images)
        for k in rec:
            rec[k].append(m[k].cpu().numpy())
        if native is not None:
            steps.append(dict(running=running, k1_tracking=sum(
                v - s0.get(k, 0) for k, v in sites.items()
                if k.startswith("tracking.")),
                k5=native.LAUNCHES["patch_sampler"] - n0["patch_sampler"]))
    out = {k: np.stack(v) for k, v in rec.items()}
    kf, lms = states.kfs, states.lms
    out.update(kf_valid=kf.valid, kf_rvec=kf.frames.rvec,
               kf_tvec=kf.frames.tvec, kf_frame_no=kf.frames.frame_no,
               lm_valid=lms.valid, lm_xyz=lms.xyz)
    out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
           for k, v in out.items()}
    return out, steps


def _fleet_rank(rank, world, tmp, frames_path, dev, size):
    """A rank of the sharded fleet: its block of the fleet's scans through
    ``build_sharded_step`` on a (world, 1) mesh, the block of states left
    on the device it was made on by ``shard_batched_state``'s default;
    writes its record, its per-step launches, its launch counts and (rank
    0) its K1 calls at the tracking step to ``tmp``/fleet.{rank}.pkl."""
    import pickle

    import torch

    from sfm_tpu_torch import native
    from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
    from sfm_tpu_torch.engine.state import CameraParams, init_batched_state
    from sfm_tpu_torch.parallel import (build_sharded_step,
                                        make_scan_map_mesh,
                                        shard_batched_state)
    cfg = SfMConfig(**(size["cfg"] or FLAGSHIP))
    Kt = torch.as_tensor(size["K"])
    cam = CameraParams(K=Kt, d=torch.zeros(5), Kopt=Kt)
    mesh = make_scan_map_mesh(world, device=dev)
    frames = np.load(frames_path)
    states = shard_batched_state(
        init_batched_state(cfg, frames.shape[1], dev), mesh)
    blocks = [shard_batched_state(torch.as_tensor(f), mesh, device=dev)
              for f in frames]
    calls = [] if rank == 0 else None
    sites, restore = count_k1_sites(native, record=calls,
                                    record_sites=("tracking.",))
    native.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rec, steps = fleet_record(
            torch, build_sharded_step(cfg, cam, mesh), states, blocks,
            native, sites)
    finally:
        restore()
    sync(torch, dev)
    out = dict(record=rec, steps=steps, secs=time.perf_counter() - t0,
               launches={k: v for k, v in native.LAUNCHES.items() if v},
               scan_rank=mesh.get_local_rank("scan"),
               state_device=str(states.status.device),
               k1_calls=[(site, tuple(x.cpu() if torch.is_tensor(x) else x
                                      for x in args))
                         for site, args in calls or ()])
    with open(f"{tmp}/fleet.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _rank_main(rank, fn, world, store, dev, timeout, args):
    """A spawned rank: full float32 matmuls; on the card its device (the
    ranks of a world share card 0: NCCL takes one rank per card, so they
    join under gloo), on the CPU one thread.  With ``store`` it joins a
    gloo world of ``world`` ranks through that file store around
    ``fn(rank, world, *args)``; without, ``fn`` joins one itself."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    if store is None:
        return fn(rank, world, *args)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world, args, store=None, dev="cpu",
                timeout=DIST_TIMEOUT):
    """``fn(rank, world, *args)`` in ``world`` spawned processes on
    ``dev``, joined in a gloo world through the file store ``store``
    (``_rank_main``).  A rank that raises fails them all, and a world
    still running after ``timeout`` seconds is killed and raises
    TimeoutError."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, store, dev, timeout, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: {world} ranks still "
                               f"running after {timeout} s")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pod_world_of_one(torch, pr, dev, lm, cg):
    """The pod solve as a world of one (NCCL on the card), through
    torchrun's variables, ``initialize_hosts`` and ``make_scan_map_mesh``
    on their defaults (``device`` aside: the CPU where the phase is
    rehearsed)."""
    import os

    import torch.distributed as dist

    from sfm_tpu_torch.parallel import initialize_hosts, make_scan_map_mesh
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    on_card = torch.device(dev).type == "cuda"
    try:
        if on_card:
            initialize_hosts()
            mesh = make_scan_map_mesh()
        else:
            initialize_hosts(device=dev)
            mesh = make_scan_map_mesh(device=dev)
        out = pod_solve(torch, mesh, pr, dev, lm, cg)
        out.update(backend=dist.get_backend(),
                   mesh_shape=list(mesh.mesh.shape))
        return out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def run_dist(torch, dev, workers=RENDER_WORKERS, size=None):
    """The dist phase (see the module docstring) at ``size`` (DIST_SIZE;
    smaller where it is rehearsed on the CPU, where no kernel launches).
    Returns its numbers, with the pod problem under "keep" for
    ``pod_kernel_rows``."""
    import pickle
    import tempfile

    from sfm_tpu_torch.ba.core import run_ba
    from sfm_tpu_torch.ba.residuals import Observations
    from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
    from sfm_tpu_torch.engine.state import CameraParams, init_batched_state
    from sfm_tpu_torch.parallel import build_batched_step
    size = size or DIST_SIZE
    on_card = torch.device(dev).type == "cuda"
    n, lm, cg = size["ranks"], size["lm"], size["cg"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    pr = pod_problem(torch, dev, size["C"], size["L"], size["kmax"], n)
    one = pod_world_of_one(torch, pr, dev, lm, cg)
    log(f"[dist] pod C={size['C']} L={size['L']} kmax={size['kmax']} "
        f"({size['L'] * size['kmax']} observations), 1 rank under "
        f"{one['backend']}, mesh {one['mesh_shape']}: tables "
        f"{one['table_shape']} in {one['partition_s']:.2f} s; "
        f"{one['ms_per_lm_iter']:.3f} ms per LM iteration ({lm} LM x {cg} "
        f"CG), {one['all_reduce_ms']:.4f} ms per CG all-reduce; cost "
        f"{one['initial_cost']:.6e} -> {one['final_cost']:.6e}, "
        f"{one['accepted']} accepted; launches {one['launches']}")
    cfg = SfMConfig(**(size["cfg"] or FLAGSHIP))
    nf, n_fleet = size["fleet_scans"], size["fleet_ranks"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_world(_dist_rank, n, (tmp, dev, size), f"{tmp}/world_pod",
                    dev)
        world_pod_s = time.perf_counter() - t0
        ranks = []
        for r in range(n):
            with open(f"{tmp}/dist.{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        H, W = cfg.image_size
        frames = np.concatenate(list(rendered_chunks(
            size["fleet_frames"], 2, size["K"], H, W, workers, scene="fleet",
            orbit=FLEET_ORBIT, batch=nf)))
        np.save(f"{tmp}/frames.npy", frames)
        t0 = time.perf_counter()
        spawn_world(_fleet_rank, n_fleet,
                    (tmp, f"{tmp}/frames.npy", dev, size),
                    f"{tmp}/world_fleet", dev)
        world_fleet_s = time.perf_counter() - t0
        fleet = []
        for r in range(n_fleet):
            with open(f"{tmp}/fleet.{r}.pkl", "rb") as f:
                fleet.append(pickle.load(f))
    # the pod on n gloo ranks against one rank
    pods = [r["pod"] for r in ranks]
    for r, p in enumerate(pods):
        log(f"[dist] pod, gloo rank {r} of {n} (map position "
            f"{p['map_rank']}): tables {p['table_shape']} in "
            f"{p['partition_s']:.2f} s; {p['ms_per_lm_iter']:.3f} ms per LM "
            f"iteration, {p['all_reduce_ms']:.4f} ms per CG all-reduce; cost "
            f"{p['initial_cost']:.6e} -> {p['final_cost']:.6e}; launches "
            f"{p['launches']}")
    expect = {k: v * on_card for k, v in (
        ("ba_linearize", 1 + lm), ("schur_apply", lm * (cg + 1)),
        ("schur_gather", lm))}
    drv = float(np.abs(pods[0]["rv"] - one["rv"]).max())
    d_cost = abs(pods[0]["final_cost"] - one["final_cost"]) \
        / one["final_cost"]
    log(f"[dist] pod, {n} ranks against 1: max |rvec| difference "
        f"{drv:.3e}, final cost {d_cost:.3e} relative")
    # the dense solver at FLAGSHIP's width against run_ba
    dense = [r["dense"] for r in ranks]
    p = dense_problem(size["dense_c"], size["dense_l"], size["dense_obs"])
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rv_s, _, X_s, st_s = run_ba(
        t(p["K"]), t(p["rv"]), t(p["tv"]), t(p["X"]),
        Observations(*(t(o) for o in p["obs"])), cam_free=t(p["cam_free"]),
        lm_free=t(p["lm_free"]), iterations=size["dense_lm"], tol=0.0)
    X_d = np.concatenate([d["X"] for d in sorted(
        dense, key=lambda d: d["map_rank"])])
    c_s = float(st_s.final_cost)
    dense_err = dict(rvec=float(np.abs(dense[0]["rv"] - rv_s.cpu().numpy())
                                .max()),
                     xyz=float(np.abs(X_d - X_s.cpu().numpy()).max()),
                     cost=abs(dense[0]["final_cost"] - c_s))
    log(f"[dist] dense C={size['dense_c']} L={size['dense_l']} on {n} gloo "
        f"ranks: {dense[0]['ms_per_lm_iter']:.3f} ms per LM iteration, cost "
        f"{dense[0]['initial_cost']:.6e} -> {dense[0]['final_cost']:.6e}; "
        f"against run_ba: {dense_err}")
    # the sharded fleet against one process per block at the same batch
    Kt = torch.as_tensor(size["K"])
    cam = CameraParams(K=Kt, d=torch.zeros(5), Kopt=Kt)
    nb = nf // n_fleet
    staged = torch.as_tensor(frames, device=dev)
    fleet_equal, fleet_steps_ok = [], []
    for out in fleet:
        b = out["scan_rank"]
        ref, _ = fleet_record(
            torch, build_batched_step(cfg, cam, first_scan=b * nb),
            init_batched_state(cfg, nb, dev), staged[:, b * nb:(b + 1) * nb])
        diff = [k for k in ref if not np.array_equal(ref[k],
                                                     out["record"][k])]
        fleet_equal.append(diff)
        steps = out["steps"]
        fleet_steps_ok.append(
            all(s["k1_tracking"] == 2 * on_card for s in steps
                if s["running"])
            and all(s["k5"] == on_card for s in steps if s["running"] == nb)
            and any(s["running"] == nb for s in steps))
        st = out["record"]["status"]
        log(f"[dist] sharded fleet, rank {b} (scans {b * nb}-"
            f"{(b + 1) * nb - 1}): statuses by frame "
            f"{[''.join(map(str, s)) for s in st.tolist()]}; keyframes "
            f"{out['record']['n_keyframes'][-1].tolist()}; per step (RUNNING "
            f"before, K1 at tracking, K5) "
            f"{[(s['running'], s['k1_tracking'], s['k5']) for s in steps]}; "
            f"{out['secs']:.2f} s; differs from one process in {diff}")
    dry = [r["dryrun"] for r in ranks]
    log(f"[dist] dryrun_multichip({n}): statuses "
        f"{[d['status'] for d in dry]}, dense {dry[0]['dense']}, large "
        f"{dry[0]['large']}, launches {dry[0]['launches']}")
    checks = {
        "the pod cost falls on 1 rank and on every gloo rank":
            one["final_cost"] < one["initial_cost"] and all(
                p["final_cost"] < p["initial_cost"] for p in pods),
        "every gloo rank's pod poses are rank 0's bit for bit": all(
            np.array_equal(p["rv"], pods[0]["rv"])
            and np.array_equal(p["tv"], pods[0]["tv"]) for p in pods),
        f"{n} ranks against 1: rvec within 1e-3, final cost within 1%":
            drv <= 1e-3 and d_cost <= 1e-2,
        "K2 / K3 / K3-gather launched as the loop runs them, on 1 rank and "
        "on every gloo rank": one["launches"] == expect and all(
            p["launches"] == expect for p in pods),
        "the pod's landmarks finite": one["landmarks_finite"] and all(
            p["landmarks_finite"] for p in pods),
        "the dense cost falls": all(d["final_cost"] < d["initial_cost"]
                                    for d in dense),
        "every gloo rank's dense poses are rank 0's bit for bit": all(
            np.array_equal(d["rv"], dense[0]["rv"])
            and np.array_equal(d["tv"], dense[0]["tv"]) for d in dense),
        "the dense solver agrees with run_ba (rvec 1e-4, xyz 1e-3, cost "
        "1e-2 x max(cost, 1))": dense_err["rvec"] <= 1e-4
        and dense_err["xyz"] <= 1e-3
        and dense_err["cost"] <= 1e-2 * max(c_s, 1.0),
        "each rank's block of the fleet equals a fleet of its scans in one "
        "process bit for bit": all(not d for d in fleet_equal),
        "the sharded fleet's scans track": all(
            (out["record"]["status"][-1] == 1).sum() >= nb - 1
            for out in fleet),
        "K1 twice and K5 once per batched tracking step on each rank":
            all(fleet_steps_ok),
        "each rank's block of states stays on the device it was made on "
        "(shard_batched_state's default)": all(
            torch.device(out["state_device"]).type == torch.device(dev).type
            for out in fleet),
        "dryrun_multichip completes on every rank with its costs not "
        "rising": all(np.isfinite(d[k][1]) and d[k][1] <= d[k][0]
                      for d in dry for k in ("dense", "large")),
    }
    run_checks("dist", checks)
    launches = {}
    for counts in ([one["launches"]] + [p["launches"] for p in pods]
                   + [d["launches"] for d in dry]
                   + [out["launches"] for out in fleet]):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    phase_s = time.perf_counter() - t_phase
    log(f"[dist] the phase took {phase_s:.1f} s (the world of {n} spawned "
        f"and done in {world_pod_s:.1f} s, the world of {n_fleet} in "
        f"{world_fleet_s:.1f} s); launches over every rank {launches}")
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("rv", "tv", "X")}
    return dict(
        pod_world_of_one=strip(one), pod_gloo=[strip(p) for p in pods],
        pod_rvec_vs_one=drv, pod_cost_vs_one=d_cost,
        dense=[strip(d) for d in dense], dense_vs_run_ba=dense_err,
        fleet=[dict(scan_rank=out["scan_rank"], secs=out["secs"],
                    steps=out["steps"], launches=out["launches"],
                    statuses=out["record"]["status"].tolist())
               for out in fleet],
        dryrun=dry, launches=launches, seconds=phase_s,
        world_pod_s=world_pod_s, world_fleet_s=world_fleet_s,
        checks={k: bool(v) for k, v in checks.items()},
        keep=dict(pr=pr, launches_rank0=pods[0]["launches"],
                  launches_one=one["launches"], size=size, cfg=cfg,
                  fleet_k1_calls=fleet[0]["k1_calls"],
                  fleet_images=frames[-1, :nb],
                  fleet_k5_launches=sum(s["k5"] for s in fleet[0]["steps"]
                                        if s["running"] == nb)))


def pod_kernel_rows(torch, dev, keep):
    """K2, K3 and K3-gather against their plain versions on shard 0 of the
    pod at each of its shapes with ``ba_kernel_rows``, timed: the world of
    one's whole table (C 5120, L 2^20, kmax 8; its launches the world of
    one's in its timed solve) and a shard of the gloo world (L 262144;
    gloo rank 0's launches), each also per LM iteration.  Returns
    [(name, row)]."""
    from sfm_tpu_torch.ba.large import camera_slots
    from sfm_tpu_torch.geometry.rotations import exp_so3
    from sfm_tpu_torch.parallel import partition_tables
    pr, size = keep["pr"], keep["size"]
    out = []
    for n, what, launches in ((1, "pod world of one", keep["launches_one"]),
                              (size["ranks"], "pod shard",
                               keep["launches_rank0"])):
        tabs, shard = partition_tables(pr["obs"], pr["C"], pr["L"], n,
                                       pr["nmax"][n], pr["kmax"], device=dev)
        lm_cam, lm_uv, lm_w = tabs.lm_cam[0], tabs.lm_uv[0], tabs.lm_w[0]
        del tabs
        cs = camera_slots(lm_cam, lm_w, pr["C"])
        args = (pr["K"], exp_so3(pr["rv"]).contiguous(), pr["tv"],
                pr["X"][:shard].contiguous(),
                pr["lm_free"][:shard].float(), pr["cam_free"].float(),
                lm_cam, lm_uv, lm_w, 0.0)
        label = f"{what} C={pr['C']} L={shard} kmax={pr['kmax']}"
        rows = ba_kernel_rows(torch, label, args, cs, True,
                              names=DIST_KERNELS)
        for name, row in rows.items():
            row["launches"] = launches[name]
            row["launches_per_lm_iteration"] = row["launches"] / size["lm"]
            out.append((name, row))
    return out


def sharded_fleet_rows(torch, dev, keep):
    """K1 and K5 at the sharded fleet's per-rank batch (the scans of one
    rank: 4 x 512 keypoints at FLAGSHIP): K1 replayed on gloo rank 0's own
    calls at the tracking step (``k1_by_site``: each call bit for bit
    against the plain version, timed; launches rank 0's at that site), and
    K5 on the canvases of rank 0's block at the last frame
    (``fleet_k5_row``; launches rank 0's batched ones, one per tracking
    step in which all its scans ran)."""
    calls = [(site, tuple(x.to(dev) if torch.is_tensor(x) else x
                          for x in args))
             for site, args in keep["fleet_k1_calls"]]
    k1 = k1_by_site(torch, calls, "sharded fleet block")
    k5 = fleet_k5_row(torch, keep["cfg"],
                      torch.as_tensor(keep["fleet_images"], device=dev),
                      "sharded fleet block")
    k5["launches"] = keep["fleet_k5_launches"]
    return k1, k5


# the raytrace phase: benchmarks/bench_independent_accuracy.py's workload
# field for field (FLAGSHIP; K; the lens's distortion; RayScene(seed=11,
# n_boxes=24); 60 frames of orbit_arc_trajectory(radius=5.5, arc=0.7) at
# 480x640; sensor noise 2.5; frame_no = the frame's index) and its gates
# (RUNNING over all frames, keyframes, extent, the sim(3) keyframe ATE as
# a share of the extent); then benchmarks/bench_acceptance.py's step on
# the same frames: a y4m through ``cli scan --chunk 10`` as a subprocess,
# and its gates (RUNNING over the metrics lines, the checkpoint's
# keyframes, extent, ATE, the live landmarks within SURFACE_EPS of a
# scene surface, the PLY holding exactly the live landmarks, coloured).
# The frames are rendered once, by RAYTRACE_WORKERS processes.
RAYTRACE_FRAMES = 60
RAYTRACE_DIST = [-0.22, 0.06, 0.0009, -0.0007, 0.0]
RAYTRACE_NOISE = 2.5
RAYTRACE_WORKERS = 7
RAYTRACE_ATE = 0.02
RAYTRACE_RUNNING = 0.9
RAYTRACE_KEYFRAMES = 6
ACCEPTANCE_KEYFRAMES = 5
SURFACE_EPS = 0.15      # m, at ~5.5 m scene depth
SURFACE_GATE = 0.85
# the anchor phase: every port solver on the card against the f64
# reference (sfm_tpu_torch/ba/reference.py) on the host, on
# tests/test_ba_reference.py's two problems (its 4x60 perturbed scene and
# its 10x300 "medium" scene, made as that file makes them) and on one at
# FLAGSHIP's BA width (32 keyframes, 2048 landmarks, each seen by 2 to 8
# consecutive keyframes: kmax 8); the gates are that file's
ANCHOR_COST_RTOL = 0.01
ANCHOR_RVEC_ATOL = 2e-3
ANCHOR_TVEC_ATOL = 5e-3
ANCHOR_REFERENCE_KW = dict(iterations=40, tol=1e-10)
ANCHOR_SOLVERS = ("run_ba", "run_ba_cg", "run_large_ba jacobi_u",
                  "run_large_ba schur_diag")
ANCHOR_KERNELS = ("ba_linearize", "schur_apply", "schur_gather")


def write_y4m(path, frames):
    """Encode grayscale frames as full-resolution C444 YUV4MPEG2
    (benchmarks/bench_acceptance.py's ``write_y4m``)."""
    n, h, w = frames.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C444\n".encode())
        chroma = np.full((h, w), 128, np.uint8).tobytes()
        for i in range(n):
            f.write(b"FRAME\n")
            f.write(np.clip(frames[i], 0, 255).astype(np.uint8).tobytes())
            f.write(chroma)
            f.write(chroma)


def surface_distance(scene, pts):
    """Distance from each point to the nearest rendered scene surface
    (floor plane y=floor_y, or any box face)
    (benchmarks/bench_acceptance.py's ``surface_distance``)."""
    d = np.abs(pts[:, 1] - scene.floor_y)            # floor plane
    for bmin, bmax in zip(scene.bmin, scene.bmax):
        # distance to the box SURFACE: outside -> clamp gap; inside ->
        # distance to the nearest face
        lo = bmin - pts
        hi = pts - bmax
        gap = np.maximum(np.maximum(lo, hi), 0.0)
        outside = np.linalg.norm(gap, axis=1)
        inside = np.minimum(np.min(pts - bmin, 1), np.min(bmax - pts, 1))
        db = np.where(outside > 0, outside, np.abs(np.minimum(inside, 0))
                      + np.maximum(inside, 0))
        d = np.minimum(d, db)
    return d


def keyframe_centres(state, rvecs, tvecs):
    """(estimated, true) camera centres of a state's keyframes in frame
    order, the true ones from the ground-truth poses by frame number, as
    the two benchmarks take them."""
    from sfm_tpu_torch.raytrace import _rot
    kfs = state.kfs
    valid = kfs.valid.cpu().numpy()
    fns = kfs.frames.frame_no.cpu().numpy()[valid]
    order = np.argsort(fns)
    rv = kfs.frames.rvec.cpu().numpy()[valid][order]
    tv = kfs.frames.tvec.cpu().numpy()[valid][order]
    if len(rv) < 3:
        raise AssertionError(f"{len(rv)} keyframes: no trajectory to align")
    est_c = np.stack([-_rot(rv[i]).T @ tv[i] for i in range(len(rv))])
    gt_c = np.stack([-_rot(rvecs[f]).T @ tvecs[f] for f in fns[order]])
    return est_c, gt_c


def run_acceptance(torch, dev, frames, scene, rvecs, tvecs, K=K,
                   cli_args=()):
    """benchmarks/bench_acceptance.py's steps 2 and 3 on ``frames``: the
    y4m written in a temporary directory, ``python -m sfm_tpu_torch.cli
    scan`` on it as a subprocess with that script's command line (on the
    card: the CLI's default device; ``cli_args`` are added, e.g. the
    device of a rehearsal), then its gates on the metrics
    lines, the checkpoint and the PLY.  Returns the numbers and the
    checks."""
    import os
    import shutil

    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.io import load_state, read_ply
    from sfm_tpu_torch.raytrace import sim3_align

    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix="sfm_acceptance_")
    try:
        p = lambda name: os.path.join(d, name)  # noqa: E731
        write_y4m(p("scan.y4m"), frames)
        cmd = [sys.executable, "-m", "sfm_tpu_torch.cli", "scan",
               "--input", p("scan.y4m"), "--output", p("cloud.ply"),
               "--fx", str(float(K[0, 0])), "--fy", str(float(K[1, 1])),
               "--cx", str(float(K[0, 2])), "--cy", str(float(K[1, 2])),
               "--dist"] + [str(x) for x in RAYTRACE_DIST] + [
               "--chunk", "10", "--feature-dtype", "bfloat16",
               "--checkpoint", p("state.npz"), "--metrics", p("metrics.jsonl"),
               *cli_args]
        pp = os.environ.get("PYTHONPATH", "")
        env = dict(os.environ,
                   PYTHONPATH=root + (os.pathsep + pp if pp else ""))
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()     # room for the child on the card
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log(f"[acceptance] cli scan: exit {proc.returncode} in "
            f"{cli_s:.3f} s; its stderr ends: {proc.stderr[-600:].strip()}")
        if proc.returncode != 0:       # the exit code is the first gate
            raise AssertionError(f"cli scan exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        lines = [json.loads(ln) for ln in open(p("metrics.jsonl"))]
        # the configuration the CLI builds: its default capacities at the
        # frames' size
        H, W = frames.shape[1:]
        cfg = SfMConfig(image_height=H, image_width=W,
                        feature_dtype="bfloat16", **CLI_CAPS)
        state = load_state(p("state.npz"), cfg, "cpu")
        xyz_ply, rgb_ply = read_ply(p("cloud.ply"))
    finally:
        shutil.rmtree(d)
    running = float(np.mean([m["status"] == 1 for m in lines]))
    est_c, gt_c = keyframe_centres(state, rvecs, tvecs)
    s, R, t = sim3_align(est_c, gt_c)
    resid = gt_c - ((s * (R @ est_c.T)).T + t)
    ate = float(np.sqrt((resid ** 2).sum(1).mean()))
    extent = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    lms_valid = state.lms.valid.numpy()
    lm_gt = (s * (R @ state.lms.xyz.numpy()[lms_valid].T)).T + t
    on_surface = float((surface_distance(scene, lm_gt) < SURFACE_EPS).mean())
    n_lms = int(lms_valid.sum())
    log(f"[acceptance] RUNNING {running:.1%} of {len(lines)} metrics lines; "
        f"{len(est_c)} keyframes; {n_lms} landmarks; ATE {ate:.5f} over "
        f"{extent:.3f} m ({100 * ate / extent:.3f}%); cloud on a surface "
        f"{on_surface:.1%} (eps {SURFACE_EPS} m); PLY {len(xyz_ply)} points, "
        f"coloured {rgb_ply is not None}; {len(frames) / cli_s:.3f} frames/s "
        f"for the whole command")
    checks = {
        "RUNNING >= 90% of the metrics lines": running >= RAYTRACE_RUNNING,
        f"keyframes >= {ACCEPTANCE_KEYFRAMES}":
        len(est_c) >= ACCEPTANCE_KEYFRAMES,
        "extent > 1 m": extent > 1.0,
        "sim(3) ATE <= 2% of extent": ate <= RAYTRACE_ATE * extent,
        f">= 85% of the live landmarks within {SURFACE_EPS} m of a surface":
        on_surface >= SURFACE_GATE,
        "the PLY holds exactly the live landmarks, coloured":
        len(xyz_ply) == n_lms > 0 and rgb_ply is not None,
    }
    return dict(cli_s=cli_s, running=running, keyframes=len(est_c),
                landmarks=n_lms, ate_pct=100 * ate / extent, extent=extent,
                on_surface=on_surface, ply_points=len(xyz_ply)), checks


def raytrace_frames(K, H, W, n_frames=RAYTRACE_FRAMES,
                    workers=RAYTRACE_WORKERS):
    """The raytrace phase's frames [n_frames, H, W] float32, one frame a
    task on ``workers`` processes, and the seconds they took."""
    t0 = time.perf_counter()
    frames = np.concatenate(list(rendered_chunks(
        n_frames, 1, K, H, W, workers, scene="raytrace")))
    render_s = time.perf_counter() - t0
    log(f"[raytrace] rendered {n_frames} frames of {H}x{W} in "
        f"{render_s:.3f} s by {workers} processes")
    return frames, render_s


def run_raytrace(torch, dev, cfg, kernels=MAIN_PATH, K=K,
                 n_frames=RAYTRACE_FRAMES, workers=RAYTRACE_WORKERS,
                 acceptance=True, cli_args=(), frames=None):
    """benchmarks/bench_independent_accuracy.py's run on the card: the
    ray-traced frames (``raytrace_frames``, unless given), fed to
    ``SfMEngine(K, (H, W), dist, cfg)`` through add_frames in chunks of
    keyframe_time_lag (the remainder dropped, as the script drops it);
    its gates, the lens model in use (Kopt != K) and every counter in
    ``kernels`` launched by the scan.  With ``acceptance``, then
    ``run_acceptance`` on the same frames.  Any failed gate raises."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.engine import SfMEngine
    from sfm_tpu_torch.raytrace import sim3_ate

    H, W = cfg.image_size
    scene, rvecs, tvecs = scan_scene("raytrace", n_frames)
    render_s = None
    if frames is None:
        frames, render_s = raytrace_frames(K, H, W, n_frames, workers)
    T = cfg.keyframe_time_lag
    eng = SfMEngine(K, (H, W), RAYTRACE_DIST, cfg, device=dev, seed=0)
    staged = [torch.as_tensor(frames[s:s + T], device=dev)
              for s in range(0, n_frames - n_frames % T, T)]
    sync(torch, dev)
    native.reset_launch_counts()
    metrics, first_s, rest_s, infinite, walked = feed_chunks(
        torch, dev, eng, staged, "raytrace")
    scan_s = first_s + rest_s
    launches = dict(native.LAUNCHES)
    status = np.array([int(m["status"]) for m in metrics])
    running = float((status == 1).mean())
    est_c, gt_c = keyframe_centres(eng.state, rvecs, tvecs)
    ate = sim3_ate(est_c, gt_c)
    extent = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    n_lms = int(eng.state.lms.valid.sum())
    kopt = eng.cam.Kopt.cpu().numpy()
    fps = (len(metrics) - T) / (scan_s - first_s) if len(staged) > 1 \
        else float("nan")
    log(f"[raytrace] RUNNING {running:.1%} of {len(metrics)} frames; "
        f"{len(est_c)} keyframes; {n_lms} landmarks; ATE {ate:.5f} over "
        f"{extent:.3f} m ({100 * ate / extent:.3f}%); Kopt fx {kopt[0, 0]:.3f} "
        f"cx {kopt[0, 2]:.3f} (K: {K[0, 0]}, {K[0, 2]}); first chunk "
        f"{first_s:.3f} s, then {fps:.3f} frames/s; launches {launches}; "
        f"no NaN in the state or the metrics after any of the {walked} "
        f"chunks")
    checks = {
        "RUNNING >= 90%": running >= RAYTRACE_RUNNING,
        f"keyframes >= {RAYTRACE_KEYFRAMES}": len(est_c) >= RAYTRACE_KEYFRAMES,
        "extent > 1 m": extent > 1.0,
        "sim(3) keyframe ATE <= 2% of extent": ate <= RAYTRACE_ATE * extent,
        "the lens model is in use (Kopt != K)": not np.array_equal(kopt, K),
        "landmarks finite": n_lms > 0 and bool(torch.isfinite(
            eng.state.lms.xyz[eng.state.lms.valid]).all()),
    }
    for name in kernels:
        checks[f"{name} launched by the scan"] = launches[name] > 0
    run_checks("raytrace", checks)
    out = dict(render_s=render_s, first_chunk_s=first_s, scan_s=scan_s,
               fps=fps, running=running, keyframes=len(est_c),
               landmarks=n_lms, ate_pct=100 * ate / extent, extent=extent,
               launches=launches, nan_free_chunks=walked,
               infinite_fields=infinite)
    if acceptance:
        out["acceptance"], checks = run_acceptance(
            torch, dev, frames, scene, rvecs, tvecs, K, cli_args)
        run_checks("acceptance", checks)
    return out


def anchor_small(rng, n_cams=4, n_pts=60, noise_px=0.5):
    """tests/test_ba_reference.py's ``_perturbed_scene`` (the scene of
    tests/test_ba.py's ``make_ba_scene``, perturbed), made as those make
    it, in numpy: every camera sees every landmark, camera 0 frozen at its
    true pose."""
    from sfm_tpu_torch.np_geometry import DEFAULT_K, project_np, rodrigues_np
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(5, 9, n_pts)], axis=1).astype(np.float32)
    rvecs, tvecs, uvs = [], [], []
    for c in range(n_cams):
        rv = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        tv = np.array([0.4 * c, 0.0, 0.0], np.float32) + \
            rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        uv = project_np(DEFAULT_K, rodrigues_np(rv), tv, X).astype(np.float32)
        uv += rng.normal(0, noise_px, uv.shape).astype(np.float32)
        rvecs.append(rv)
        tvecs.append(tv)
        uvs.append(uv)
    rvec, tvec = np.stack(rvecs), np.stack(tvecs)
    obs = (np.repeat(np.arange(n_cams), n_pts).astype(np.int32),
           np.tile(np.arange(n_pts), n_cams).astype(np.int32),
           np.concatenate(uvs).astype(np.float32),
           np.ones(n_cams * n_pts, np.float32))
    rv0 = rvec + rng.normal(0, 0.01, rvec.shape)
    tv0 = tvec + rng.normal(0, 0.01, tvec.shape)
    X0 = X + rng.normal(0, 0.03, X.shape)
    rv0[0], tv0[0] = rvec[0], tvec[0]          # gauge anchor
    cam_free = np.ones(n_cams, bool)
    cam_free[0] = False
    return dict(K=DEFAULT_K, rv=rv0.astype(np.float32),
                tv=tv0.astype(np.float32), X=X0.astype(np.float32), obs=obs,
                cam_free=cam_free, lm_free=np.ones(n_pts, bool), nmax=64,
                kmax=4, cg=40)


def anchor_medium(rng, n_cams=10, n_pts=300, per_cam=120):
    """tests/test_ba_reference.py's ``test_medium_scale_parity`` problem,
    made as that test makes it: 10 cameras each seeing 120 of 300
    landmarks, 0.5 px noise, camera 0 frozen.  The reference starts from
    the float64 start point, the solvers from its float32 copy, as
    there."""
    from sfm_tpu_torch.np_geometry import DEFAULT_K, project_np, rodrigues_np
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(6, 12, n_pts)], 1)
    ci, li, uvs, rvs, tvs = [], [], [], [], []
    for c in range(n_cams):
        rv = rng.uniform(-0.03, 0.03, 3)
        tv = np.array([0.2 * c, 0, 0])
        rvs.append(rv)
        tvs.append(tv)
        sel = rng.choice(n_pts, per_cam, replace=False)
        uv = project_np(DEFAULT_K, rodrigues_np(rv), tv, X[sel])
        uv = uv + rng.normal(0, 0.5, uv.shape)
        ci.append(np.full(per_cam, c))
        li.append(sel)
        uvs.append(uv)
    obs = (np.concatenate(ci).astype(np.int32),
           np.concatenate(li).astype(np.int32),
           np.concatenate(uvs).astype(np.float32),
           np.ones(n_cams * per_cam, np.float32))
    rv0 = np.stack(rvs) + rng.normal(0, 0.005, (n_cams, 3))
    tv0 = np.stack(tvs) + rng.normal(0, 0.005, (n_cams, 3))
    X0 = X + rng.normal(0, 0.02, X.shape)
    rv0[0], tv0[0] = rvs[0], tvs[0]
    cam_free = np.ones(n_cams, bool)
    cam_free[0] = False
    return dict(K=DEFAULT_K, rv=rv0, tv=tv0, X=X0, obs=obs,
                cam_free=cam_free, lm_free=np.ones(n_pts, bool), nmax=256,
                kmax=16, cg=50)


def anchor_wide(rng, n_cams=32, n_pts=2048, kmax=8, noise_px=0.5):
    """A problem at FLAGSHIP's BA width: 32 cameras strafing 0.1 apart,
    2048 landmarks each seen by 2 to ``kmax`` consecutive cameras, 0.5 px
    noise, the medium problem's perturbations.  Cameras 0 and 1 are
    frozen at their true poses: the first fixes the pose gauge, the second
    the scale (which no other term fixes, and on which the f32 solvers
    and the reference could otherwise settle apart).  The CG solvers run
    100 CG iterations a step: the chain of 30 free cameras is weakly
    held along its length, and at the 4x60 scene's 40 or the medium
    one's 50 the inner solve stops short there (on the CPU: final costs
    within 4e-6 of the reference's, tvecs 1.1e-2 to 1.4e-2 from it; at
    100, within 2.5e-3)."""
    from sfm_tpu_torch.np_geometry import DEFAULT_K, project_np, rodrigues_np
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(6, 12, n_pts)], 1)
    rvs = rng.uniform(-0.03, 0.03, (n_cams, 3))
    tvs = np.stack([0.1 * np.arange(n_cams), np.zeros(n_cams),
                    np.zeros(n_cams)], 1)
    n = rng.integers(2, kmax + 1, n_pts)
    first = rng.integers(0, n_cams - n + 1)
    li = np.repeat(np.arange(n_pts), n)
    ci = np.concatenate([f + np.arange(k) for f, k in zip(first, n)])
    uv = np.empty((len(ci), 2))
    for c in range(n_cams):
        on = ci == c
        uv[on] = project_np(DEFAULT_K, rodrigues_np(rvs[c]), tvs[c],
                            X[li[on]])
    uv = uv + rng.normal(0, noise_px, uv.shape)
    obs = (ci.astype(np.int32), li.astype(np.int32), uv.astype(np.float32),
           np.ones(len(ci), np.float32))
    rv0 = rvs + rng.normal(0, 0.005, rvs.shape)
    tv0 = tvs + rng.normal(0, 0.005, tvs.shape)
    X0 = X + rng.normal(0, 0.02, X.shape)
    rv0[:2], tv0[:2] = rvs[:2], tvs[:2]
    cam_free = np.ones(n_cams, bool)
    cam_free[:2] = False
    return dict(K=DEFAULT_K, rv=rv0, tv=tv0, X=X0, obs=obs,
                cam_free=cam_free, lm_free=np.ones(n_pts, bool),
                nmax=n_pts, kmax=kmax, cg=100)


def anchor_problems(wide=(32, 2048, 8)):
    """The anchor phase's problems by name, each from its own
    default_rng(0) (as each of the test's cases gets a fresh one);
    ``wide`` = (cameras, landmarks, kmax) of the third."""
    return {"4x60": anchor_small(np.random.default_rng(0)),
            "10x300 medium": anchor_medium(np.random.default_rng(0)),
            f"{wide[0]}x{wide[1]} kmax {wide[2]}": anchor_wide(
                np.random.default_rng(0), *wide)}


def anchor_references(problems):
    """The f64 reference's solution of each problem (rvec, tvec, xyz, the
    accepted costs) and its host seconds."""
    from sfm_tpu_torch.ba.reference import reference_ba
    out = {}
    for name, p in problems.items():
        t0 = time.perf_counter()
        ref = reference_ba(p["K"], p["rv"], p["tv"], p["X"], *p["obs"],
                           cam_free=p["cam_free"], lm_free=p["lm_free"],
                           **ANCHOR_REFERENCE_KW)
        out[name] = (ref, time.perf_counter() - t0)
    return out


def anchor_solve(torch, dev, p, solver):
    """One port solver on problem ``p`` on ``dev``, with the test's
    settings (30 LM iterations, tol 1e-8, the problem's CG iterations):
    (rvec, tvec, final cost, seconds)."""
    from sfm_tpu_torch.ba import run_ba, run_ba_cg
    from sfm_tpu_torch.ba.large import build_tables, run_large_ba
    from sfm_tpu_torch.ba.residuals import Observations
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev)
    ci, li, uv, w = p["obs"]
    obs = Observations(t(ci, torch.int64), t(li, torch.int64), t(uv), t(w))
    args = (t(p["K"]), t(p["rv"]), t(p["tv"]), t(p["X"]))
    kw = dict(cam_free=t(p["cam_free"], torch.bool),
              lm_free=t(p["lm_free"], torch.bool), iterations=30, tol=1e-8)
    sync(torch, dev)
    t0 = time.perf_counter()
    if solver == "run_ba":
        rv, tv, _, st = run_ba(*args, obs, **kw)
    elif solver == "run_ba_cg":
        rv, tv, _, st = run_ba_cg(*args, obs, cg_iterations=p["cg"], **kw)
    else:
        tables = build_tables(Observations(*(x.cpu() for x in obs)),
                              len(p["rv"]), len(p["X"]), p["nmax"],
                              p["kmax"])
        tables = type(tables)(*(x.to(dev) for x in tables))
        rv, tv, _, st = run_large_ba(*args, tables, cg_iterations=p["cg"],
                                     precond=solver.split()[1], **kw)
    cost = float(st.final_cost)
    return (rv.cpu().numpy(), tv.cpu().numpy(), cost,
            time.perf_counter() - t0)


def run_anchor(torch, dev, bench_once=None, problems=None, references=None,
               bench_iterations=8, kernels=ANCHOR_KERNELS):
    """Every port solver on ``dev`` against the f64 reference on each of
    ``problems`` (``anchor_problems()`` by default; ``references``, a
    function returning ``anchor_references(problems)``, e.g. a future's
    result, or computed here): final cost within 1% of the reference's,
    the free rvecs within 2e-3 and tvecs within 5e-3; every counter in
    ``kernels`` launched.  Then, with ``bench_once`` (``run_bench_ba``'s
    run), bench_ba's problem under precond="jacobi_u", "schur_diag"
    twice, "jacobi_u" again: schur_diag's cost must fall, and each
    preconditioner's rerun repeat bit for bit; host ms per LM iteration
    and the final costs are printed, with no speed gate."""
    from sfm_tpu_torch import native
    problems = problems or anchor_problems()
    native.reset_launch_counts()
    solved, checks = {}, {}
    for name, p in problems.items():
        for solver in ANCHOR_SOLVERS:
            solved[name, solver] = anchor_solve(torch, dev, p, solver)
    bench = {}
    if bench_once is not None:
        # in turns (jacobi_u, schur_diag, schur_diag, jacobi_u): the host
        # clock spreads between runs, and each pair's mean cancels a drift
        for label, precond in (("jacobi_u", "jacobi_u"),
                               ("schur_diag", "schur_diag"),
                               ("schur_diag rerun", "schur_diag"),
                               ("jacobi_u rerun", "jacobi_u")):
            sync(torch, dev)
            t0 = time.perf_counter()
            rv, tv, X, st = bench_once(precond=precond)
            sync(torch, dev)
            bench[label] = dict(
                ms_per_lm_iter=1e3 * (time.perf_counter() - t0)
                / bench_iterations, initial_cost=float(st.initial_cost),
                final_cost=float(st.final_cost), accepted=int(st.accepted),
                out=(rv, tv, X))
            log(f"[anchor] bench_ba's problem, precond={precond}: "
                f"{bench[label]['ms_per_lm_iter']:.3f} ms per LM iteration "
                f"(host clock, {bench_iterations} LM x 25 CG), cost "
                f"{bench[label]['initial_cost']:.6e} -> "
                f"{bench[label]['final_cost']:.6e}, "
                f"{bench[label]['accepted']} accepted")
        sd = bench["schur_diag"]
        checks["schur_diag at bench_ba: the cost falls"] = bool(
            np.isfinite(sd["final_cost"])
            and sd["final_cost"] < sd["initial_cost"])
        for pc in ("schur_diag", "jacobi_u"):
            a, b = bench[pc], bench[f"{pc} rerun"]
            checks[f"{pc} at bench_ba: a rerun repeats bit for bit"] = all(
                torch.equal(x, y) for x, y in zip(a["out"], b["out"])) \
                and a["final_cost"] == b["final_cost"]
        for b in bench.values():
            b.pop("out")
        log("[anchor] bench_ba's problem: schur_diag "
            f"{(sd['ms_per_lm_iter'] + bench['schur_diag rerun']['ms_per_lm_iter']) / 2:.3f}"
            " ms per LM iteration beside jacobi_u "
            f"{(bench['jacobi_u']['ms_per_lm_iter'] + bench['jacobi_u rerun']['ms_per_lm_iter']) / 2:.3f}"
            " (means of two, in turns; host clock)")
    launches = dict(native.LAUNCHES)
    t0 = time.perf_counter()
    refs = references() if references is not None \
        else anchor_references(problems)
    wait_s = time.perf_counter() - t0
    rows = {}
    for (name, solver), (rv, tv, cost, secs) in solved.items():
        (rv_ref, tv_ref, _, costs), ref_s = refs[name]
        free = problems[name]["cam_free"]
        rel = abs(cost - costs[-1]) / costs[-1]
        drv = float(np.abs(rv - rv_ref)[free].max())
        dtv = float(np.abs(tv - tv_ref)[free].max())
        rows[f"{name} {solver}"] = dict(
            cost=cost, reference_cost=costs[-1], cost_rel=rel, rvec=drv,
            tvec=dtv, seconds=secs, reference_seconds=ref_s)
        log(f"[anchor] {name}, {solver}: final cost {cost:.6e} against the "
            f"f64 reference's {costs[-1]:.6e} ({rel:.3e} relative); free "
            f"rvec {drv:.3e}, tvec {dtv:.3e} from it; {secs:.3f} s (the "
            f"reference {ref_s:.3f} s on the host, {len(costs) - 1} "
            f"accepted)")
        checks[f"{name} {solver}: cost within 1%, rvec 2e-3, tvec 5e-3"] = (
            rel <= ANCHOR_COST_RTOL and drv <= ANCHOR_RVEC_ATOL
            and dtv <= ANCHOR_TVEC_ATOL)
    for name in kernels:
        checks[f"{name} launched"] = launches.get(name, 0) > 0
    log(f"[anchor] launches {launches}; waited {wait_s:.3f} s for the f64 "
        f"references")
    run_checks("anchor", checks)
    return dict(rows=rows, bench_ba=bench, launches=launches,
                reference_wait_s=wait_s)


def raytrace_and_anchor(torch, dev, bench_once=None):
    """The raytrace phase (with its acceptance step), then the anchor
    phase, whose f64 references run on the host in a process of their own
    meanwhile; without ``bench_once``, ``run_bench_ba`` builds bench_ba's
    problem first.  Returns both phases' outputs."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
    if bench_once is None:
        _, bench_once = run_bench_ba(torch, dev)
    problems = anchor_problems()
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        references = pool.submit(anchor_references, problems)
        raytrace = run_raytrace(torch, dev, SfMConfig(**FLAGSHIP))
        anchor = run_anchor(torch, dev, bench_once, problems,
                            references.result)
    return raytrace, anchor


# ---------------------------------------------------------------------------
# "sanitize": every __global__ function of csrc/ at the main path's shapes
# and at edge shapes, against its plain version inside guard bands; and
# compute-sanitizer over the same driver where the card allows it
# ---------------------------------------------------------------------------

# the __global__ functions of sfm_tpu_torch/csrc/ (schur.cu's two are
# templates over its three modes)
SANITIZE_FUNCTIONS = ("match.cu dense_kernel", "match.cu cells_kernel",
                      "match.cu init_keys", "match.cu epilogue_kernel",
                      "patches.cu patch_kernel",
                      "linearize.cu landmark_phase",
                      "linearize.cu camera_phase",
                      "schur.cu landmark_phase", "schur.cu camera_phase",
                      "cull.cu cull_keyframes_kernel",
                      "pose.cu pose_refine_kernel")
# compute-sanitizer's tools, and its kernel filter: the port's functions
# only (their mangled names hold these), none of PyTorch's
SANITIZER_TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
SANITIZER_FILTER = ("regex=dense_kernel|cells_kernel|init_keys|"
                    "epilogue_kernel|patch_kernel|landmark_phase|"
                    "camera_phase|cull_keyframes_kernel|"
                    "pose_refine_kernel")
SANITIZER_TIMEOUT = 600.0
# bytes of poison on each side of every tensor a guarded call reads or
# the wrappers allocate, and the two poisons (0xFF: NaN in f32, -1 in
# int32; 0x7F: 3.4e38 in f32, a camera index far out of range)
GUARD_BYTES = 4096
POISONS = (0xFF, 0x7F)
K1_FUNCTION = {"cells": "match.cu cells_kernel",
               "dense_int": "match.cu dense_kernel"}


class _Bands:
    """Guard bands for one guarded call: every tensor is the middle of a
    buffer whose GUARD_BYTES on each side hold ``poison`` (and whose
    middle does too, until written)."""

    def __init__(self, torch, poison):
        self.torch, self.poison, self.bufs = torch, poison, []
        self.real_empty = torch.empty

    def alloc(self, n, dtype, device):
        torch = self.torch
        es = torch.empty((), dtype=dtype).element_size()
        pad = GUARD_BYTES // es
        buf = self.real_empty((n + 2 * pad,), dtype=dtype, device=device)
        buf.view(torch.uint8).fill_(self.poison)
        self.bufs.append((buf, pad, n))
        return buf[pad:pad + n]

    def copy(self, t):
        """``t`` copied into a band (an expanded batch axis stays
        expanded)."""
        if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
            return self.copy(t[:1]).expand(t.shape)
        return self.alloc(t.numel(), t.dtype, t.device).view(
            t.shape).copy_(t)

    def empty(self, *size, dtype=None, device=None, **kw):
        """``torch.empty`` with a device named, in a band (the wrappers
        allocate their outputs and scratch so); else the real one."""
        torch = self.torch
        if device is None or kw:
            return self.real_empty(*size, dtype=dtype, device=device, **kw)
        shape = tuple(size[0]) if len(size) == 1 \
            and not isinstance(size[0], int) else size
        return self.alloc(int(np.prod(shape, dtype=np.int64)),
                          dtype or torch.get_default_dtype(),
                          device).view(shape)

    def broken(self):
        """The bands whose poison a launch overwrote."""
        bad = []
        for i, (buf, pad, n) in enumerate(self.bufs):
            u8 = buf.view(self.torch.uint8)
            es = buf.element_size()
            for side, part in (("before", u8[:pad * es]),
                               ("after", u8[(pad + n) * es:])):
                if bool((part != self.poison).any()):
                    bad.append(f"buffer {i} ({n} x {buf.dtype}) {side}")
        return bad


def _guard_tree(bands, x):
    torch = bands.torch
    if torch.is_tensor(x):
        return bands.copy(x)
    if isinstance(x, tuple):
        out = [_guard_tree(bands, v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    return x


def same_bits(torch, a, b):
    """a equals b entry by entry, NaN where b has NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def guarded_run(torch, fn, inputs, poison):
    """``fn(*inputs)`` with every tensor of ``inputs`` copied into a guard
    band of ``poison`` and every ``torch.empty`` given a device (the
    wrappers' outputs and scratch) made the same way and filled with it.
    Raises if a launch wrote a band's poison or an input; returns the
    outputs, copied out of their bands."""
    bands = _Bands(torch, poison)
    guarded = _guard_tree(bands, tuple(inputs))
    torch.empty = bands.empty
    try:
        out = fn(*guarded)
    finally:
        torch.empty = bands.real_empty
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    bad = bands.broken()
    bad += [f"input {i}" for i, (a, b) in enumerate(zip(guarded, inputs))
            if torch.is_tensor(a) and not same_bits(torch, a, b)]
    if bad:
        raise AssertionError(f"written outside the outputs: {bad}")
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o.clone() for o in out)


def _sub(label, inputs, kernel, plain, functions, exact):
    return dict(label=label, inputs=inputs, kernel=kernel, plain=plain,
                functions=functions, exact=exact)


def _k1_sub(torch, label, args):
    from sfm_tpu_torch.features import match_pallas as mp
    B, Ns = args[0].shape[:2]
    route = mp.k1_route(args[7], B, Ns, args[3].shape[1])
    return [_sub(
        f"K1 {label} [{route}]", args,
        lambda *a: mp.hamming_match_kernel(*a) + mp.match_result_kernel(*a),
        lambda *a: mp.hamming_match_plain(*a) + mp.match_result_plain(*a),
        (K1_FUNCTION[route], "match.cu init_keys", "match.cu epilogue_kernel"),
        True)]


def k1_main_case(case):
    def build(torch, dev):
        args, _ = k1_inputs(torch, np.random.default_rng(5), case, dev)
        return _k1_sub(torch, case[0], args)
    return build


def k1_edge_case(B, Ns, Nt, rmax, src_live=0.95, tgt_live=0.95,
                 expand=False, wild=False, seed=7):
    """K1 at an edge shape: every source (target) valid with probability
    src_live (tgt_live); ``expand``: the targets' descriptors one row
    expanded over the batch (stride 0); ``wild``: three sources centred
    far outside any image, on NaN and on inf."""
    def build(torch, dev):
        g = np.random.default_rng(seed)
        a = list(match_case(torch, g, B, Ns, Nt, True, dev))
        a[2] = torch.as_tensor(g.uniform(0, 1, (B, Ns)) < src_live,
                               device=dev)
        a[5] = torch.as_tensor(g.uniform(0, 1, (B, Nt)) < tgt_live,
                               device=dev)
        if expand:
            a[3] = a[3][:1].expand(B, -1, -1)
        if wild:
            far = torch.tensor([[3e9, -3e9], [float("nan"), 5.0],
                                [float("inf"), 5.0]], device=dev)
            a[1][:, :3] = far
            a[2][:, :3] = True
        r2 = float(np.float32(rmax * rmax))
        label = (f"{B}x{Ns}x{Nt} r{rmax:g}"
                 + (" expanded" if expand else "") + (" wild" if wild else "")
                 + (f" src {src_live:g}" if src_live < 0.95 else "")
                 + (f" tgt {tgt_live:g}" if tgt_live < 0.95 else ""))
        return _k1_sub(torch, label, tuple(a) + (0.0, r2, 90.0, 0.8))
    return build


def _k5_sub(label, canvas, cx, cy):
    from sfm_tpu_torch.features import patches_pallas as pp
    return [_sub(f"K5 {label}", (canvas, cx, cy),
                 pp.extract_patches_kernel, pp.extract_patches_plain,
                 ("patches.cu patch_kernel",), True)]


def k5_main(torch, dev):
    canvas, cx, cy = k5_inputs(torch, dev)
    return _k5_sub(f"{len(cx)} kp on {canvas.shape[0]}x{canvas.shape[1]}",
                   canvas, cx, cy)


def k5_batch(torch, dev, B=4, N=512, Hc=480, Wc=1200):
    g = np.random.default_rng(8)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    return _k5_sub(f"batch {B} x {N} kp on {Hc}x{Wc}",
                   t(g.uniform(0, 255, (B, Hc, Wc))),
                   t(g.uniform(20, Wc - 20, (B, N))),
                   t(g.uniform(20, Hc - 20, (B, N))))


def k5_borders(torch, dev, Hc=480, Wc=1200):
    """Centres on a grid within 16 px of every border, on it, and past it
    (the engine's centres are finite: detection's integer pixels plus a
    clamped subpixel step, so no non-finite case)."""
    g = np.random.default_rng(9)
    xs = np.array([-40, -16.5, -0.5, 0.0, 0.3, 15.7, 16.0, Wc / 2 + 0.25,
                   Wc - 16.2, Wc - 1.0, Wc - 0.4, Wc + 0.5, Wc + 40])
    ys = np.array([-40, -16.5, -0.5, 0.0, 0.3, 15.7, 16.0, Hc / 2 + 0.75,
                   Hc - 16.2, Hc - 1.0, Hc - 0.4, Hc + 0.5, Hc + 40])
    cx, cy = np.meshgrid(xs, ys)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    return _k5_sub(f"{cx.size} centres at the borders of {Hc}x{Wc}",
                   t(g.uniform(0, 255, (Hc, Wc))), t(cx.ravel()),
                   t(cy.ravel()))


def _ba_subs(torch, label, args, cs):
    """K2 on ``args`` (K2's arguments) and ``cs`` (their camera_slots);
    then K3 on the plain K2's W, V (damped at 1e-3) and g_lm with a random
    x, in every mode and with g or x left out, as the large solver calls
    it."""
    from sfm_tpu_torch.ba import linearize_pallas as lp
    from sfm_tpu_torch.ba import schur_pallas as sp
    C, L = args[1].shape[0], args[3].shape[0]
    lm_cam = args[6]
    W, V, g_lm = lp.ba_linearize_plain(*args)[:3]
    Vinv = lp.damped_vinv(V, 1e-3)
    x = torch.as_tensor(np.random.default_rng(1).normal(0, 1, (C, 6)),
                        dtype=torch.float32, device=W.device)
    z = sp.schur_gather_plain(lm_cam, W, Vinv, g_lm, x)
    k2 = ("linearize.cu landmark_phase",) * (L > 0) \
        + ("linearize.cu camera_phase",)
    k3 = ("schur.cu landmark_phase",) * (L > 0)
    both = k3 + ("schur.cu camera_phase",)
    full = lambda g, x: (  # noqa: E731
        lambda lc, W, Vi, *a: sp.schur_kernel(
            "full", lc, W, Vi, a[0] if g else None, a[-2] if x else None,
            n_cams=C, slots=a[-1]),
        lambda lc, W, Vi, *a: sp.schur_apply_fused_plain(
            lc, W, Vi, a[0] if g else None, a[-2] if x else None, C))
    return [
        _sub(f"K2 {label}", tuple(args) + (cs,),
             lambda *a: lp.ba_linearize_kernel(*a[:-1], slots=a[-1]),
             lambda *a: lp.ba_linearize_plain(*a[:-1]), k2, False),
        _sub(f"K3 full {label}", (lm_cam, W, Vinv, g_lm, x, cs),
             *full(True, True), both, False),
        _sub(f"K3 full, x None {label}", (lm_cam, W, Vinv, g_lm, None, cs),
             *full(True, False), both, False),
        _sub(f"K3 full, g None {label}", (lm_cam, W, Vinv, None, x, cs),
             *full(False, True), both, False),
        _sub(f"K3 gather {label}", (lm_cam, W, Vinv, g_lm, x),
             lambda *a: sp.schur_kernel("gather", *a),
             sp.schur_gather_plain, k3, False),
        _sub(f"K3 scatter {label}", (lm_cam, W, z, cs),
             lambda lc, W, z, s: sp.schur_kernel("scatter", lc, W, z=z,
                                                 n_cams=C, slots=s),
             lambda lc, W, z, s: sp.schur_scatter_plain(lc, W, z, C),
             both, False)]


def ba_main_case(C, L, kmax):
    """K2 / K3 on ba_problem at a main-path BA shape (the flagship's
    mapping BA, the long scan's), as check_ba_kernels makes it."""
    def build(torch, dev):
        pr = ba_problem(torch, dev, C, L, kmax, min_obs=2, noise_px=1.0,
                        outlier_p=0.05, spread=0.2, live=0.2)
        return _ba_subs(torch, f"C={C} L={L} kmax={kmax}",
                        *ba_kernel_args(torch, pr, 2.0, True))
    return build


def ba_edge_case(C, L, kmax, seed=3):
    """K2 / K3 on a random table at an edge shape: every 10th landmark row
    empty, 5% of the other slots empty, 4% of the slots with camera index
    -1 and 4% with C + 3 (live: kernels and plain versions clamp them),
    5% outliers, camera 0 and every 7th landmark frozen."""
    def build(torch, dev):
        from sfm_tpu_torch.ba.large import camera_slots
        from sfm_tpu_torch.geometry.rotations import exp_so3
        g = np.random.default_rng(seed)
        cam_t = np.stack([np.linspace(-1, 1, C), np.zeros(C), np.zeros(C)],
                         1)
        X = np.stack([g.uniform(-2, 2, L), g.uniform(-1, 1, L),
                      g.uniform(4, 8, L)], 1)
        lm_cam = g.integers(0, C, (L, kmax))
        u = g.uniform(0, 1, (L, kmax))
        lm_cam[u < 0.04] = -1
        lm_cam[(u >= 0.04) & (u < 0.08)] = C + 3
        w = g.uniform(0.5, 1.5, (L, kmax)) * (g.uniform(0, 1, (L, kmax))
                                              >= 0.05)
        w[::10] = 0.0
        p = X[:, None, :] + cam_t[np.clip(lm_cam, 0, C - 1)]
        uv = p[..., :2] / p[..., 2:] * 250.0 + [160.0, 120.0] \
            + g.normal(0, 1.0, (L, kmax, 2))
        uv[g.uniform(0, 1, (L, kmax)) < 0.05] += 30.0
        cam_free = np.ones(C, np.float32)
        cam_free[0] = 0.0
        lm_free = np.ones(L, np.float32)
        lm_free[::7] = 0.0
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                      device=dev)
        lc = torch.as_tensor(lm_cam, dtype=torch.int32, device=dev)
        args = (f(K), exp_so3(f(g.normal(0, 0.02, (C, 3)))).contiguous(),
                f(cam_t), f(X), f(lm_free), f(cam_free), lc, f(uv), f(w), 2.0)
        return _ba_subs(torch, f"C={C} L={L} kmax={kmax} edge", args,
                        camera_slots(lc, args[8], C))
    return build


def cull_store(K, N, L, *, seed=0, tie=None, live=0.75):
    """A keyframe store for the cull walk, in numpy: (links [K, N] int32,
    kp_valid [K, N], valid [K], frame_no [K] int32), with a share 1 - live
    of the slots invalid and interleaved, and the slots in shuffled frame
    order.  ``tie`` None: a sweep, each keyframe linking 50-95% of its
    keypoints to distinct landmarks of a stretch twice as wide, the
    stretches ~12 views deep, and 2% of its links repeated within it; so the
    early ranks are redundant and the culls thin the views for the later
    ones.  ``tie`` (n_red, n_obs): every valid keyframe links n_red
    landmarks that all share and n_obs - n_red of its own (and a few
    shared ones on invalid keypoints), so that each rank's fraction is
    n_red / n_obs exactly until the shared views run down."""
    g = np.random.default_rng(seed)
    valid = g.uniform(0, 1, K) < live
    frame_no = g.permutation(4 * K)[:K].astype(np.int32)
    links = np.full((K, N), -1, np.int32)
    kp_valid = g.uniform(0, 1, (K, N)) < 0.95
    if tie is None:
        m = (g.uniform(0.5, 0.95, K) * N).astype(int)
        step = max(1, int(0.72 * N / 12))
        start = np.argsort(np.argsort(frame_no)) * step
        for k in range(K):
            stretch = g.choice(2 * m[k], m[k], replace=False)
            links[k, g.choice(N, m[k], replace=False)] = \
                (start[k] + stretch) % L
            rep = g.choice(N, max(1, N // 50), replace=False)
            links[k, rep] = links[k, g.choice(N, len(rep))]
    else:
        n_red, n_obs = tie
        assert n_obs + 4 <= N and n_red + K * (n_obs - n_red) <= L
        kp_valid[:] = True
        for k in range(K):
            cols = g.permutation(N)
            own = n_red + k * (n_obs - n_red) + np.arange(n_obs - n_red)
            links[k, cols[:n_obs]] = np.concatenate([np.arange(n_red), own])
            off = cols[n_obs:n_obs + 4]
            links[k, off] = g.integers(0, n_red, len(off))
            kp_valid[k, off] = False
    return links, kp_valid, valid, frame_no


def cull_inputs(torch, dev, K, N, L, **kw):
    """``cull_ranks_kernel``'s tensor arguments on ``cull_store``: (order,
    links, kp_valid, valid, counts)."""
    from sfm_tpu_torch.mapstore import cull_order_counts
    links, kp_valid, valid, frame_no = (
        torch.as_tensor(a, device=dev) for a in cull_store(K, N, L, **kw))
    order, counts = cull_order_counts(valid, frame_no, links, kp_valid, L)
    return order, links, kp_valid, valid, counts


def cull_case(K, N, L, keep_first=2, redundancy=0.9, min_others=3, **kw):
    """The keyframe cull at (K, N, L) on ``cull_store(**kw)``: the walk's
    three outputs (valid, culled, the decremented counts) bit for bit."""
    def build(torch, dev):
        from sfm_tpu_torch import mapstore as ms
        opts = dict(redundancy=redundancy, min_others=min_others,
                    keep_first=keep_first)
        tie = kw.get("tie")
        return [_sub(
            f"cull {K}x{N}x{L}" + (f" tie {tie[0]}/{tie[1]}" if tie else "")
            + f" keep_first {keep_first}",
            cull_inputs(torch, dev, K, N, L, **kw),
            lambda *a: ms.cull_ranks_kernel(*a, **opts),
            lambda *a: ms.cull_ranks_plain(*a, **opts),
            ("cull.cu cull_keyframes_kernel",), True)]
    return build


# ransac_pnp's inlier threshold in the port's configurations
# (max_reproj_error), in pixels
POSE_THRESHOLD = 7.0


def _rodrigues(rv):
    """Rotation matrices [P, 3, 3] of angle-axis rv [P, 3], in float64."""
    theta = np.linalg.norm(rv, axis=-1)[:, None, None]
    k = rv / np.maximum(theta[:, 0], 1e-300)
    hat = np.zeros((len(rv), 3, 3))
    hat[:, 0, 1], hat[:, 0, 2] = -k[:, 2], k[:, 1]
    hat[:, 1, 0], hat[:, 1, 2] = k[:, 2], -k[:, 0]
    hat[:, 2, 0], hat[:, 2, 1] = -k[:, 1], k[:, 0]
    return np.eye(3) + np.sin(theta) * hat + (1 - np.cos(theta)) * hat @ hat


def pose_problem(P, N, *, seed=0, live=0.9, outliers=0.2, angle=None,
                 degenerate=0, start=(0.002, 0.004), K=K):
    """P tracking problems of N 2D-3D matches, in numpy: (rvec, tvec [P,
    3] the start, xyz [P, N, 3], uv [P, N, 2], valid [P, N], w [P, N] the
    valid inliers as float32).  Points 2-8 units in front of a camera at
    a pose of angle ``angle`` (default up to 0.3 rad) about a random
    axis; inliers within 1.5 px of their projection, a share
    ``outliers`` moved 20-200 px off; the start 0.002 rad and 0.004 units
    (a few pixels) from the truth, so the inliers are within the
    threshold at the start and the outliers far outside it at any pose
    between.  ``degenerate`` > 0: that many points of each problem at
    camera depth ~0 (weight 0; valid) and as many behind the camera (its
    mirrored projection; weight 1)."""
    g = np.random.default_rng(seed)
    axis = g.normal(size=(P, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = g.uniform(0.0, 0.3, P) if angle is None else np.full(P, angle)
    rv, tv = axis * ang[:, None], g.normal(0.0, 0.3, (P, 3))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = g.uniform(2.0, 8.0, (P, N))
    px = g.uniform([20.0, 20.0], [620.0, 460.0], (P, N, 2))
    cam = np.stack([(px[..., 0] - cx) / fx * z, (px[..., 1] - cy) / fy * z,
                    z], -1)
    d = degenerate
    if d:
        cam[:, :d, 2] = g.choice([0.0, 1e-10, -1e-8, 3e-7], (P, d))
        cam[:, d:2 * d] *= -1.0
    R = _rodrigues(rv)
    xyz = np.einsum("pji,pnj->pni", R, cam - tv[:, None, :])
    uv = px + np.clip(g.normal(0.0, 0.5, (P, N, 2)), -1.5, 1.5)
    out = g.uniform(0, 1, (P, N)) < outliers
    out[:, :2 * d] = False
    far, phi = g.uniform(20.0, 200.0, (P, N)), g.uniform(0, 2 * np.pi, (P, N))
    uv[out] += (far * np.stack([np.cos(phi), np.sin(phi)], 0))[:, out].T
    valid = g.uniform(0, 1, (P, N)) < live
    w = valid & ~out
    if d:
        valid[:, :2 * d] = True
        w[:, :d], w[:, d:2 * d] = False, True
    start_rv = rv + g.normal(0.0, start[0], (P, 3))
    start_tv = tv + g.normal(0.0, start[1], (P, 3))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32(start_rv), f32(start_tv), f32(xyz), f32(uv), valid,
            f32(w))


def pose_inputs(torch, dev, P, N, gated, *, shared=False, **kw):
    """A pose kernel call's tensor arguments on ``pose_problem(**kw)``:
    (K, rvec, tvec, xyz, uv, valid if ``gated`` else w).  P = 1 is the
    tracking call's unbatched form; ``shared``: the P poses against the
    first problem's points (a batch stride of 0)."""
    rv, tv, xyz, uv, valid, w = pose_problem(P, N, **kw)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pts = (xyz, uv, valid if gated else w)
    if P == 1 or shared:
        pts = tuple(a[0] for a in pts)
    if P == 1:
        rv, tv = rv[0], tv[0]
    return (t(K), t(rv), t(tv)) + tuple(t(a) for a in pts)


def pose_fns(gated, iters):
    """(kernel, plain) on ``pose_inputs``' arguments: ``refined`` (the
    gated rounds) or ``refine_pose``."""
    from sfm_tpu_torch import ransac
    from sfm_tpu_torch.geometry import pnp
    if gated:
        gate = dict(threshold=POSE_THRESHOLD, iters=iters)
        return (lambda *a: ransac.refined_kernel(*a, **gate),
                lambda *a: ransac.refined_plain(*a, **gate))
    return (lambda *a: pnp.refine_pose_kernel(*a, iters),
            lambda *a: pnp.refine_pose_plain(*a, iters))


def pose_case(P, N, gated, iters, **kw):
    """The pose refinement at P poses of N points: rvec and tvec (gated,
    also the inliers as 0/1 and their count), no farther from the plain
    version run in float64 than twice the float32 plain version, plus
    1e-6 of the largest entry (sanitize_check's rule)."""
    def build(torch, dev):
        kernel, plain = pose_fns(gated, iters)
        as_poses = lambda out: tuple(  # noqa: E731
            o.to(out[0].dtype) for o in out)
        return [_sub(
            f"pose {'gated' if gated else 'refine'} {P}x{N} x{iters}"
            + "".join(f" {k} {v:g}" for k, v in kw.items()),
            pose_inputs(torch, dev, P, N, gated, **kw),
            lambda *a: as_poses(kernel(*a)), lambda *a: as_poses(plain(*a)),
            ("pose.cu pose_refine_kernel",), False)]
    return build


# the pose kernel's calls on the main path, label -> (P, N, gated, iters,
# share of valid points): the tracking PnP's gated rounds and the
# widened-track refinement at 512 matches, the fleet's 64 scans, and
# relocalisation's match of every landmark slot (FLAGSHIP's 8192,
# LONGSCAN's 65536; at most 512 of them matched)
POSE_SHAPES = {
    "PnP gated 512, 2 x 6": (1, 512, True, 6, 0.9),
    "refine 512, 4": (1, 512, False, 4, 0.9),
    "fleet PnP gated 64 x 512, 2 x 6": (64, 512, True, 6, 0.9),
    "fleet refine 64 x 512, 4": (64, 512, False, 4, 0.9),
    "reloc gated 8192, 2 x 6": (1, 8192, True, 6, 0.06),
    "loop probe gated 65536, 2 x 6": (1, 65536, True, 6, 0.02),
}
# the phase whose launches each POSE_SHAPES call is, and its call sites
# (``count_pose_sites``): the FLAGSHIP scan's tracking, the fleet's,
# relocalisation in the live phase (FLAGSHIP's 8192 slots) and the
# ring's loop probes and relocalisation (RING's 65536)
POSE_RUNS = {
    "PnP gated 512, 2 x 6": ("flagship", ("tracking._pnp",)),
    "refine 512, 4": ("flagship", ("tracking._refine",)),
    "fleet PnP gated 64 x 512, 2 x 6": ("fleet", ("tracking._pnp",)),
    "fleet refine 64 x 512, 4": ("fleet", ("tracking._refine",)),
    "reloc gated 8192, 2 x 6": ("live", ("reloc.reloc_step",)),
    "loop probe gated 65536, 2 x 6": ("ring", ("loop.probe",
                                               "reloc.reloc_step")),
}


def pose_launches(label, by_phase):
    """(the launches of POSE_SHAPES' call ``label`` in its phase, and by
    phase) from ``count_pose_sites``' counts by phase."""
    P, N = POSE_SHAPES[label][:2]
    phase, sites = POSE_RUNS[label]
    counts = {ph: sum(v for (site, p, n), v in c.items()
                      if site in sites and (p, n) == (P, N))
              for ph, c in by_phase.items()}
    return counts.get(phase, 0), {ph: v for ph, v in counts.items() if v}
# floating-point operations a point costs the pose kernel in one pass
# (csrc/pose.cu's pass: R X + t 18, the projection and its residual 10,
# the cost 6, the inverse depth, residual and Jacobian blocks 57, the 21
# entries of H and 6 of g 108), and in the gated mode's last pass (R X +
# t, the projection and the error, 32)
POSE_OPS_PER_POINT = 199
POSE_FINAL_OPS_PER_POINT = 32


def pose_bound(args, gated, iters):
    """``bound`` of one pose kernel call: its inputs read once, its
    outputs written once, every pass's operations (the gated mode's two
    rounds: csrc/pose.cu's kRounds)."""
    K_, rv, tv, xyz, uv, wv = args
    P, N = rv.numel() // 3, xyz.shape[-2]
    passes = 2 * (iters + 1) if gated else iters + 1
    ops = P * N * (passes * POSE_OPS_PER_POINT
                   + (POSE_FINAL_OPS_PER_POINT if gated else 0))
    written = 2 * P * 3 * 4 + (P * N + 8 * P if gated else 0)
    return bound(nbytes(K_, rv, tv, xyz, uv, wv) + written, ops)


def pose_cost(torch, args, rv, tv, w):
    """The weighted squared reprojection error of poses (rv, tv) in
    float64, [P]."""
    from sfm_tpu_torch.geometry.camera import project
    K_, _, _, xyz, uv, _ = (a.double() for a in args)
    res = (project(K_, rv.double(), tv.double(), xyz) - uv) * \
        w.double()[..., None]
    return (res ** 2).sum((-2, -1))


# the pose check: every pose's final cost (float64, on the float64 plain
# version's weights) no farther from the float64 plain version's than
# twice the float32 plain version's, plus this share of it.  The float32
# cost cannot tell a step along a problem's flattest direction from its
# own rounding (a residual of ~0.5 px is the difference of pixels of
# hundreds), so float32 refinements that sum in another order keep or
# refuse such a step apart and end up to ~2e-5 apart in the pose, while
# their costs stay close: the plain version on its points in three other
# orders, on 1,500 problems of ``pose_problem`` (near and far starts, 512
# to 8192 points), read at most 8.9e-6 of the cost from the float64 plain
# version's, and its poses failed the pose rule of ``sanitize_check`` on
# 2 of 60 outputs.  Dropping the last iteration, or the gated mode's
# second round, misses by up to 1e1 of the cost on far starts
# (``pose_faults``).
POSE_COST_TOL = 3e-5
# far starts (rad, units off the truth), at which the refinement's last
# iteration (4, from 0.15 rad) and the gated mode's second round (round
# one's gate at 0.004 rad misses inliers) still move the answer
POSE_FAR = {False: (0.15, 0.3), True: (0.004, 0.008)}


def pose_within(torch, args, out, ref, ref64, gated):
    """[P] bool: each pose of ``out`` by the pose check (POSE_COST_TOL)
    against the float32 plain version's ``ref`` and the float64 one's
    ``ref64``."""
    w = ref64[2] if gated else args[5]
    c, c32, c64 = (pose_cost(torch, args, o[0], o[1], w)
                   for o in (out, ref, ref64))
    return (c - c64).abs() <= 2 * (c32 - c64).abs() + POSE_COST_TOL * c64


def pose_faults(torch, dev, P=64, N=512):
    """The pose check on P problems started far (POSE_FAR) at the main
    path's iteration counts: the kernel passes it for every pose, and two
    planted faults fail it for some: the refinement with one iteration
    fewer, and the gated mode's first round alone (its weights the gate
    at the start, then ``refine_pose``).  Returns, by name, the share of
    poses that fail the check."""
    from sfm_tpu_torch.geometry import pnp
    shares = {}
    for gated, iters in ((False, 4), (True, 6)):
        args = pose_inputs(torch, dev, P, N, gated, start=POSE_FAR[gated],
                           seed=17)
        kernel, plain = pose_fns(gated, iters)
        ref, ref64 = plain(*args), plain(*_to_f64(torch, *args))
        K_, rv, tv, xyz, uv, wv = args
        if gated:
            gate = (pnp.reprojection_errors(K_, rv, tv, xyz, uv)
                    < POSE_THRESHOLD) & wv
            fault = ("gated, round one alone", pnp.refine_pose_kernel(
                K_, rv, tv, xyz, uv, gate.to(torch.float32), iters))
        else:
            fault = ("refine, one iteration fewer",
                     pnp.refine_pose_kernel(*args, iters - 1))
        for name, out in ((f"{'gated' if gated else 'refine'} kernel",
                           kernel(*args)), fault):
            ok = pose_within(torch, args, out, ref, ref64, gated)
            shares[name] = float((~ok).float().mean())
    log("[pose] far starts, share of poses failing the pose check: "
        + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    run_checks("pose far starts", {
        "the kernel passes for every pose": shares["refine kernel"] == 0
        and shares["gated kernel"] == 0,
        "one iteration fewer fails for some pose":
            shares["refine, one iteration fewer"] > 0,
        "round one alone fails for some pose":
            shares["gated, round one alone"] > 0})
    return shares


def run_pose(torch, dev, shapes=POSE_SHAPES, reps=20):
    """The "pose" phase: ``csrc/pose.cu`` at the main path's calls
    (POSE_SHAPES) against its plain version on the card: one launch a
    call, two launches equal bit for bit, every pose by the pose check
    (``pose_within``) and, gated, the same inliers and count; then its
    device time (torch.profiler and CUDA events), the host's time to
    return from the call, the plain version's synchronised host time, and
    the bound; then ``pose_faults``.  Returns the rows by label, and the
    far starts' shares under "far starts"."""
    from sfm_tpu_torch import native
    rows = {}
    for label, (P, N, gated, iters, live) in shapes.items():
        args = pose_inputs(torch, dev, P, N, gated, live=live, seed=P + N)
        kernel, plain = pose_fns(gated, iters)
        n0 = native.LAUNCHES["pose_refine"]
        out = kernel(*args)
        torch.cuda.synchronize()
        launched = native.LAUNCHES["pose_refine"] - n0
        again = kernel(*args)
        ref = plain(*args)
        ref64 = plain(*_to_f64(torch, *args))
        torch.cuda.synchronize()
        w = ref64[2] if gated else args[5]
        c_k, c_p, c_64 = (pose_cost(torch, args, o[0], o[1], w)
                          for o in (out, ref, ref64))
        rel = float(((c_k - c_64).abs() / c_64.clamp(min=1e-30)).max())
        apart = max(float((a - b).abs().max()) for a, b in zip(out, ref[:2]))
        checks = {
            "one launch a call": launched == 1,
            "two launches equal bit for bit": all(
                same_bits(torch, a, b) for a, b in zip(out, again)),
            "every pose by the pose check": bool(pose_within(
                torch, args, out, ref, ref64, gated).all()),
        }
        if gated:
            checks["the plain version's inliers and count"] = bool(
                torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3]))
        run_checks(f"pose {label}", checks)
        ms = device_ms(torch, lambda: kernel(*args), reps)
        ev = cuda_ms(torch, lambda: kernel(*args), reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            kernel(*args)
        host_ms = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            plain(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0) / 3
        b = pose_bound(args, gated, iters)
        log(f"[pose] {label}: device {us(ms)} (events {us(ev)}), bound "
            f"{us(b['bound_ms'])} by {b['bound_by']}{share(b['bound_ms'], ms)}"
            f"; the host returns in {us(host_ms)}; the plain version "
            f"{us(plain_ms)} synchronised; poses {apart:.2e} apart, final "
            f"cost {rel:.2e} of the float64 plain version's"
            + (f", inliers {int(ref[3].sum())}" if gated else ""))
        rows[label] = dict(shape=label, ms=ms, event_ms=ev, host_ms=host_ms,
                           plain_ms=plain_ms, apart=apart, cost_rel=rel,
                           **b)
    rows["far starts"] = pose_faults(torch, dev)
    return rows


# name -> builder(torch, dev) of the driver's calls: the main path's
# shapes first, then the edges
SANITIZE_CASES = {
    **{f"K1 {c[0]}": k1_main_case(c) for c in K1_CASES},
    "K1 fleet 64x512x512": k1_main_case(
        ("64x512x512", 64, 512, 512, False, 1.5, 40.0)),
    "K5 main": k5_main,
    "K5 batch": k5_batch,
    "BA flagship": ba_main_case(32, 2048, 8),
    "BA longscan mapping": ba_main_case(512, 16384, 8),
    "cull flagship": cull_case(32, 512, 8192),
    "cull longscan": cull_case(512, 512, 65536),
    "pose refine 512": pose_case(1, 512, False, 1),
    "pose gated 512": pose_case(1, 512, True, 1),
    "K1 37x53": k1_edge_case(1, 37, 53, 40.0),
    "K1 1x1": k1_edge_case(1, 1, 1, 1e9),
    "K1 B=3 expanded": k1_edge_case(3, 37, 53, 40.0, expand=True),
    "K1 sources invalid": k1_edge_case(2, 37, 53, 40.0, src_live=0.0),
    "K1 targets invalid": k1_edge_case(2, 37, 53, 40.0, tgt_live=0.0),
    "K1 wild centres": k1_edge_case(2, 37, 53, 40.0, wild=True),
    "K1 cells 2200x37x53": k1_edge_case(2200, 37, 53, 7.0, wild=True),
    "K1 cells Nt=2048": k1_edge_case(3, 700, 2048, 7.0),
    "K5 borders": k5_borders,
    "K5 batch 3x37": lambda torch, dev: k5_batch(torch, dev, 3, 37, 97, 211),
    "BA C=1": ba_edge_case(1, 37, 3),
    "BA L=37": ba_edge_case(5, 37, 8),
    "BA kmax=1": ba_edge_case(7, 301, 1),
    "BA kmax=16": ba_edge_case(7, 301, 16),
    "BA kmax=40": ba_edge_case(4, 130, 40),
    "cull 1500 keypoints": cull_case(64, 1500, 16384, keep_first=0),
    "cull 5000 keypoints": cull_case(64, 5000, 65536, live=1.0),
    "cull 16384 keypoints": cull_case(64, 16384, 65536, keep_first=0,
                                      live=1.0),
    "cull N=37": cull_case(40, 37, 1024, seed=4),
    "cull tie 450/500": cull_case(48, 512, 8192, tie=(450, 500)),
    "cull tie 1/2": cull_case(48, 512, 8192, keep_first=0, redundancy=0.5,
                              tie=(1, 2)),
    "cull K=1": cull_case(1, 512, 8192, keep_first=0, live=1.0),
    "cull every slot invalid": cull_case(32, 512, 8192, live=0.0),
    "pose gated 3x301": pose_case(3, 301, True, 1, seed=2),
    "pose 5 poses, one point set": pose_case(5, 700, False, 1, shared=True),
    "pose depth ~0 and behind": pose_case(2, 512, True, 1, degenerate=8),
}


def sanitize_check(torch, sub):
    """One sub-case: the kernel in two guarded runs (POISONS), equal bit
    for bit (an output left unwritten, or a read of unwritten scratch,
    would carry the poison), and equal to the plain version: K1 and K5 bit
    for bit; K2 and K3, whose edge tables (a landmark seen once: V
    singular but for the damping) leave the f32 plain version itself up
    to ~2e-4 of the largest entry from float64, no farther from the plain
    version run in float64 than twice the f32 plain version, plus 1e-6,
    entry by entry over the largest entry (ba_kernel_rows' witness, in
    the max norm).  Returns the wrapper calls made."""
    from sfm_tpu_torch import native
    n0 = sum(native.LAUNCHES.values())
    runs = [guarded_run(torch, sub["kernel"], sub["inputs"], p)
            for p in POISONS]
    calls = sum(native.LAUNCHES.values()) - n0
    for a, b in zip(*runs):
        if not same_bits(torch, a, b):
            raise AssertionError(f"{sub['label']}: the two poisons give "
                                 f"different outputs")
    ref = sub["plain"](*sub["inputs"])
    ref = ref if isinstance(ref, tuple) else (ref,)
    if sub["exact"]:
        for i, (a, b) in enumerate(zip(runs[0], ref)):
            if not same_bits(torch, a, b):
                raise AssertionError(f"{sub['label']}: output {i} differs "
                                     f"from the plain version")
        return calls
    ref64 = sub["plain"](*_to_f64(torch, *sub["inputs"]))
    ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
    for i, (a, b, c) in enumerate(zip(runs[0], ref, ref64)):
        scale = max(float(c.abs().max()), 1e-30) if c.numel() else 1.0
        far_k = float((a.double() - c).abs().max()) / scale if c.numel() \
            else 0.0
        far_p = float((b.double() - c).abs().max()) / scale if c.numel() \
            else 0.0
        if not far_k <= 2 * far_p + 1e-6:
            raise AssertionError(
                f"{sub['label']}: output {i} is {far_k:.2e} of its largest "
                f"entry from the plain version run in float64 (the f32 "
                f"plain version {far_p:.2e})")
    return calls


def k1_refusals(torch, dev):
    """K1's wrapper refuses an empty batch (B, Ns or Nt of 0: the kernels
    would index row -1) with ValueError and launches nothing."""
    from sfm_tpu_torch import native
    from sfm_tpu_torch.features import match_pallas as mp
    out = {}
    for B, Ns, Nt in ((1, 0, 53), (1, 37, 0), (0, 37, 53)):
        z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
            s, dtype=dt, device=dev)
        args = (z(B, Ns, 16, dt=torch.int32), z(B, Ns, 2),
                z(B, Ns, dt=torch.bool), z(B, Nt, 16, dt=torch.int32),
                z(B, Nt, 2), z(B, Nt, dt=torch.bool), 0.0, 1600.0, 90.0,
                0.8)
        n0 = native.LAUNCHES["hamming_match"]
        try:
            mp.match_result_kernel(*args)
            refused = False
        except ValueError:
            refused = True
        out[f"{B}x{Ns}x{Nt}"] = refused and \
            native.LAUNCHES["hamming_match"] == n0
    return out


def sanitize_target(torch, dev, names=None):
    """The kernel driver (``python3 chip_smoke.py --sanitize-target``):
    every case of SANITIZE_CASES (or of ``names``) through
    ``sanitize_check``, and K1's refusals.  Returns the launches of each
    __global__ function (from the wrappers' counts, with K1's route and
    K3's mode: the counts are per wrapper), the cases and the checks;
    raises on the first disagreement."""
    from sfm_tpu_torch import native
    native.reset_launch_counts()
    functions = dict.fromkeys(SANITIZE_FUNCTIONS, 0)
    labels = []
    for name in names or SANITIZE_CASES:
        for sub in SANITIZE_CASES[name](torch, dev):
            calls = sanitize_check(torch, sub)
            for f in sub["functions"]:
                functions[f] += calls
            labels.append(sub["label"])
    refused = k1_refusals(torch, dev)
    if not all(refused.values()):
        raise AssertionError(f"K1 launched an empty batch: {refused}")
    return dict(functions=functions, launches=dict(native.LAUNCHES),
                cases=labels, k1_refused=refused)


def _summary_errors(text):
    """The error count of a compute-sanitizer report (None without a
    summary line)."""
    import re
    found = re.findall(r"(?:ERROR SUMMARY|RACECHECK SUMMARY): (\d+)", text)
    return int(found[-1]) if found else None


def run_sanitize(torch, dev):
    """The "sanitize" phase: ``sanitize_target`` in this process, then
    compute-sanitizer (found as nvcc is; its absence raises) over
    ``python3 chip_smoke.py --sanitize-target`` with each tool, the port's
    functions only and PyTorch's caching allocator off (or memcheck would
    not see a read past a tensor's end, nor initcheck reused memory).  A
    run must exit 0 with 0 errors and launch every function.  A card that
    the sanitizer does not support ("Device not supported": it then breaks
    the program's CUDA calls) is recorded, and the tools are not run."""
    import os
    from sfm_tpu_torch import native
    t0 = time.perf_counter()
    out = sanitize_target(torch, dev)
    driver_s = time.perf_counter() - t0
    idle = [f for f, n in out["functions"].items() if n == 0]
    log(f"[sanitize] guarded driver: {len(out['cases'])} calls, each "
        f"kernel twice in {GUARD_BYTES}-byte guard bands of poison "
        f"{[hex(p) for p in POISONS]} against its plain version, "
        f"{driver_s:.1f} s; launches by function {out['functions']}; K1 "
        f"refuses empty batches {out['k1_refused']}")
    run_checks("sanitize", {
        "every __global__ function launched by the guarded driver":
            not idle})
    tool = native.cuda_tool("compute-sanitizer")
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    runs = {}
    for name in SANITIZER_TOOLS:
        cmd = [tool, "--tool", name, "--error-exitcode", "99",
               "--kernel-name", SANITIZER_FILTER, "--show-backtrace", "no",
               "--print-limit", "20", sys.executable,
               os.path.abspath(__file__), "--sanitize-target"]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=SANITIZER_TIMEOUT)
        secs = time.perf_counter() - t0
        text = p.stdout + p.stderr
        errors = _summary_errors(text)
        if "Device not supported" in text:
            runs[name] = dict(status="device not supported", seconds=secs,
                              returncode=p.returncode, errors=errors)
            log(f"[sanitize] {name}: compute-sanitizer {version} ({tool}) "
                f"answers 'Device not supported' on this card "
                f"({torch.cuda.get_device_name(0)}) in {secs:.1f} s (exit "
                f"{p.returncode}); the four tools are not run here")
            break
        child = [json.loads(ln) for ln in p.stdout.splitlines()
                 if ln.startswith('{"sanitize_target"')]
        launched = child[-1]["sanitize_target"]["functions"] if child \
            else {}
        runs[name] = dict(status="run", seconds=secs,
                          returncode=p.returncode, errors=errors,
                          functions=launched)
        log(f"[sanitize] {name}: {secs:.1f} s, exit {p.returncode}, "
            f"{errors} errors, launches {launched}")
        run_checks(f"sanitize {name}", {
            "exit 0": p.returncode == 0, "0 errors": errors == 0,
            "every function launched": bool(launched)
            and all(n > 0 for n in launched.values())})
    return dict(driver=out, driver_s=driver_s, compute_sanitizer=tool,
                version=version, tools=runs)


def ring_runs(torch, n):
    """The ring phase alone, ``n`` times on one card: each run's checks and
    numbers as a JSON line (its K1 calls are not replayed), then whether
    the runs' final maps agree bit for bit.  Returns the number of runs
    that failed a check, plus one when the maps disagree."""
    from sfm_tpu_torch.config import RING, SfMConfig
    failed, digests = 0, []
    for i in range(n):
        out = run_ring(torch, "cuda", SfMConfig(**RING), MAIN_PATH,
                       check=False)
        out.pop("global_ba_calls")
        bad = [k for k, ok in out["checks"].items() if not ok]
        failed += bool(bad)
        digests.append(out["digest"])
        log(f"[ring] run {i + 1} of {n}: "
            + (f"FAILED {bad}" if bad else "every check passed"))
        print(json.dumps({"ring_run": i + 1, **out}), flush=True)
    agree = len(set(digests)) == 1
    log(f"[ring] the {n} rings' final maps agree bit for bit: {agree} "
        f"({digests})")
    print(json.dumps({"rings_agree": agree, "digests": digests}), flush=True)
    return failed + (not agree)


def fleet_runs(torch, n):
    """The fleet phase alone, ``n`` times on one card, after one FLAGSHIP
    single-scan run for the rate beside it: each run's checks and numbers
    as a JSON line (its K1 calls are not replayed).  Returns the number of
    runs that failed a check."""
    from sfm_tpu_torch.config import FLAGSHIP, SfMConfig
    single = run_slice(torch, "cuda", SfMConfig(**FLAGSHIP), "flagship",
                       MAIN_PATH)
    failed = 0
    for i in range(n):
        out = run_fleet(torch, "cuda", SfMConfig(**FLAGSHIP),
                        single_fps=single["fps"], check=False)
        out.pop("keep")
        bad = [k for k, ok in out.pop("checks").items() if not ok]
        failed += bool(bad)
        log(f"[fleet] run {i + 1} of {n}: "
            + (f"FAILED {bad}" if bad else "every check passed"))
        print(json.dumps({"fleet_run": i + 1, "failed": bad, **out},
                         default=str), flush=True)
    return failed


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
    t_start = time.perf_counter()
    native.library()
    if "--sanitize-target" in argv:
        print(json.dumps({"sanitize_target": sanitize_target(torch, dev)}))
        return 0
    log(f"kernel build: {native.BUILD_INFO['seconds']:.2f} s "
        f"({native.BUILD_INFO['path']})")
    log(native.BUILD_INFO.get("ptxas", ""))
    if "--pose" in argv:
        print(json.dumps({"pose": run_pose(torch, dev)}))
        print(card[0])
        return 0
    if "--ring" in argv:
        failed = ring_runs(torch, int(argv[argv.index("--ring") + 1]))
        print(card[0])
        return int(failed > 0)
    if "--fleet" in argv:
        failed = fleet_runs(torch, int(argv[argv.index("--fleet") + 1]))
        print(card[0])
        return int(failed > 0)
    if "--dist" in argv:
        dist = run_dist(torch, dev)
        keep = dist.pop("keep")
        pod = pod_kernel_rows(torch, dev, keep)
        k1, k5 = sharded_fleet_rows(torch, dev, keep)
        print(json.dumps({"dist": dist, "pod_kernels": pod,
                          "sharded_fleet_k1": k1, "sharded_fleet_k5": k5},
                         default=str))
        print(card[0])
        return 0
    from sfm_tpu_torch.config import FLAGSHIP, LONGSCAN, RING, SLICE, SfMConfig
    if "--raytrace" in argv:
        print(json.dumps(raytrace_and_anchor(torch, dev), default=str))
        print(card[0])
        return 0
    sanitize = run_sanitize(torch, dev)
    # the pose kernel's launches by call site and shape, phase by phase
    pose_sites, restore_pose = count_pose_sites(native)
    pose_by_phase = {}

    def pose_phase(name):
        seen = {}
        for c in pose_by_phase.values():
            for k, v in c.items():
                seen[k] = seen.get(k, 0) + v
        pose_by_phase[name] = {k: v - seen.get(k, 0)
                               for k, v in pose_sites.items()
                               if v != seen.get(k, 0)}
    k1_calls = []
    flagship = run_slice(torch, dev, SfMConfig(**FLAGSHIP), "flagship",
                         MAIN_PATH, k1_calls=k1_calls, keep=True)
    pose_phase("flagship")
    dense = run_slice(torch, dev, SfMConfig(**SLICE), "dense",
                      ("hamming_match", "patch_sampler"))
    # the dense solver sums in a fixed order: a rerun repeats bit for bit
    dense_again = run_slice(torch, dev, SfMConfig(**SLICE), "dense rerun",
                            ("hamming_match", "patch_sampler"))
    pose_phase("dense")
    run_checks("dense", {
        "a rerun gives the same statuses, keyframes and landmarks bit for "
        "bit": dense_again["digest"] == dense["digest"]
        and dense_again["statuses"] == dense["statuses"]})
    bench, bench_once = run_bench_ba(torch, dev)
    live = run_live(torch, dev, SfMConfig(**FLAGSHIP), MAIN_PATH)
    pose_phase("live")
    flow_cfg = SfMConfig(**FLAGSHIP, track_with_flow=True)
    flow = run_slice(torch, dev, flow_cfg, "flow", MAIN_PATH, n_frames=30)
    flow["lk_flow_ms"] = time_flow(torch, dev, flow_cfg)
    pose_phase("flow")
    cli = run_cli(torch, dev)
    pose_phase("cli")
    pipeline = run_pipeline(torch, dev, SfMConfig(**FLAGSHIP), MAIN_PATH)
    pose_phase("pipeline")
    serve = run_serve(torch, dev, FLAGSHIP, MAIN_PATH)
    pose_phase("serve")
    cg = run_slice(torch, dev, SfMConfig(**dict(FLAGSHIP, ba_solver="cg")),
                   "cg", ("hamming_match", "patch_sampler"), n_frames=40)
    pose_phase("cg")
    log(f"[cg] mapping pass {cg['map_ms']:.3f} ms (large "
        f"{flagship['map_ms']:.3f} ms, dense {dense['map_ms']:.3f} ms)")
    long_cfg = SfMConfig(**LONGSCAN)
    long_k1_calls = []
    longscan = run_longscan(torch, dev, long_cfg, MAIN_PATH,
                            k1_calls=long_k1_calls)
    pose_phase("longscan")
    ring_k1_calls = []
    ring = run_ring(torch, dev, SfMConfig(**RING), MAIN_PATH,
                    k1_calls=ring_k1_calls)
    pose_phase("ring")
    fleet_k1_calls = []
    fleet = run_fleet(torch, dev, SfMConfig(**FLAGSHIP),
                      k1_calls=fleet_k1_calls, single_fps=flagship["fps"])
    pose_phase("fleet")
    dist = run_dist(torch, dev)
    raytrace, anchor = raytrace_and_anchor(torch, dev, bench_once)
    pose_phase("raytrace")
    # the kernels against their plain versions, with the timings under
    # torch.profiler last: a profiler session leaves the host slower for
    # the host-bound phases after it
    rows = check_kernels(torch, dev)
    pose_rows = run_pose(torch, dev)
    pose_far = pose_rows.pop("far starts")
    k1_sites = k1_by_site(torch, k1_calls)
    if sum(r["calls"] for r in k1_sites.values()) \
            != flagship["launches"]["hamming_match"]:
        raise AssertionError("K1: the recorded calls are not the scan's "
                             "launches")
    long_k1 = k1_by_site(torch, long_k1_calls, "LONGSCAN")
    if sum(r["calls"] for r in long_k1.values()) \
            != longscan["launches"]["hamming_match"]:
        raise AssertionError("K1: the recorded calls are not the long "
                             "scan's launches")
    del long_k1_calls[:]
    # the ring's other sites have the long scan's shapes: only the loop
    # probe's calls are replayed
    ring_k1 = k1_by_site(torch, ring_k1_calls, "RING")
    if sum(r["calls"] for r in ring_k1.values()) \
            != loop_k1_launches(ring["k1_sites"]):
        raise AssertionError("K1: the recorded calls are not the ring's "
                             "launches at the loop probe")
    del ring_k1_calls[:]
    # the fleet's K1 calls in its timed tracking steps: B = 64 scans in a
    # call, at tracking (64x512x512) and widen (64x2048x512)
    fleet_k1 = k1_by_site(torch, fleet_k1_calls, "FLEET")
    if sum(r["calls"] for r in fleet_k1.values()) \
            != 2 * fleet["tracking_steps"]:
        raise AssertionError("K1: the recorded calls are not the fleet's "
                             "tracking steps' launches")
    del fleet_k1_calls[:]
    fleet_k5 = fleet_k5_row(torch, fleet["keep"]["driver"].cfg,
                            fleet["keep"]["chunk"][-1])
    rows.update(check_ba_kernels(torch, dev))
    dist_keep = dist.pop("keep")
    pod_rows = pod_kernel_rows(torch, dev, dist_keep)
    block_k1, block_k5 = sharded_fleet_rows(torch, dev, dist_keep)
    del dist_keep
    bench.update(bench_ba_device(torch, bench_once))
    long_dev = longscan_device(torch, long_cfg, longscan)
    fleet["device"] = fleet_device(torch, fleet)
    pipeline["device"] = pipeline_device(torch, pipeline)
    # the helpers on the FLAGSHIP scan's final engine; its device_trace is
    # a profiler session, so it comes after every timed one
    with tempfile.TemporaryDirectory() as trace_dir:
        helpers = run_helpers(torch, dev, flagship.pop("keep"), trace_dir)
    pose_phase("helpers")
    restore_pose()
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
            launches_by_phase=dict(
                {ph: out["launches"][name] for ph, out in (
                    ("flagship", flagship), ("pipeline", pipeline),
                    ("serve", serve), ("raytrace", raytrace),
                    ("anchor", anchor), ("helpers", helpers))},
                dist=dist["launches"].get(name, 0)),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"],
            event_ms=r["event_ms"], plain_event_ms=r["plain_event_ms"],
            ops_per_call=r["ops_per_call"]))
    # the BA kernels again at the long scan's global-BA and mapping shapes;
    # their launches are the long scan's (inside global BA calls, inside
    # mapping passes)
    source = {n: (src, rep) for n, src, rep in KERNEL_ROWS}
    for (name, _), r in long_dev.pop("rows").items():
        if r["ms"] is None or r["plain_ms"] is None:
            raise AssertionError(f"{name} {r['shape']}: torch.profiler "
                                 f"recorded no device time")
        kernels.append(dict(
            name=name, route="cuda", source=source[name][0],
            replaces=source[name][1], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"],
            event_ms=r["event_ms"], plain_event_ms=r["plain_event_ms"],
            ops_per_call=r["ops_per_call"],
            **{k: r[k] for k in ("launches_per_global_ba",
                                 "launches_per_mapping_pass") if k in r}))
    # K2, K3 and K3-gather at the pod's shapes: the world of one's table
    # and a gloo rank's shard; their launches are those of that run's
    # timed distributed solve
    for name, r in pod_rows:
        if r["ms"] is None or r["plain_ms"] is None:
            raise AssertionError(f"{name} {r['shape']}: torch.profiler "
                                 f"recorded no device time")
        kernels.append(dict(
            name=name, route="cuda", source=source[name][0],
            replaces=source[name][1], launches=r["launches"],
            launches_per_lm_iteration=r["launches_per_lm_iteration"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"],
            event_ms=r["event_ms"], plain_event_ms=r["plain_event_ms"],
            ops_per_call=r["ops_per_call"]))
    # K1 at the long scan's own calls, by call site and route: the
    # launches are the phase's, the times per call from the replay
    for label, r in long_k1.items():
        kernels.append(dict(
            name="hamming_match", route="cuda", source=source[
                "hamming_match"][0], replaces=source["hamming_match"][1],
            launches=r["calls"], max_abs_err=0.0, ms=r["us"] / 1e3,
            plain_ms=r["plain_us"] / 1e3, bound_ms=r["bound_us"] / 1e3,
            bound_by=r["bound_by"], library_ms=None,
            shape=f"longscan {label} {' '.join(r['shapes'])}"))
    # K1 at the loop probe's calls in the ring: 65536 windowless sources,
    # the old landmarks valid
    for label, r in ring_k1.items():
        kernels.append(dict(
            name="hamming_match", route="cuda", source=source[
                "hamming_match"][0], replaces=source["hamming_match"][1],
            launches=r["calls"], max_abs_err=0.0, ms=r["us"] / 1e3,
            plain_ms=r["plain_us"] / 1e3, bound_ms=r["bound_us"] / 1e3,
            bound_by=r["bound_by"], library_ms=None,
            shape=f"ring {label} {' '.join(r['shapes'])} windowless"))
    # K1 and K5 at the fleet's batched calls; launches are the timed
    # tracking steps' (one fleet frame each)
    steps = fleet["tracking_steps"]
    for label, r in fleet_k1.items():
        kernels.append(dict(
            name="hamming_match", route="cuda", source=source[
                "hamming_match"][0], replaces=source["hamming_match"][1],
            launches=r["calls"], launches_per_fleet_frame=r["calls"] / steps,
            max_abs_err=0.0, ms=r["us"] / 1e3, plain_ms=r["plain_us"] / 1e3,
            bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
            library_ms=None, other_route=r.get("other_route"),
            other_route_ms=(r["other_route_us"] / 1e3
                            if r.get("other_route_us") is not None
                            else None),
            shape=f"fleet {label} {' '.join(r['shapes'])}"))
    r = fleet_k5
    if r["ms"] is None or r["plain_ms"] is None or r["library_ms"] is None:
        raise AssertionError("K5 fleet: torch.profiler recorded no device "
                             "time")
    kernels.append(dict(
        name="patch_sampler", route="cuda", source=source["patch_sampler"][0],
        replaces=source["patch_sampler"][1], launches=steps,
        launches_per_fleet_frame=1.0, max_abs_err=r["max_abs_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
        event_ms=r["event_ms"], plain_event_ms=r["plain_event_ms"],
        ops_per_call=r["ops_per_call"]))
    # K1 and K5 at the sharded fleet's per-rank batch; launches are gloo
    # rank 0's in the dist phase
    for label, r in block_k1.items():
        kernels.append(dict(
            name="hamming_match", route="cuda", source=source[
                "hamming_match"][0], replaces=source["hamming_match"][1],
            launches=r["calls"], max_abs_err=0.0, ms=r["us"] / 1e3,
            plain_ms=r["plain_us"] / 1e3, bound_ms=r["bound_us"] / 1e3,
            bound_by=r["bound_by"], library_ms=None,
            shape=f"sharded fleet block {label} {' '.join(r['shapes'])}"))
    r = block_k5
    if r["ms"] is None or r["plain_ms"] is None or r["library_ms"] is None:
        raise AssertionError("K5 sharded fleet block: torch.profiler "
                             "recorded no device time")
    kernels.append(dict(
        name="patch_sampler", route="cuda", source=source["patch_sampler"][0],
        replaces=source["patch_sampler"][1], launches=r["launches"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], shape=r["shape"],
        event_ms=r["event_ms"], plain_event_ms=r["plain_event_ms"],
        ops_per_call=r["ops_per_call"]))
    # the pose refinement at the main path's calls; each row's launches
    # are those of its phase (POSE_RUNS) at its call sites and shape, and
    # by phase (the dist phase's ranks are processes of their own)
    for label, r in pose_rows.items():
        launches, by_phase = pose_launches(label, pose_by_phase)
        log(f"[pose] {label}: {launches} launches in its phase "
            f"({POSE_RUNS[label][0]}), by phase {by_phase}")
        kernels.append(dict(
            name="pose_refine", route="cuda",
            source="sfm_tpu_torch/csrc/pose.cu",
            replaces="none: the eager op chain of "
                     "sfm_tpu_torch/geometry/pnp.py::refine_pose",
            launches=launches, launches_by_phase=by_phase,
            max_abs_err=r["apart"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            shape=label, event_ms=r["event_ms"], host_ms=r["host_ms"]))
    longscan.update(device=long_dev, k1_by_site=long_k1)
    ring.update(k1_by_site=ring_k1)
    fleet.update(k1_by_site=fleet_k1)
    fleet.pop("checks")
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
        "cg": {k: v for k, v in cg.items() if k != "launches"},
        "pipeline": pipeline, "serve": serve, "helpers": helpers,
        "dense_rerun_digest_equal": dense_again["digest"] == dense["digest"],
        "longscan": longscan, "ring": ring, "fleet": fleet, "dist": dist,
        "raytrace": raytrace, "anchor": anchor, "sanitize": sanitize,
        "pose_far_starts": pose_far,
        "pose_launches_by_phase": {
            ph: {"|".join(map(str, k)): v for k, v in c.items()}
            for ph, c in pose_by_phase.items()},
        "per_shape": {k: r["per_shape"] for k, r in rows.items()
                      if "per_shape" in r}}))
    print(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start "
        f"of the kernel build")
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
