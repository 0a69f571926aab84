"""GPU smoke run of the PyTorch/CUDA port (sfm_tpu_torch) on one card.

    python3 chip_smoke.py

1. requires CUDA (exits non-zero without a card) and prints the card's
   name and power limit;
2. builds the CUDA kernels from sfm_tpu_torch/csrc (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version at the main path's
   shapes (K1 exact, K5 within 1e-3) and times both with CUDA events;
4. drives the main path: SfMEngine.add_frames on the synthetic 80-frame
   480x640 strafe scan (the JAX package's bench.py workload) with the
   flagship configuration and the dense BA solver, on the card, and checks
   tracking, keyframes, trajectory accuracy (sim(3) keyframe ATE against
   the ground-truth poses) and that both kernels were launched by the run;
5. prints a JSON line with the kernels' numbers, then the card line, then
   {"ok": true, "device": {...}} as the last line.
Any failed check raises, and the script exits non-zero."""

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
)
K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
N_FRAMES = 80


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


def in_turns(torch, plain, kernel):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain)
    k1 = cuda_ms(torch, kernel)
    k2 = cuda_ms(torch, kernel)
    p2 = cuda_ms(torch, plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def check_kernels(torch, dev):
    from sfm_tpu_torch.features import match_pallas as mp
    from sfm_tpu_torch.features import patches_pallas as pp
    from sfm_tpu_torch.features.detect import detect
    from sfm_tpu_torch.features.descriptor import patch_inputs
    from sfm_tpu_torch.synthetic import SpriteScene, strafe_trajectory

    g = np.random.default_rng(5)
    rows = {}
    # (label, B, Ns, Nt, window centres, min_r, max_r): the main path's
    # calls — tracking, widen, mapping triangulation, re-observation
    cases = (("512x512", 1, 512, 512, False, 1.5, 40.0),
             ("2048x512 centres", 1, 2048, 512, True, 0.0, 7.0),
             ("9x512x512", 9, 512, 512, False, 1.5, 120.0),
             ("16x2048x512 centres", 16, 2048, 512, True, 0.0, 7.0))
    k1 = []
    for label, B, Ns, Nt, centers, rmin, rmax in cases:
        args = match_case(torch, g, B, Ns, Nt, centers, dev) + (
            rmin * rmin, rmax * rmax, 90.0, 0.8)
        a = mp.hamming_match_kernel(*args)
        b = mp.hamming_match_plain(*args)
        torch.cuda.synchronize()
        for name, x, y in zip(("idx", "best", "second", "keys"), a, b):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"K1 {label}: {name} differs from the plain version at "
                    f"{int((x != y).sum())} entries")
        kw = dict(min_radius=rmin, max_radius=rmax, max_distance=90.0,
                  ratio=0.8,
                  window_center0=args[1] if centers else None)
        res_k = mp.match_features_pallas(*args[:6], **kw)
        n_match = int(res_k.mask.sum())
        if n_match == 0:
            raise AssertionError(f"K1 {label}: no matches in the test case")
        err = float((a[1] - b[1]).abs().max())
        ms, plain_ms = in_turns(torch, lambda: mp.hamming_match_plain(*args),
                                lambda: mp.hamming_match_kernel(*args))
        k1.append(dict(shape=label, ms=ms, plain_ms=plain_ms,
                       max_abs_err=err, matches=n_match))
        log(f"K1 {label}: exact, {n_match} matches, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
    rows["hamming_match"] = dict(k1[-1], per_shape=k1)

    # K5 on a rendered frame's canvas and keypoints (the main path's shape)
    scene = SpriteScene(np.random.default_rng(11), n_sprites=260, spread=2.4)
    rv, tv = strafe_trajectory(2, step=0.06, yaw_rate=0.001)
    img = torch.as_tensor(scene.render(K, rv[0], tv[0], 480, 640), device=dev)
    kps, canvas = detect(img, max_keypoints=512, levels=4, return_canvas=True)
    canvas_s, cx, cy = patch_inputs(canvas, kps, 4, 640)
    a = pp.extract_patches_kernel(canvas_s, cx, cy)
    b = pp.extract_patches_plain(canvas_s, cx, cy)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"K5: max abs error {err} > 1e-3")
    ms, plain_ms = in_turns(torch,
                            lambda: pp.extract_patches_plain(canvas_s, cx, cy),
                            lambda: pp.extract_patches_kernel(canvas_s, cx, cy))
    rows["patch_sampler"] = dict(shape=f"{cx.shape[0]} kp, canvas "
                                       f"{tuple(canvas_s.shape)}",
                                 ms=ms, plain_ms=plain_ms, max_abs_err=err)
    log(f"K5 {rows['patch_sampler']['shape']}: max abs err {err}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return rows


def run_slice(torch, dev, cfg, K=K, n_frames=N_FRAMES):
    """The main path: add_frames over the bench.py scan in chunks of
    keyframe_time_lag frames, then the checks."""
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
    log(f"bootstrap on frame {boot}; {running:.1%} of later frames RUNNING; "
        f"{n_kf} keyframes {fns.tolist()}; {len(pts)} landmarks; "
        f"ATE {ate:.5f} over extent {extent:.3f} ({100 * ate / extent:.3f}%)")
    log(f"first chunk {first_s:.3f} s; amortised {fps:.3f} frames/s over "
        f"frames {chunk}-{n_frames - 1} (tracking + deferred mapping)")

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
    log(f"mapping pass {np.mean(map_ms):.3f} ms mean of 5 "
        f"({', '.join(f'{x:.3f}' for x in map_ms)})")

    checks = {
        "post-bootstrap frames RUNNING >= 90%": running >= 0.9,
        "keyframes >= 4": n_kf >= 4,
        "sim(3) keyframe ATE < 2% of extent": ate < 0.02 * extent,
        "K1 launched by the main path": launches["hamming_match"] > 0,
        "K5 launched by the main path": launches["patch_sampler"] > 0,
        "state on the engine's device": eng.state.lms.xyz.device.type
        == torch.device(dev).type == eng.state.kfs.frames.desc.device.type,
        "landmarks finite": len(pts) > 0 and bool(np.isfinite(pts).all()),
    }
    for name, ok in checks.items():
        log(f"check {name}: {'pass' if ok else 'FAIL'}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return dict(launches=launches, fps=fps, map_ms=float(np.mean(map_ms)),
                ate_pct=100 * ate / extent, keyframes=n_kf,
                running=running, bootstrap_frame=boot)


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    from sfm_tpu_torch import native
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    native.library()
    log(f"kernel build: {native.BUILD_INFO['seconds']:.2f} s "
        f"({native.BUILD_INFO['path']})")
    log(native.BUILD_INFO.get("ptxas", ""))
    rows = check_kernels(torch, dev)
    from sfm_tpu_torch.config import SLICE, SfMConfig
    result = run_slice(torch, dev, SfMConfig(**SLICE))
    kernels = []
    for name, source, replaces in KERNEL_ROWS:
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=result["launches"][name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], shape=r["shape"]))
    print(json.dumps({"slice": {k: v for k, v in result.items()
                                if k != "launches"},
                      "hamming_match_shapes":
                          rows["hamming_match"]["per_shape"]}))
    print(json.dumps({"kernels": kernels}))
    print(card[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
