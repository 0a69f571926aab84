"""Independent ray-traced validation renderer (numpy only).

A copy of ``sfm_tpu.raytrace``: the same seed renders the same frames bit
for bit in both packages, and this copy runs where JAX is not installed.
It shares no code with the sprite renderer (``synthetic.py``) that the
engine was developed against:

 - geometry: true 3D surfaces (a textured ground plane and axis-aligned
   boxes) rendered by per-pixel ray casting with hidden-surface removal,
   not frontoparallel painted sprites;
 - appearance: procedural multi-octave value-noise textures in world
   coordinates, Lambertian face shading from a directional light, a
   per-frame exposure wobble and Gaussian pixel noise;
 - camera model: the radial-tangential lens distortion is applied by
   inverting the model per OUTPUT pixel (each distorted pixel is traced
   along its true undistorted ray), so the whole frame is distorted;
 - trajectory: a yawing orbital arc generator of its own;
 - evaluation: its own Umeyama sim(3) alignment and ATE.

``chip_smoke.py``'s "raytrace" phase runs the FLAGSHIP engine and
``cli scan`` on this renderer's frames and gates the sim(3) ATE.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- textures

def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic integer-lattice hash -> [0, 1) (vectorized)."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263
         + np.int64(seed) * 144665191) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) % 65536).astype(np.float64) / 65536.0


def value_noise(u: np.ndarray, v: np.ndarray, seed: int,
                octaves: int = 2, base_freq: float = 5.0) -> np.ndarray:
    """Multi-octave bilinear value noise over (u, v) in world coords,
    contrast-stretched so the FAST detector finds corners (smooth noise
    alone is featureless at a 20-intensity threshold).

    BAND-LIMITED on purpose: at the validation scenes' ~100 px/world-unit
    magnification the octaves here have ~8-20 px wavelengths.  Finer
    octaves (< ~2 px wavelength) alias against the pixel grid — the
    texture then decorrelates between frames and descriptors stop
    matching (measured: 1-4 matches/frame at 480x640 with a 0.6 px
    octave vs 200+ without it)."""
    # random-level MOSAIC, not smooth noise: each lattice cell gets an
    # independent uniform gray level with hard borders.  Smooth or
    # few-level textures make descriptor sample pairs land on near-equal
    # values whose comparison bits flip under sensor noise (measured:
    # 25-57 matches/frame, median accepted Hamming ~55-65 of 512);
    # random-per-cell levels make pair differences uniformly distributed
    # and the descriptor stable (the same property the reference's
    # checkable scenes and any real cluttered object have).
    out = np.zeros_like(u, dtype=np.float64)
    amp, freq = 1.0, base_freq
    norm = 0.0
    for o in range(octaves):
        ix = np.floor(u * freq)
        iy = np.floor(v * freq)
        out += amp * _hash01(ix, iy, seed + o)
        norm += amp
        amp *= 0.55
        freq *= 2.7
    return out / norm


# ---------------------------------------------------------------- geometry

def _rot(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues rotation vector -> matrix (own implementation)."""
    r = np.asarray(rvec, np.float64)
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


class RayScene:
    """Textured ground plane (y = +1, y axis points down in camera
    convention) plus a set of axis-aligned textured boxes resting on it."""

    def __init__(self, seed: int = 0, n_boxes: int = 12,
                 spread: float = 2.8, depth: float = 5.0):
        rng = np.random.default_rng(seed)
        self.seed = seed
        self.floor_y = 1.0
        self.light = np.array([0.4, -0.8, -0.45])
        self.light /= np.linalg.norm(self.light)
        # boxes: centers in front of the origin-facing camera arc; tall
        # enough that mostly-frontal faces fill the view (grazing-angle
        # surfaces make keypoints unrepeatable under viewpoint change)
        cx = rng.uniform(-spread, spread, n_boxes)
        cz = rng.uniform(depth - 1.6, depth + 1.6, n_boxes)
        sx = rng.uniform(0.7, 1.4, n_boxes)
        sy = rng.uniform(1.2, 2.8, n_boxes)
        sz = rng.uniform(0.7, 1.4, n_boxes)
        cy = self.floor_y - sy / 2  # resting on the floor
        self.bmin = np.stack([cx - sx / 2, cy - sy / 2, cz - sz / 2], 1)
        self.bmax = np.stack([cx + sx / 2, cy + sy / 2, cz + sz / 2], 1)
        self.box_seed = rng.integers(1, 1 << 30, n_boxes)

    # ---- ray casting ----

    def _rays(self, K, d, rvec, tvec, h, w):
        """World-frame origins/directions for every DISTORTED pixel."""
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        xd = (u - cx) / fx
        yd = (v - cy) / fy
        if d is not None and np.any(np.asarray(d) != 0):
            k1, k2, p1, p2, k3 = (list(np.asarray(d).ravel())
                                  + [0.0] * 5)[:5]
            # iterative inverse of the radial-tangential model: find the
            # normalized coords whose distortion lands on this pixel
            xn, yn = xd.copy(), yd.copy()
            for _ in range(6):
                r2 = xn * xn + yn * yn
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                dx = 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
                dy = p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
                xn = (xd - dx) / radial
                yn = (yd - dy) / radial
        else:
            xn, yn = xd, yd
        dirs_cam = np.stack([xn, yn, np.ones_like(xn)], -1)
        R = _rot(rvec)
        t = np.asarray(tvec, np.float64)
        # x_cam = R x_world + t  ->  origin = -R^T t, dir = R^T dir_cam
        origin = -R.T @ t
        dirs = dirs_cam @ R  # == dirs_cam @ (R^T)^T
        return origin, dirs

    def _shade(self, hit_p, normal, uv, seed):
        tex = value_noise(uv[..., 0], uv[..., 1], seed)
        lam = np.clip(-(normal @ self.light), 0.15, 1.0)
        return (35.0 + 205.0 * tex) * (0.55 + 0.45 * lam)

    def render(self, K, rvec, tvec, h, w, d=None, noise_std=2.0,
               frame_no: int = 0):
        """One [h, w] uint8-range float frame (distorted, shaded, noisy)."""
        origin, dirs = self._rays(K, d, rvec, tvec, h, w)
        tmin = np.full((h, w), np.inf)
        img = np.full((h, w), 12.0)

        # ground plane y = floor_y (normal -y, pointing up toward camera).
        # Low contrast on purpose: the grazing view angle warps floor
        # texture strongly between frames, making floor keypoints
        # unrepeatable — the detector should spend its budget on the
        # (more frontal) box faces.
        dy = dirs[..., 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_pl = (self.floor_y - origin[1]) / dy
        ok = (t_pl > 0.1) & np.isfinite(t_pl)
        p = origin[None, None, :] + dirs * t_pl[..., None]
        uv = np.stack([p[..., 0], p[..., 2]], -1) * 0.5
        sh = self._shade(p, np.array([0.0, -1.0, 0.0]), uv,
                         self.seed + 977)
        sh = 0.25 * sh + 0.75 * 80.0
        img = np.where(ok, sh, img)
        tmin = np.where(ok, t_pl, tmin)

        # boxes: slab test per box, textured per dominant face axis
        inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, 1e12)
        for b in range(self.bmin.shape[0]):
            t0 = (self.bmin[b][None, None, :] - origin[None, None, :]) * inv
            t1 = (self.bmax[b][None, None, :] - origin[None, None, :]) * inv
            tn = np.minimum(t0, t1)
            tf = np.maximum(t0, t1)
            t_near = tn.max(-1)
            t_far = tf.min(-1)
            hit = (t_near > 0.1) & (t_near < t_far) & (t_near < tmin)
            if not hit.any():
                continue
            p = origin[None, None, :] + dirs * t_near[..., None]
            # face axis = argmax slab entry; uv = the other two coords
            axis = tn.argmax(-1)
            nrm = np.zeros_like(p)
            np.put_along_axis(
                nrm, axis[..., None],
                -np.sign(np.take_along_axis(dirs, axis[..., None], -1)), -1)
            u_axis = (axis + 1) % 3
            v_axis = (axis + 2) % 3
            uu = np.take_along_axis(p, u_axis[..., None], -1)[..., 0]
            vv = np.take_along_axis(p, v_axis[..., None], -1)[..., 0]
            uv = np.stack([uu, vv], -1) * 0.9
            # per-pixel normals vary; shade with the per-pixel normal dot
            lam = np.clip(-(nrm @ self.light), 0.15, 1.0)
            tex = value_noise(uv[..., 0], uv[..., 1],
                              int(self.box_seed[b]))
            sh = (35.0 + 205.0 * tex) * (0.55 + 0.45 * lam)
            img = np.where(hit, sh, img)
            tmin = np.where(hit, t_near, tmin)

        # per-frame exposure wobble + sensor noise (seeded by frame no)
        nrng = np.random.default_rng(self.seed * 100003 + frame_no)
        gain = 1.0 + 0.03 * np.sin(0.7 * frame_no)
        img = img * gain + nrng.normal(0.0, noise_std, img.shape)
        return np.clip(img, 0, 255).astype(np.float32)


def orbit_arc_trajectory(n_frames: int, radius: float = 5.0,
                         arc: float = 0.5, height: float = -0.2):
    """Camera sweeping an arc of ``arc`` radians at ``radius`` from the
    scene center (0, 0, radius), always yawing to face it.  Returns
    (rvecs [N,3], tvecs [N,3]) in the x_cam = R x + t convention."""
    rvecs = np.zeros((n_frames, 3), np.float32)
    tvecs = np.zeros((n_frames, 3), np.float32)
    center = np.array([0.0, 0.0, radius])
    for i in range(n_frames):
        a = (i / max(n_frames - 1, 1) - 0.5) * arc
        cam_pos = center + radius * np.array(
            [np.sin(a), 0.0, -np.cos(a)]) + np.array([0.0, height, 0.0])
        yaw = np.arctan2(-np.sin(a) * radius,
                         radius * np.cos(a))  # look back at center
        R = _rot(np.array([0.0, -yaw, 0.0]))
        rvecs[i] = np.array([0.0, -yaw, 0.0], np.float32)
        tvecs[i] = (-R @ cam_pos).astype(np.float32)
    return rvecs, tvecs


def sim3_align(est_c: np.ndarray, gt_c: np.ndarray):
    """Umeyama sim(3): (s, R, t) with gt ~ s R est + t (own implementation
    — the validation path shares no evaluation code with the training
    renderers either)."""
    mu_e = est_c.mean(0)
    mu_g = gt_c.mean(0)
    E = est_c - mu_e
    G = gt_c - mu_g
    S = G.T @ E / len(est_c)
    U, D, Vt = np.linalg.svd(S)
    sgn = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        sgn[2, 2] = -1
    R = U @ sgn @ Vt
    var_e = (E ** 2).sum() / len(est_c)
    s = np.trace(np.diag(D) @ sgn) / max(var_e, 1e-12)
    t = mu_g - s * (R @ mu_e)
    return s, R, t


def sim3_ate(est_c: np.ndarray, gt_c: np.ndarray) -> float:
    """sim(3)-aligned RMS ATE."""
    s, R, t = sim3_align(est_c, gt_c)
    resid = gt_c - ((s * (R @ est_c.T)).T + t)
    return float(np.sqrt((resid ** 2).sum(1).mean()))
