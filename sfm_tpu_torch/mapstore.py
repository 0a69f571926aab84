"""World state: per-frame feature records, keyframe SoA, landmark SoA.

- ``Frame``: fixed-capacity keypoint arrays, pose, and the 2D->3D link
  vector (``landmark``, -1 = unlinked).
- ``KeyframeStore``: a stacked Frame (every field has a leading keyframe
  axis) with a validity mask; slots are reused after culling.
- ``LandmarkStore``: landmark ids are slot indices; culling tombstones the
  slot and the engine clears every keyframe link to it.

The keyframes' link arrays are the only record of observations.
Representative descriptors use per-bit saturating vote counters (int8,
+1 per set bit, -1 per clear bit, clipped to +-127; majority = sign).

Scatters that the JAX package writes with an out-of-range index and
``mode="drop"`` write here into a padded copy whose last row takes the
dropped entries and is sliced off (``_set_drop``).  The float colour sums
run in a fixed order (``utils.rowsum.add_rows``: no atomics on the card);
the integer counters use ``index_add``, which is exact."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .features.bits import pack_bits, unpack_bits
from .utils.profiling import count
from .utils.rowsum import add_rows


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


class _Tree:
    """Mixin for dataclasses of tensors: ``replace`` and ``map``."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn, *others):
        return type(self)(**{n: fn(getattr(self, n),
                                   *(getattr(o, n) for o in others))
                             for n in _fields(self)})


def tree_map(fn, tree, *others):
    """``fn`` over the tensor leaves of nested ``_Tree`` dataclasses (the
    counterpart of ``jax.tree.map`` on the JAX package's state)."""
    if isinstance(tree, _Tree):
        return tree.map(lambda *xs: tree_map(fn, *xs), *others)
    return fn(tree, *others)


@dataclasses.dataclass
class Frame(_Tree):
    """Per-frame record.  Capacity N keypoints."""
    xy: torch.Tensor        # [N, 2] f32 undistorted pixels (Kopt model)
    xy_dist: torch.Tensor   # [N, 2] f32 raw detector coords
    desc: torch.Tensor      # [N, W] int32 packed descriptors
    color: torch.Tensor     # [N, 3] f32 sampled image colour
    level: torch.Tensor     # [N] int32 pyramid level
    score: torch.Tensor     # [N] f32 detector response
    kp_valid: torch.Tensor  # [N] bool
    landmark: torch.Tensor  # [N] int32 landmark slot or -1
    rvec: torch.Tensor      # [3] world-to-camera rotation (Rodrigues)
    tvec: torch.Tensor      # [3]
    frame_no: torch.Tensor  # [] int32

    @property
    def matched(self) -> torch.Tensor:
        """[N] bool: the keypoint is linked to a landmark."""
        return self.landmark >= 0

    @property
    def n_matched(self) -> torch.Tensor:
        """[] int64: valid keypoints linked to a landmark."""
        return torch.sum(self.matched & self.kp_valid)


def empty_frame(n_kp: int, desc_words: int, device) -> Frame:
    f32, i32 = torch.float32, torch.int32
    count("implicit_sync")  # frame_no's blocking copy to the card
    return Frame(
        xy=torch.zeros((n_kp, 2), dtype=f32, device=device),
        xy_dist=torch.zeros((n_kp, 2), dtype=f32, device=device),
        desc=torch.zeros((n_kp, desc_words), dtype=i32, device=device),
        color=torch.zeros((n_kp, 3), dtype=f32, device=device),
        level=torch.zeros((n_kp,), dtype=i32, device=device),
        score=torch.zeros((n_kp,), dtype=f32, device=device),
        kp_valid=torch.zeros((n_kp,), dtype=torch.bool, device=device),
        landmark=torch.full((n_kp,), -1, dtype=i32, device=device),
        rvec=torch.zeros((3,), dtype=f32, device=device),
        tvec=torch.zeros((3,), dtype=f32, device=device),
        frame_no=torch.tensor(-1, dtype=i32, device=device),
    )


@dataclasses.dataclass
class KeyframeStore(_Tree):
    frames: Frame           # every field has leading axis K
    valid: torch.Tensor     # [K] bool

    def frame(self, slot) -> Frame:
        """The Frame stored in ``slot`` (int or 0-dim tensor)."""
        if torch.is_tensor(slot):
            # an index by a tensor reads it: once for each field
            count("implicit_sync", len(dataclasses.fields(self.frames)))
        return self.frames.map(lambda x: x[slot])


def empty_keyframes(k: int, n_kp: int, desc_words: int, device
                    ) -> KeyframeStore:
    proto = empty_frame(n_kp, desc_words, device)
    frames = proto.map(lambda x: x.expand((k,) + x.shape).clone())
    return KeyframeStore(frames=frames,
                         valid=torch.zeros((k,), dtype=torch.bool,
                                           device=device))


@dataclasses.dataclass
class LandmarkStore(_Tree):
    xyz: torch.Tensor         # [L, 3] f32
    desc_votes: torch.Tensor  # [L, B] int8 saturating bit-majority votes
    color_sum: torch.Tensor   # [L, 3] f32 running observed-colour sum
    n_desc: torch.Tensor      # [L] int32 descriptors accumulated
    n_views: torch.Tensor     # [L] int32 tracked-frame views
    kf_alive: torch.Tensor    # [L] int32 age in keyframes
    t_alive: torch.Tensor     # [L] int32 age in frames
    valid: torch.Tensor       # [L] bool


def empty_landmarks(l: int, desc_bits: int, device) -> LandmarkStore:
    i32 = torch.int32
    return LandmarkStore(
        xyz=torch.zeros((l, 3), dtype=torch.float32, device=device),
        desc_votes=torch.zeros((l, desc_bits), dtype=torch.int8,
                               device=device),
        color_sum=torch.zeros((l, 3), dtype=torch.float32, device=device),
        n_desc=torch.zeros((l,), dtype=i32, device=device),
        n_views=torch.zeros((l,), dtype=i32, device=device),
        kf_alive=torch.zeros((l,), dtype=i32, device=device),
        t_alive=torch.zeros((l,), dtype=i32, device=device),
        valid=torch.zeros((l,), dtype=torch.bool, device=device),
    )


def _offsets(lead, rows: int, device) -> torch.Tensor:
    """[..., 1] offset of each scan's first row when a fleet's [..., rows,
    ...] tensor is flattened to rows; [0] for a single scan."""
    n = math.prod(lead)
    return (torch.arange(n, device=device) * rows).reshape(*lead, 1)


def _set_drop(t: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Out-of-place ``t[idx] = vals`` where rows with idx == len(t) are
    dropped (written into a sentinel row that is sliced off).  A fleet
    passes t [B, L, ...] with idx [B, M] (and vals [B, M, ...]): each scan
    writes its own rows, with one sentinel row per scan, so a write of
    scan b never lands in another scan."""
    lead = tuple(idx.shape[:-1])
    nb = len(lead)
    L, rows = t.shape[nb], tuple(t.shape[nb + 1:])
    pad = torch.cat([t, t.new_zeros(lead + (1,) + rows)], dim=nb)
    flat = pad.reshape((-1,) + rows)
    fidx = idx.to(torch.int64) + _offsets(lead, L + 1, t.device)
    if not torch.is_tensor(vals) or vals.device != t.device:
        count("implicit_sync")  # vals copied to the card
    v = torch.as_tensor(vals, device=t.device).to(t.dtype)
    flat[fidx.reshape(-1)] = v.expand(tuple(idx.shape) + rows).reshape(
        (-1,) + rows)
    return pad.narrow(nb, 0, L)


# ---------------------------------------------------------------------------
# landmark ops
# ---------------------------------------------------------------------------

def allocate_slots(free: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """For each requested entry (want[..., j]) a distinct free slot, or -1
    on overflow; free slots [..., S] are handed out in index order (per
    scan for a fleet's leading axis)."""
    order = torch.sort((~free).to(torch.int32), dim=-1, stable=True).indices
    n_free = free.sum(-1, keepdim=True)
    rank = torch.cumsum(want.to(torch.int64), -1) - 1
    slot = torch.take_along_dim(order, torch.clamp(rank, 0,
                                                   free.shape[-1] - 1), -1)
    ok = want & (rank < n_free)
    return torch.where(ok, slot, -1).to(torch.int32)


def _votes(desc: torch.Tensor) -> torch.Tensor:
    return (2 * unpack_bits(desc, torch.int32) - 1).to(torch.int8)


def add_landmarks(lms: LandmarkStore, xyz, desc, want, n_initial_views,
                  colors=None) -> Tuple[LandmarkStore, torch.Tensor]:
    """Bulk append.  xyz [M, 3], desc [M, W], want [M] bool,
    n_initial_views [M] int.  Returns (store, ids [M], -1 where dropped)."""
    ids = allocate_slots(~lms.valid, want)
    L = lms.valid.shape[0]
    idx = torch.where(ids >= 0, ids, L)
    if colors is None:
        colors = torch.zeros_like(xyz)
    new = LandmarkStore(
        xyz=_set_drop(lms.xyz, idx, xyz),
        desc_votes=_set_drop(lms.desc_votes, idx, _votes(desc)),
        color_sum=_set_drop(lms.color_sum, idx, colors),
        n_desc=_set_drop(lms.n_desc, idx, 1),
        n_views=_set_drop(lms.n_views, idx,
                          n_initial_views.to(torch.int32)),
        kf_alive=_set_drop(lms.kf_alive, idx, 0),
        t_alive=_set_drop(lms.t_alive, idx, 0),
        valid=_set_drop(lms.valid, idx, True),
    )
    return new, ids


def _flat_ids(ids: torch.Tensor, n_rows: int):
    """(ok, flat row index) of landmark ids [..., M] (-1 = none) into a
    store flattened over its leading scan axes."""
    ok = ids >= 0
    safe = torch.where(ok, ids, 0).to(torch.int64)
    return ok, (safe + _offsets(ids.shape[:-1], n_rows, ids.device)
                ).reshape(-1)


def add_descriptors(lms: LandmarkStore, ids, desc, colors=None
                    ) -> LandmarkStore:
    """Stack one observed descriptor (and colour sample) per id >= 0:
    saturating vote accumulation, clipped to the int8 range.  ids [..., M]
    with desc [..., M, W] (a fleet's leading scan axis included)."""
    L = lms.valid.shape[-1]
    ok, flat = _flat_ids(ids, L)
    okf = ok.reshape(-1)
    votes = _votes(desc).to(torch.int32).reshape(okf.shape[0], -1) \
        * okf[:, None].to(torch.int32)
    dv = lms.desc_votes
    acc = dv.to(torch.int32).reshape(-1, dv.shape[-1]).index_add(0, flat,
                                                                  votes)
    out = lms.replace(
        desc_votes=torch.clamp(acc, -127, 127).to(torch.int8).reshape(
            dv.shape),
        n_desc=lms.n_desc.reshape(-1).index_add(
            0, flat, okf.to(torch.int32)).reshape(lms.n_desc.shape))
    if colors is not None:
        cs = out.color_sum
        out = out.replace(color_sum=add_rows(
            cs.reshape(-1, 3), flat,
            colors.reshape(-1, 3) * okf[:, None]).reshape(cs.shape))
    return out


def landmark_colors(lms: LandmarkStore) -> torch.Tensor:
    """[L, 3] mean observed colour per landmark."""
    return lms.color_sum / torch.clamp(lms.n_desc[:, None], min=1).to(
        torch.float32)


def add_views(lms: LandmarkStore, ids) -> LandmarkStore:
    """Bump the tracked-view count of every id >= 0 (ids [..., M])."""
    ok, flat = _flat_ids(ids, lms.valid.shape[-1])
    nv = lms.n_views
    return lms.replace(n_views=nv.reshape(-1).index_add(
        0, flat, ok.reshape(-1).to(torch.int32)).reshape(nv.shape))


def representative_descriptors(lms: LandmarkStore) -> torch.Tensor:
    """Per-landmark majority-vote descriptor [L, W] int32."""
    return pack_bits(lms.desc_votes > 0)


def increment_age(lms: LandmarkStore, t_inc, kf_inc) -> LandmarkStore:
    """Age every live landmark by ``t_inc`` frames and ``kf_inc``
    keyframes (ints, or per-scan tensors [B, 1] for a fleet)."""
    live = lms.valid.to(torch.int32)
    return lms.replace(t_alive=lms.t_alive + t_inc * live,
                       kf_alive=lms.kf_alive + kf_inc * live)


def _view_counts(links, obs, n_landmarks: int) -> torch.Tensor:
    flat = torch.where(obs, links, n_landmarks).reshape(-1).to(torch.int64)
    counts = torch.zeros(n_landmarks + 1, dtype=torch.int32,
                         device=links.device)
    return counts.index_add(0, flat, torch.ones_like(flat, dtype=torch.int32)
                            )[:n_landmarks]


def kf_view_counts(kfs: KeyframeStore, n_landmarks: int) -> torch.Tensor:
    """[L] number of valid keyframes observing each landmark."""
    links = kfs.frames.landmark
    obs = (links >= 0) & kfs.frames.kp_valid & kfs.valid[:, None]
    return _view_counts(links, obs, n_landmarks)


def cull_landmarks(lms: LandmarkStore, kf_views, *, min_views: int = 3,
                   young_age: int = 3, view_ratio: float = 0.25
                   ) -> Tuple[LandmarkStore, torch.Tensor]:
    """Young landmarks (1 <= kf_alive <= young_age) go when their
    tracked-view ratio n_views / t_alive < view_ratio or fewer than
    min_views keyframes see them; older ones when fewer than min_views
    keyframes see them.  Returns (store, tombstone mask [L])."""
    ratio = lms.n_views.to(torch.float32) / torch.clamp(
        lms.t_alive.to(torch.float32), min=1.0)
    young = (lms.kf_alive >= 1) & (lms.kf_alive <= young_age)
    old = lms.kf_alive > young_age
    few_kf = kf_views < min_views
    cull = ((young & ((ratio < view_ratio) | few_kf)) | (old & few_kf)) \
        & lms.valid
    return lms.replace(valid=lms.valid & ~cull), cull


def clear_links(frame_landmark, tomb) -> torch.Tensor:
    """Unlink culled landmarks from link vectors [..., N]."""
    linked = frame_landmark >= 0
    safe = torch.where(linked, frame_landmark, 0).to(torch.int64)
    dead = tomb[safe] & linked
    return torch.where(dead, -1, frame_landmark)


# ---------------------------------------------------------------------------
# keyframe ops
# ---------------------------------------------------------------------------

def insert_keyframe(kfs: KeyframeStore, frame: Frame, want=None
                    ) -> Tuple[KeyframeStore, torch.Tensor]:
    """Snapshot a frame into the first free slot.  Returns (store, slot)
    with slot == -1 when the store is full.  A fleet passes stores with
    [B, K] valid masks and a Frame with [B, ...] leaves, and ``want`` [B]:
    the scans that insert (slot -1 for the others, whose stores are
    unchanged)."""
    lead = tuple(kfs.valid.shape[:-1])
    K = kfs.valid.shape[-1]
    dev = kfs.valid.device
    if want is None:
        want = torch.ones(lead, dtype=torch.bool, device=dev)
    slot = allocate_slots(~kfs.valid, want[..., None])[..., 0]
    ok = (slot >= 0).reshape(-1)
    fidx = (torch.where(slot >= 0, slot, 0).to(torch.int64)[..., None]
            + _offsets(lead, K, dev)).reshape(-1)

    def put(stored, new):
        rest = tuple(stored.shape[len(lead) + 1:])
        flat = stored.reshape((-1,) + rest)
        keep = ok.reshape((-1,) + (1,) * len(rest))
        val = torch.where(keep, new.reshape((-1,) + rest).to(stored.dtype),
                          flat[fidx])
        return flat.index_copy(0, fidx, val).reshape(stored.shape)

    frames = kfs.frames.map(put, frame)
    valid = put(kfs.valid, torch.ones(lead, dtype=torch.bool, device=dev))
    return KeyframeStore(frames=frames, valid=valid), slot


def remove_keyframe(kfs: KeyframeStore, slot) -> KeyframeStore:
    """Drop the keyframe in ``slot`` (an int or a [] tensor; outside [0, K)
    nothing changes).  Observations derive from the link matrix, so
    invalidating the slot removes its observations everywhere at once;
    the landmarks' descriptor votes keep its contribution, as in the JAX
    package (a deliberate approximation)."""
    K = kfs.valid.shape[-1]
    dev = kfs.valid.device
    hit = torch.arange(K, device=dev) == torch.as_tensor(slot, device=dev)
    return kfs.replace(valid=kfs.valid & ~hit)


def cull_keyframes(kfs: KeyframeStore, n_landmarks: int, *,
                   redundancy: float = 0.9, min_others: int = 3,
                   keep_first: int = 2
                   ) -> Tuple[KeyframeStore, torch.Tensor]:
    """Greedy oldest-first removal of keyframes >= ``redundancy`` of whose
    tracked points are seen by > ``min_others`` other keyframes; the first
    ``keep_first`` in frame order (the bootstrap pair) are exempt.  View
    counts are updated as keyframes go, so later decisions see earlier
    removals."""
    K = kfs.valid.shape[0]
    fr = kfs.frames
    order = torch.sort(torch.where(kfs.valid, fr.frame_no, 2 ** 30),
                       stable=True).indices
    links = fr.landmark
    obs_all = (links >= 0) & fr.kp_valid
    counts = _view_counts(links, obs_all & kfs.valid[:, None], n_landmarks)
    counts = torch.cat([counts, counts.new_zeros(1)])
    valid = kfs.valid.clone()
    culled = torch.zeros(K, dtype=torch.bool, device=valid.device)
    for i in range(K):
        # six reads of the card's values an iteration: the index k in
        # links[k], obs_all[k] and valid[k] twice, and the two stores
        count("implicit_sync", 6)
        k = order[i]
        lk = links[k]
        obs = obs_all[k]
        safe = torch.where(obs, lk, 0).to(torch.int64)
        redundant = obs & (counts[safe] - 1 > min_others)
        n_obs = obs.sum()
        frac = redundant.sum() / torch.clamp(n_obs, min=1)
        cull = valid[k] & (frac >= redundancy) & (n_obs > 0)
        if i < keep_first:
            cull = cull & False
        dec = torch.where(obs & cull, lk, n_landmarks).to(torch.int64)
        counts = counts.index_add(0, dec, torch.full_like(
            dec, -1, dtype=torch.int32))
        counts[n_landmarks] = 0
        valid[k] = valid[k] & ~cull
        culled[i] = cull
    return kfs.replace(valid=valid), culled
