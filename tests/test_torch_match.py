"""K1's plain version (the matcher the port runs on CPU tensors) against
the JAX package's XLA matcher and its Pallas kernel in interpret mode:
exact equality of mask, idx and dist (mirrors tests/test_match_pallas.py).
The CUDA kernel itself is held to the same plain version on the card by
chip_smoke.py and tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import match_case, noisy_copies, rand_desc, to_np, to_t

from sfm_tpu.features.match import match_features as jax_match
from sfm_tpu.features.match_pallas import match_features_pallas as jax_pallas
from sfm_tpu_torch.features.bits import pack_bits, unpack_bits
from sfm_tpu_torch.features.match_pallas import (hamming_match_plain,
                                                  match_features_pallas)


def _assert_same(out, ref):
    np.testing.assert_array_equal(to_np(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(to_np(out.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(to_np(out.dist), np.asarray(ref.dist))


def _run_all(case, pallas=True, **kw):
    """(port, XLA, Pallas-interpret) results on one numpy case."""
    d0, xy0, v0, d1, xy1, v1 = case
    centers = kw.pop("window_center0", None)
    jargs = [jnp.asarray(a) for a in case]
    jkw = dict(kw, window_center0=None if centers is None
               else jnp.asarray(centers))
    out = match_features_pallas(*[to_t(a) for a in case],
                                window_center0=None if centers is None
                                else to_t(centers), **kw)
    ref = jax_match(*jargs, **jkw)
    pal = jax_pallas(*jargs, interpret=True, **jkw) if pallas else None
    return out, ref, pal


@pytest.mark.parametrize("kw", [
    dict(min_radius=1.5, max_radius=60.0, max_distance=260.0, ratio=0.9),
    dict(min_radius=1.5, max_radius=40.0, max_distance=90.0, ratio=0.8),
], ids=["loose", "engine"])
def test_plain_equals_both_jax_matchers(kw):
    rng = np.random.default_rng(0)
    case = match_case(rng, 300, 128)
    out, ref, pal = _run_all(case, **kw)
    assert int(out.mask.sum()) > 20
    _assert_same(out, ref)
    _assert_same(out, pal)


def test_window_centers():
    rng = np.random.default_rng(1)
    case = match_case(rng, 257, 96)
    centers = (case[1] + rng.normal(0, 2, case[1].shape)).astype(np.float32)
    out, ref, pal = _run_all(case, min_radius=0.0, max_radius=30.0,
                             max_distance=260.0, ratio=0.85,
                             window_center0=centers)
    assert int(out.mask.sum()) > 10
    _assert_same(out, ref)
    _assert_same(out, pal)


def test_batched_equals_per_case():
    """The batched call (one launch on the card) is the counterpart of the
    JAX package's vmapped matcher."""
    rng = np.random.default_rng(2)
    cases = [match_case(rng, 300, 128) for _ in range(3)]
    kw = dict(min_radius=0.0, max_radius=80.0, max_distance=260.0, ratio=0.9)
    batch = [to_t(np.stack([c[i] for c in cases])) for i in range(6)]
    out = match_features_pallas(*batch, **kw)
    jbatch = [jnp.stack([jnp.asarray(c[i]) for c in cases]) for i in range(6)]
    pal = jax.vmap(lambda *a: jax_pallas(*a, interpret=True, **kw))(*jbatch)
    for b, c in enumerate(cases):
        ref = jax_match(*[jnp.asarray(a) for a in c], **kw)
        np.testing.assert_array_equal(to_np(out.mask[b]), np.asarray(ref.mask))
        np.testing.assert_array_equal(to_np(out.idx[b]), np.asarray(ref.idx))
        np.testing.assert_array_equal(to_np(out.mask[b]),
                                      np.asarray(pal.mask[b]))
        np.testing.assert_array_equal(to_np(out.idx[b]),
                                      np.asarray(pal.idx[b]))


def test_tie_goes_to_lowest_source_row():
    """Sources 2 and 5 are exact copies of target 3: the lower row wins
    the target; the second-best of a source with two equal targets equals
    its best, so the ratio test rejects it."""
    rng = np.random.default_rng(3)
    d1 = rng.integers(0, 2 ** 32, (8, 16), dtype=np.uint64).astype(np.uint32)
    d0 = rng.integers(0, 2 ** 32, (16, 16), dtype=np.uint64).astype(np.uint32)
    d0[2] = d0[5] = d1[3]
    d0[7] = d1[6]
    d1[1] = d1[6]          # source 7 has two equal best targets
    xy0, xy1 = np.zeros((16, 2), np.float32), np.zeros((8, 2), np.float32)
    case = (d0, xy0, np.ones(16, bool), d1, xy1, np.ones(8, bool))
    out, ref, pal = _run_all(case, max_distance=512.0, ratio=1.01)
    assert bool(out.mask[2]) and not bool(out.mask[5])
    assert int(out.idx[2]) == 3
    _assert_same(out, ref)
    _assert_same(out, pal)
    strict, ref_s, _ = _run_all(case, pallas=False, max_distance=512.0,
                                ratio=0.99)
    assert not bool(strict.mask[7])
    _assert_same(strict, ref_s)


def test_more_than_16384_sources():
    """The per-target key (dist << 32) | row stays exact past 16384 rows.
    Held against the XLA matcher only: the Pallas kernel's f32 key
    dist * 16384 + row orders (dist, row) correctly only below 16384."""
    rng = np.random.default_rng(4)
    case = match_case(rng, 17000, 48, extent=100.0, copy_p=0.02)
    out, ref, _ = _run_all(case, pallas=False, min_radius=0.0,
                           max_radius=20.0, max_distance=120.0, ratio=0.9)
    assert int(out.mask.sum()) > 5
    assert int(to_np(out.idx)[to_np(out.mask)].size) > 0
    assert (np.flatnonzero(to_np(out.mask)) >= 16384).any()
    _assert_same(out, ref)


def test_plain_kernel_outputs_are_consistent():
    """best/second/idx of the plain kernel version: best is the argmin
    value, second >= best, infeasible rows read 1e9."""
    rng = np.random.default_rng(5)
    d0, xy0, v0, d1, xy1, v1 = match_case(rng, 64, 32)
    t = [to_t(a)[None] for a in (d0, xy0, v0, d1, xy1, v1)]
    idx, best, second, keys = hamming_match_plain(*t, 0.0, 1e18, 90.0, 0.8)
    assert (second >= best).all()
    assert (best[0][~t[2][0]] == 1e9).all()
    assert keys.dtype == torch.int64 and keys.shape == (1, 32)


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(6)
    words = rng.integers(0, 2 ** 32, (5, 16), dtype=np.uint64).astype(
        np.uint32)
    bits = unpack_bits(to_t(words))
    assert bits.shape == (5, 512)
    ref = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    np.testing.assert_array_equal(to_np(bits), ref)
    np.testing.assert_array_equal(to_np(pack_bits(bits > 0)),
                                  words.view(np.int32))


# --- the epilogue, stride-0 operands and the cells route's rule ---------

from torch_port_util import cells_visit, f32_d2  # noqa: E402

from sfm_tpu_torch.features import match_pallas as mp  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(min_radius=1.5, max_radius=40.0, max_distance=90.0, ratio=0.8),
    dict(min_radius=0.0, max_radius=1e9, max_distance=260.0, ratio=0.9),
], ids=["window", "windowless"])
def test_plain_epilogue_equals_jax(kw):
    """hamming_match_plain's raw outputs through match_epilogue_plain (the
    contract the card's epilogue pass implements) give JAX's MatchResult."""
    rng = np.random.default_rng(7)
    case = match_case(rng, 300, 128)
    t = [to_t(a)[None] for a in case]
    f = mp._f32
    args = (*t, f(kw["min_radius"] ** 2), f(kw["max_radius"] ** 2),
            f(kw["max_distance"]), f(kw["ratio"]))
    raw = mp.hamming_match_plain(*args)
    idx, dist, mask = mp.match_epilogue_plain(*raw, t[2], args[8], args[9])
    for a, b in zip((idx, dist, mask), mp.match_result_plain(*args)):
        assert torch.equal(a, b)
    ref = jax_match(*[jnp.asarray(a) for a in case], **kw)
    pal = jax_pallas(*[jnp.asarray(a) for a in case], interpret=True, **kw)
    assert int(mask.sum()) > 20
    out = mp.MatchResult(idx[0], dist[0], mask[0])
    _assert_same(out, ref)
    _assert_same(out, pal)


@pytest.mark.parametrize("expanded", ["targets", "sources"])
def test_stride0_batch_operands(expanded):
    """An expanded batch operand (triangulation's new keyframe as targets,
    re-observation's landmark descriptors as sources) matches as the same
    operand copied, and as JAX's vmapped matchers per batch element."""
    rng = np.random.default_rng(8)
    B = 4
    one = match_case(rng, 200, 96)
    # each batch element permutes the side that is not expanded, so every
    # element has its own matches
    side = slice(0, 3) if expanded == "targets" else slice(3, 6)
    cases = []
    for _ in range(B):
        perm = rng.permutation(len(one[side.start]))
        moved = tuple(a[perm] for a in one[side])
        cases.append(moved + one[3:] if expanded == "targets"
                     else one[:3] + moved)
    if expanded == "targets":
        batch = [to_t(np.stack([c[i] for c in cases])) for i in range(3)] + [
            to_t(a)[None].expand(B, *a.shape) for a in one[3:]]
    else:
        batch = [to_t(a)[None].expand(B, *a.shape) for a in one[:3]] + [
            to_t(np.stack([c[i] for c in cases])) for i in range(3, 6)]
    assert batch[0 if expanded == "sources" else 3].stride(0) == 0
    kw = dict(min_radius=0.0, max_radius=60.0, max_distance=260.0, ratio=0.9)
    out = match_features_pallas(*batch, **kw)
    copied = match_features_pallas(*[t.contiguous() for t in batch], **kw)
    for a, b in zip(out, copied):
        assert torch.equal(a, b)
    jbatch = [jnp.stack([jnp.asarray(c[i]) for c in cases]) for i in range(6)]
    pal = jax.vmap(lambda *a: jax_pallas(*a, interpret=True, **kw))(*jbatch)
    for b, c in enumerate(cases):
        ref = jax_match(*[jnp.asarray(a) for a in c], **kw)
        _assert_same(mp.MatchResult(*(t[b] for t in out)), ref)
        np.testing.assert_array_equal(to_np(out.idx[b]), np.asarray(pal.idx[b]))
    assert int(out.mask.sum()) > 20


def test_cells_exact_boundary_pairs():
    """Pairs exactly on d2 == max_r2 in f32 (Pythagorean offsets), and
    targets on exact multiples of the cell side, are visited; a window
    spans at most 3 cells an axis at image coordinates."""
    for r, offs in ((5.0, [(3, 4), (-4, 3), (5, 0), (0, -5)]),
                    (2.5, [(1.5, 2.0), (-2.0, -1.5)]),
                    (7.0, [(7, 0), (0, 7)])):
        max_r2 = mp._f32(r * r)
        reach, inv = mp.window_geometry(max_r2)
        for base in (0.0, 1000.25, -333.5, 65536.0):
            for dx, dy in offs:
                c = (np.float32(base), np.float32(base + 1))
                t = (np.float32(c[0] + dx), np.float32(c[1] + dy))
                assert f32_d2(c, t) == max_r2
                assert cells_visit(c, t, max_r2)
        for k in range(-5, 20):
            edge = np.float32(k * reach)
            for t0 in (np.nextafter(edge, np.float32(-1e9)), edge,
                       np.nextafter(edge, np.float32(1e9))):
                c = (np.float32(t0 + r), np.float32(0.0))
                if f32_d2(c, (t0, 0.0)) <= max_r2:
                    assert cells_visit(c, (t0, 0.0), max_r2)
        xs = np.linspace(-100, 2000, 5001, dtype=np.float32)
        lo, hi = mp.window_cells(xs, reach, inv)
        assert (hi - lo).max() <= 2


def test_route_rule_on_the_engine_calls():
    """The engine's calls: re-observation (16 x 2048 sources in 7 px
    windows) takes the cells route; tracking (40 px) and widen_tracks
    (7 px), too few pairs to pay for binning, triangulation (120 px) and
    relocalization (radius 1e9) the dense one; more targets than shared
    memory holds, the dense integer route; an infinite window never the
    cells route."""
    f = mp._f32
    assert mp.k1_route(f(7.0 ** 2), 16, 2048, 512) == "cells"
    assert mp.k1_route(f(40.0 ** 2), 1, 512, 512) == "dense_int"
    assert mp.k1_route(f(7.0 ** 2), 1, 2048, 512) == "dense_int"
    assert mp.k1_route(f(120.0 ** 2), 9, 512, 512) == "dense_int"
    assert mp.k1_route(f(1e9 * 1e9), 1, 8192, 512) == "dense_int"
    assert mp.k1_route(f(7.0 ** 2), 16, 2048,
                       mp.MAX_SMEM_TARGETS + 1) == "dense_int"
    assert mp.k1_route(float("inf"), 16, 2048, 512) == "dense_int"
    assert mp._route_mode("dense_int", 1, 8192, f(1e9 * 1e9)) == 0
    assert mp._route_mode("dense_int", 9, 512, f(120.0 ** 2)) == 1


def test_hamming_matrix_and_pairwise_are_exact():
    from sfm_tpu.features import bits as jbits
    from sfm_tpu_torch.features import bits
    rng = np.random.default_rng(8)
    a, b = rand_desc(rng, 70), rand_desc(rng, 45)
    b[:10] = noisy_copies(rng, a, np.arange(10))
    b[10] = a[11]                                    # distance 0
    b[11] = ~a[12]                                   # distance 512
    D = bits.hamming_matrix(to_t(a), to_t(b))
    assert D.dtype == torch.float32 and D.shape == (70, 45)
    np.testing.assert_array_equal(
        to_np(D), np.asarray(jbits.hamming_matrix(jnp.asarray(a),
                                                  jnp.asarray(b))))
    assert float(D[11, 10]) == 0.0 and float(D[12, 11]) == 512.0
    pw = bits.hamming_pairwise(to_t(a[:45]), to_t(b))
    assert pw.dtype == torch.float32
    np.testing.assert_array_equal(
        to_np(pw), np.asarray(jbits.hamming_pairwise(jnp.asarray(a[:45]),
                                                     jnp.asarray(b))))
    np.testing.assert_array_equal(to_np(pw), np.diagonal(to_np(D)))


def _jax_pairs(res, cap):
    from sfm_tpu.features import match as jmatch
    return jmatch.match_pairs(jmatch.MatchResult(
        *[jnp.asarray(to_np(t)) for t in res]), cap)


@pytest.mark.parametrize("cap", [512, 40, 7], ids=["room", "overflow",
                                                    "tight"])
def test_match_pairs_is_exact(cap):
    """match_pairs on one MatchResult fed to both packages, with caps that
    hold every match and that the matches overflow; the MatchResult comes
    from the port's own matcher (K1's plain version here, the kernel on the
    card in chip_smoke.py)."""
    from sfm_tpu_torch.features.match import MatchResult, match_pairs
    rng = np.random.default_rng(9)
    case = match_case(rng, 300, 128)
    res = match_features_pallas(*[to_t(a) for a in case], min_radius=1.5,
                                max_radius=60.0, max_distance=260.0,
                                ratio=0.9)
    n = int(res.mask.sum())
    assert n > 40 if cap != 512 else n > 20
    ours = match_pairs(res, cap)
    for a, b in zip(ours, _jax_pairs(res, cap)):
        assert to_np(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    idx0, idx1, valid = ours
    assert int(valid.sum()) == min(n, cap) and len(valid) == min(cap, 300)
    rows = np.nonzero(to_np(res.mask))[0][:cap]
    np.testing.assert_array_equal(to_np(idx0)[:len(rows)], rows)
    np.testing.assert_array_equal(to_np(idx1)[:len(rows)],
                                  to_np(res.idx)[rows])
    # a result with no match
    empty = MatchResult(torch.full((5,), -1, dtype=torch.int32),
                        torch.full((5,), 1e9), torch.zeros(5, dtype=bool))
    for a, b in zip(match_pairs(empty, 3), _jax_pairs(empty, 3)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
