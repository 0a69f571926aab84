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

from torch_port_util import match_case, to_np, to_t

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
