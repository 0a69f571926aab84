"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU (and nvcc) every test here skips
with a reason.  On a GPU machine run them with
``python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest``
(``tests/conftest.py`` imports JAX, which a GPU machine need not have);
chip_smoke.py repeats the same comparisons at the main path's full
shapes."""

import numpy as np
import pytest
import torch

from torch_port_util import match_case, to_t

from sfm_tpu_torch import native
from sfm_tpu_torch.features import match_pallas as mp
from sfm_tpu_torch.features import patches_pallas as pp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    native.library()
    return torch.device("cuda")


@pytest.mark.parametrize("B,ns,nt,centers", [
    (1, 512, 512, False), (1, 2048, 512, True), (9, 512, 512, False),
    (2, 17000, 64, False)])
def test_hamming_kernel_equals_plain(cuda, B, ns, nt, centers):
    rng = np.random.default_rng(ns + B)
    cases = [match_case(rng, ns, nt) for _ in range(B)]
    t = [to_t(np.stack([c[i] for c in cases])).to(cuda) for i in range(6)]
    if centers:
        t[1] = t[1] + 1.5
    args = (*t, 1.5 ** 2, 40.0 ** 2, 120.0, 0.9)
    n0 = native.LAUNCHES["hamming_match"]
    out = mp.hamming_match_kernel(*args)
    ref = mp.hamming_match_plain(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hamming_match"] == n0 + 1
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_patch_kernel_equals_plain(cuda):
    rng = np.random.default_rng(0)
    canvas = to_t(rng.uniform(0, 255, (480, 1200)).astype(np.float32)).to(cuda)
    cx = to_t(rng.uniform(-20, 1220, 512).astype(np.float32)).to(cuda)
    cy = to_t(rng.uniform(-20, 500, 512).astype(np.float32)).to(cuda)
    out = pp.extract_patches_kernel(canvas, cx, cy)
    ref = pp.extract_patches_plain(canvas, cx, cy)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-3


def test_wrappers_refuse_bad_input(cuda):
    canvas = torch.zeros((8, 8), device=cuda)
    cx = torch.zeros(4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        pp.extract_patches_kernel(canvas, cx, cx)
    with pytest.raises(ValueError):
        pp.extract_patches_kernel(canvas.t(), cx.float(), cx.float())
