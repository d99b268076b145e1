"""The hand kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode: these tests carry the ``cuda`` marker and skip
where no CUDA device is visible. Run them on a machine with an H100:
``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt.boost import _preround
from synapseml_tpu_torch.gbdt.device_predict import SCORE_KERNEL, device_raw_scores, raw_scores_plain
from synapseml_tpu_torch.gbdt.histogram import HIST_KERNEL, histogram, histogram_plain
from synapseml_tpu_torch.parallel.flash import FLASH_KERNEL, dense_attention, flash_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,n_bins,d", [(torch.int8, 64, 28), (torch.int16, 256, 28),
                                            (torch.int32, 4096, 30)])
def test_histogram_kernel_bit_equal_on_prerounded_panel(cuda, dtype, n_bins, d):
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 100_003
    binned = torch.randint(0, n_bins, (n, d), generator=g).to(dtype).to(cuda)
    gh = _preround(torch.randn(n, 2, generator=g), 1 << 17).to(cuda)
    grad, hess = gh[:, 0].contiguous(), gh[:, 1].contiguous()
    weight = (torch.rand(n, generator=g) < 0.6).to(torch.float32).to(cuda)
    before = HIST_KERNEL.launches
    out = histogram(binned, grad, hess, weight, n_bins)
    torch.cuda.synchronize()
    assert HIST_KERNEL.launches == before + 1
    torch.testing.assert_close(out, histogram_plain(binned, grad, hess, weight, n_bins),
                               rtol=0, atol=0)


def test_score_kernel_bit_equal(cuda):
    g = torch.Generator(device="cpu").manual_seed(1)
    n, d, T, S = 50_001, 28, 12, 30
    binned = torch.randint(0, 64, (n, d), generator=g).to(torch.int8).to(cuda)
    parent = torch.stack([torch.stack([torch.randint(-1, s + 1, (1,), generator=g)[0]
                                       for s in range(S)]) for _ in range(T)])[:, None]
    feature = torch.randint(0, d, (T, 1, S), generator=g)
    bins = torch.randint(0, 63, (T, 1, S), generator=g)
    leaf = torch.randn(T, 1, S + 1, generator=g)
    scale = np.full(T, 0.1)
    before = SCORE_KERNEL.launches
    out = device_raw_scores(binned, parent, feature, bins, leaf, scale)
    torch.cuda.synchronize()
    assert SCORE_KERNEL.launches == before + 1
    ref = raw_scores_plain(binned, parent.to(cuda).int(), feature.to(cuda).int(),
                           bins.to(cuda).int(), leaf.to(cuda),
                           torch.tensor(scale, dtype=torch.float32, device=cuda))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", [(2, 300, 300, 4, 2, 64), (1, 128, 512, 8, 8, 128),
                                   (2, 257, 257, 2, 1, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, dtype, tol, shape, causal):
    B, Sq, Sk, H, Hkv, D = shape
    g = torch.Generator(device="cpu").manual_seed(2)
    q = torch.randn(B, Sq, H, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Sk, Hkv, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Sk, Hkv, D, generator=g).to(dtype).to(cuda)
    before = FLASH_KERNEL.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_KERNEL.launches == before + 1
    ref = dense_attention(q.float(), k.float(), v.float(), causal=causal)
    assert float((out.float() - ref).abs().max()) <= tol
    if dtype == torch.bfloat16:
        # per-row error against the plain version with bf16 P@V: one skipped
        # key tile of 64 moves a row of <= 512 keys by > 0.3, rounding by ~2e-3
        ref = dense_attention(q, k, v, causal=causal, pv_dtype=torch.bfloat16).float()
        rel = (out.float() - ref).norm(dim=-1) / ref.norm(dim=-1)
        assert float(rel.max()) <= 1e-2
