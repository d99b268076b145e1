"""Port parity: the gradient histogram (kernel A's plain version) against the
JAX package's scatter histogram, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt.boost import _preround as jax_preround
from synapseml_tpu.gbdt.histogram import histogram as jax_histogram
from synapseml_tpu_torch.gbdt.boost import _preround
from synapseml_tpu_torch.gbdt.histogram import histogram


def _inputs(seed, n, d, n_bins, dtype):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, size=(n, d)).astype(dtype)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, size=n).astype(np.float32)
    w = (rng.uniform(size=n) < 0.7).astype(np.float32)
    return binned, g, h, w


@pytest.mark.parametrize("dtype,n_bins", [(np.int8, 64), (np.int16, 256)])
def test_histogram_exact_on_prerounded_gradients(dtype, n_bins):
    """Pre-rounded gradients make every cell exact in any order: the port's
    histogram equals the reference's bit for bit."""
    binned, g, h, w = _inputs(1, 3000, 5, n_bins, dtype)
    n_bound = 4096
    gj = np.asarray(jax_preround(jnp.asarray(g)[:, None], n_bound, None))[:, 0]
    hj = np.asarray(jax_preround(jnp.asarray(h)[:, None], n_bound, None))[:, 0]
    gt = _preround(torch.from_numpy(g)[:, None], n_bound)[:, 0]
    ht = _preround(torch.from_numpy(h)[:, None], n_bound)[:, 0]
    np.testing.assert_array_equal(gt.numpy(), gj)
    np.testing.assert_array_equal(ht.numpy(), hj)
    ref = np.asarray(jax_histogram(jnp.asarray(binned), jnp.asarray(gj), jnp.asarray(hj),
                                   jnp.asarray(w), n_bins, method="scatter"))
    out = histogram(torch.from_numpy(binned), gt, ht, torch.from_numpy(w), n_bins)
    assert out.shape == (5, n_bins, 3) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype,n_bins", [(np.int8, 64), (np.int16, 256)])
def test_histogram_raw_gradients_within_rounding(dtype, n_bins):
    """Raw gradients: sums in another order agree to float rounding (rtol 1e-6,
    with an absolute floor of 1e-6 times the cell scale for cells that cancel)."""
    binned, g, h, w = _inputs(2, 2000, 4, n_bins, dtype)
    ref = np.asarray(jax_histogram(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
                                   jnp.asarray(w), n_bins, method="scatter"))
    out = histogram(torch.from_numpy(binned), torch.from_numpy(g), torch.from_numpy(h),
                    torch.from_numpy(w), n_bins).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_histogram_panel_checks_inputs():
    b = torch.zeros(4, 2, dtype=torch.int8)
    v = torch.zeros(4)
    with pytest.raises(TypeError, match="int8/int16/int32"):
        histogram(b.float(), v, v, v, 8)
    with pytest.raises(TypeError, match="float32"):
        histogram(b, v, v, torch.zeros(4, 1), 8)
    with pytest.raises(TypeError, match="float32"):
        histogram(b, v.double(), v, v, 8)
    with pytest.raises(ValueError, match="shared memory"):
        histogram(b, v, v, v, 100_000)
