"""Kernel L's arithmetic order against the plain version and the JAX
reference, on the CPU.

Kernel L (``csrc/lasso_cd.cu``) runs the lasso's coordinate descent with
covariance updates: each fit keeps c = Xty - G beta and updates it by row j
of the Gram matrix where a step moves beta_j, skipping the update where
the step leaves beta_j exactly where it was.
``tools/kernel_cases.py::lasso_cd_order`` is that order in torch f32, step
for step (the card tests hold the kernel to it bit for bit). Here it is
held to

- ``lasso_cd_plain`` (the reference's order: a fresh dot ``gram[j] @ beta``
  each step) within ``LASSO_TOL`` of max(1, max|beta|), with the same zero
  coefficients: the two sum the same terms in another order, and c carries
  the rounding of every update since the first sweep;
- the JAX package's ``fit_regression_batch`` (alpha 0.01) within
  ``REG_TOL`` of the coefficients' scale, as ``test_torch_explainers.py``
  holds the port's plain path.

``lasso_case`` keeps every |rho| far from lam, so rounding moves no
coefficient between 0 and non-zero.
"""

import numpy as np
import pytest
import torch

import synapseml_tpu.explainers as R
from synapseml_tpu_torch.explainers import regression as reg
from synapseml_tpu_torch.tools.kernel_cases import lasso_case, lasso_cd_order
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REG_TOL = 1e-4
ALPHA, M, N_INSTANCES = 0.01, 1000, 2


def _system(X, Y, w):
    Xt, Yt, wt = (torch.from_numpy(np.asarray(a, np.float32)) for a in (X, Y, w))
    *_, Xr, Yr = reg.rescaled(Xt, Yt, wt)
    return reg.lasso_system(Xr, Yr)


def _within(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, tol * scale)
    assert torch.equal(got == 0, want == 0)
    return err


@pytest.mark.parametrize("max_iter", [100, 500])
@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("k", [8, 32, 200])
def test_covariance_order_matches_plain_and_reference(k, t, max_iter):
    X, Y, w = lasso_case(k + t, N_INSTANCES, M, k, t)
    gram, xty, sq = _system(X, Y, w)
    lam = ALPHA * M
    got = lasso_cd_order(gram, xty, sq, lam, max_iter)
    _within(got, reg.lasso_cd_plain(gram, xty, sq, lam, max_iter), reg.LASSO_TOL)
    ref = R.fit_regression_batch(X, Y, w, alpha=ALPHA, max_iter=max_iter).coefficients
    _within(got, torch.from_numpy(np.asarray(ref, np.float32)), REG_TOL)


@pytest.mark.parametrize("k", [8, 40])
def test_row_order_past_the_smem_limit_matches_plain(k):
    """The path past ``lasso_smem_k()`` updates c by row j as it lies (not
    the upper triangle): the same within ``LASSO_TOL``."""
    gram, xty, sq = _system(*lasso_case(11 + k, N_INSTANCES, 600, k, 2))
    lam = ALPHA * 600
    got = lasso_cd_order(gram, xty, sq, lam, 60, triangle=False)
    _within(got, reg.lasso_cd_plain(gram, xty, sq, lam, 60), reg.LASSO_TOL)
    tri = lasso_cd_order(gram, xty, sq, lam, 60)
    _within(got, tri, reg.LASSO_TOL)


@pytest.mark.parametrize("triangle", [True, False], ids=["triangle", "rows"])
def test_covariance_order_edge_cases(triangle):
    """No sweep, lam above every |rho|, a zero-variance column: as the plain
    version gives them."""
    gram, xty, sq = _system(*lasso_case(3, 3, 300, 40, 3))
    sq[1, 5] = 0.0
    got = lasso_cd_order(gram, xty, sq, 3.0, 7, triangle)
    assert (got[1, :, 5] == 0).all()
    _within(got, reg.lasso_cd_plain(gram, xty, sq, 3.0, 7), reg.LASSO_TOL)
    assert (lasso_cd_order(gram, xty, sq, 3.0, 0, triangle) == 0).all()
    assert (lasso_cd_order(gram, xty, sq, 1e12, 3, triangle) == 0).all()


@pytest.mark.parametrize("where", ["off_diagonal", "diagonal", "one_sided", "inf"])
@pytest.mark.parametrize("max_iter", [1, 4])
def test_non_finite_gram_gives_nan_where_plain_does(where, max_iter):
    """A NaN (or an infinity) in one instance's Gram matrix: NaN in that
    instance's fits wherever the plain version has NaN, its other
    coefficients within ``LASSO_TOL``, and the other instances unchanged."""
    gram, xty, sq = _system(*lasso_case(5, 3, 400, 12, 2))
    lam = ALPHA * 400
    clean = lasso_cd_order(gram, xty, sq, lam, max_iter)
    bad = {"off_diagonal": [(3, 7), (7, 3)], "diagonal": [(4, 4)], "one_sided": [(9, 2)],
           "inf": [(3, 7), (7, 3)]}[where]
    for i, j in bad:
        gram[1, i, j] = float("inf") if where == "inf" else float("nan")
    sq[1, 6] = 0.0
    got = lasso_cd_order(gram, xty, sq, lam, max_iter)
    want = reg.lasso_cd_plain(gram, xty, sq, lam, max_iter)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[1]).any() and (got[1, :, 6] == 0).all()
    live = ~torch.isnan(want)
    _within(got[live], want[live], reg.LASSO_TOL)
    assert torch.equal(got[[0, 2]], clean[[0, 2]])
