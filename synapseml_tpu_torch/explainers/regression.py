"""Batched weighted linear regression for the local explainers.

Port of ``synapseml_tpu/explainers/regression.py``: one fit for each
(instance, target) pair, all on the caller's device, with the reference's
center / rescale / solve scheme:

- sample weights are normalized to mean one (``w * m / sum(w)``);
- with ``fit_intercept``, x and y are weighted-mean centered, then rescaled
  by ``sqrt(w)`` before the solve;
- ``alpha > 0`` is the lasso's cyclic coordinate descent with soft
  thresholding at ``alpha * m`` on the rescaled system's Gram matrix (one
  batched matmul), run by hand kernel L (``csrc/lasso_cd.cu``) on a CUDA
  tensor and by :func:`lasso_cd_plain` on a CPU tensor;
- ``alpha == 0`` is the minimum-norm weighted least squares of
  ``jnp.linalg.lstsq``: a batched SVD, singular values kept where they are
  above 0 and at least ``eps * max(m, k) * s[0]``. ``torch.linalg.lstsq``
  has only the full-rank ``gels`` driver on CUDA, so it is not used; an
  all-zero column (the batching's padding) gets coefficient exactly 0;
- r^2 and loss are computed on the original data with the raw weights.

Matmuls run in full f32 (:func:`~..runtime.device.full_f32`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.build import CudaKernel, library
from ..runtime.device import full_f32, resolve_device

__all__ = ["RegressionResult", "fit_regression", "fit_regression_batch", "lasso_cd",
           "lasso_cd_plain", "lasso_plan", "lasso_smem_k", "lasso_system", "rescaled",
           "LASSO_KERNEL", "LASSO_TOL"]

_P = ctypes.c_void_p
_I = ctypes.c_int
LASSO_KERNEL = CudaKernel(
    name="explainers_lasso_cd", source="lasso_cd", symbol="smt_lasso_cd",
    argtypes=[_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_float, _P],
    replaces="synapseml_tpu/explainers/regression.py:39 (_fit_core's lasso descent, :72-85)")

# Kernel L against its plain version: max |beta_L - beta_plain| over a batch
# <= LASSO_TOL * max(1, max |beta_plain|). L keeps c = Xty - gram @ beta and
# updates it by a column of gram where a step moves beta_j (its order is
# tools/kernel_cases.py::lasso_cd_order); the plain version sums a fresh dot
# gram[j] @ beta each step. The same terms in another order move rho by a
# few ulps of them at every step.
LASSO_TOL = 1e-4


class RegressionResult(NamedTuple):
    coefficients: np.ndarray  # (..., k)
    intercept: np.ndarray     # (...)
    r_squared: np.ndarray     # (...)
    loss: np.ndarray          # (...)


def lasso_smem_k() -> int:
    """The largest k whose Gram matrix kernel L keeps in shared memory on
    the current CUDA device, as its packed upper triangle (336 on the H100's
    227 KB a block; past it the rows are read from global memory)."""
    out = ctypes.c_int(0)
    fn = library("lasso_cd").smt_lasso_smem_k
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"smt_lasso_smem_k: CUDA error {err}")
    return out.value


def lasso_plan(k: int, t: int) -> Tuple[bool, int]:
    """Kernel L's launch for ``k`` coordinates and ``t`` fits an instance on
    the current CUDA device: (Gram matrix in shared memory, fits a block)."""
    out = (ctypes.c_int * 2)()
    fn = library("lasso_cd").smt_lasso_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(int(k), int(t), out)
    if err != 0:
        raise RuntimeError(f"smt_lasso_plan: CUDA error {err}")
    return bool(out[0]), int(out[1])


def lasso_cd_plain(gram: torch.Tensor, xty: torch.Tensor, sq: torch.Tensor, lam: float,
                   max_iter: int) -> torch.Tensor:
    """Plain PyTorch version of kernel L: ``gram`` (n, k, k), ``xty`` (n, t, k),
    ``sq`` (n, k) -> beta (n, t, k), the reference's descent vectorised over
    the fits, a Python loop over sweeps and coordinates."""
    n, t, k = xty.shape
    beta = torch.zeros(n, t, k, dtype=torch.float32, device=xty.device)
    diag = torch.diagonal(gram, dim1=1, dim2=2)
    pos = sq > 0
    den = torch.where(pos, sq, torch.ones_like(sq))
    for _ in range(int(max_iter)):
        for j in range(k):
            bj = beta[:, :, j]
            dot = (gram[:, None, j, :] * beta).sum(-1)
            rho = xty[:, :, j] - dot + diag[:, None, j] * bj
            soft = torch.sign(rho) * torch.clamp(torch.abs(rho) - lam, min=0.0)
            beta[:, :, j] = torch.where(pos[:, None, j], soft / den[:, None, j],
                                        torch.zeros_like(soft))
    return beta


def lasso_cd(gram: torch.Tensor, xty: torch.Tensor, sq: torch.Tensor, lam: float,
             max_iter: int) -> torch.Tensor:
    """The lasso's coordinate descent for every fit: kernel L on a CUDA
    tensor, :func:`lasso_cd_plain` on a CPU tensor. Shapes as there, f32."""
    gram, xty, sq = (a.to(torch.float32).contiguous() for a in (gram, xty, sq))
    n, t, k = xty.shape
    if gram.shape != (n, k, k) or sq.shape != (n, k):
        raise ValueError(f"gram {tuple(gram.shape)} / sq {tuple(sq.shape)} do not fit "
                         f"xty {tuple(xty.shape)}")
    if xty.device.type == "cpu":
        return lasso_cd_plain(gram, xty, sq, lam, max_iter)
    beta = torch.empty_like(xty)
    if n * t == 0 or k == 0:
        return beta.zero_()
    with torch.cuda.device(xty.device):
        stream = torch.cuda.current_stream(xty.device).cuda_stream
        LASSO_KERNEL(gram.data_ptr(), xty.data_ptr(), sq.data_ptr(), beta.data_ptr(),
                     n * t, t, k, int(max_iter), float(np.float32(lam)), stream)
    return beta


def _min_norm_lstsq(xr: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.lstsq's answer for each instance: ``xr`` (n, m, k),
    ``yr`` (n, m, t) -> (n, t, k)."""
    m, k = xr.shape[1:]
    u, s, vh = torch.linalg.svd(xr, full_matrices=False)
    rcond = torch.tensor(float(np.finfo(np.float32).eps) * max(m, k), dtype=torch.float32,
                         device=xr.device)
    keep = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    x = vh.transpose(1, 2) @ (s_inv[:, :, None] * (u.transpose(1, 2) @ yr))
    live = (xr != 0).any(dim=1)                  # (n, k): all-zero columns get 0
    return torch.where(live[:, None, :], x.transpose(1, 2), torch.zeros((), device=xr.device))


def lasso_system(Xr: torch.Tensor, Yr: torch.Tensor):
    """The rescaled system's (gram (n, k, k), xty (n, t, k), sq (n, k)) that
    the descent runs on: one batched matmul each, in full f32."""
    with full_f32():
        sq = (Xr * Xr).sum(1)
        gram = Xr.transpose(1, 2) @ Xr
        xty = (Yr.transpose(1, 2) @ Xr).contiguous()
    return gram, xty, sq


def _weighted_mean(A: torch.Tensor, w: torch.Tensor, total) -> torch.Tensor:
    """sum(w * A) / total over the samples (dim 1), taken about the first
    sample's value so that a constant column's mean is that constant exactly
    (then its centered values, a constant target's total sum of squares and
    its residuals are exactly 0, as the reference's formula gives them in
    exact arithmetic)."""
    a0 = A[:, :1]
    return a0[:, 0] + (w[:, :, None] * (A - a0)).sum(1) / total


def rescaled(X, Y, w, fit_intercept: bool = True):
    """The reference's centering and rescaling: X (n, m, k), Y (n, m, t),
    w (n, m) f32 -> (w clamped at 0, its sums (n, 1), x_off (n, k),
    y_off (n, t), Xr, Yr)."""
    n, m, k = X.shape
    w = torch.clamp(w, min=0.0)
    wsum = w.sum(1, keepdim=True)                                    # (n, 1)
    wn = w * (m / torch.where(wsum == 0, torch.ones_like(wsum), wsum))
    if fit_intercept:
        x_off = _weighted_mean(X, wn, m)                             # (n, k)
        y_off = _weighted_mean(Y, wn, m)                             # (n, t)
        Xc = X - x_off[:, None, :]
        Yc = Y - y_off[:, None, :]
    else:
        x_off = torch.zeros(n, k, dtype=X.dtype, device=X.device)
        y_off = torch.zeros(n, Y.shape[2], dtype=X.dtype, device=X.device)
        Xc, Yc = X, Y
    sw = torch.sqrt(wn)[:, :, None]
    return w, wsum, x_off, y_off, sw * Xc, sw * Yc


def _fit(X, Y, w, alpha: float, fit_intercept: bool, max_iter: int):
    """X (n, m, k), Y (n, m, t), w (n, m), f32 on one device -> beta (n, t, k),
    intercept, r2, loss (n, t)."""
    m = X.shape[1]
    w, wsum, x_off, y_off, Xr, Yr = rescaled(X, Y, w, fit_intercept)
    if alpha > 0.0:
        beta = lasso_cd(*lasso_system(Xr, Yr), alpha * m, max_iter)
    else:
        beta = _min_norm_lstsq(Xr, Yr)
    if fit_intercept:
        intercept = y_off - (x_off[:, None, :] * beta).sum(-1)
    else:
        intercept = torch.zeros_like(y_off)
    est = X @ beta.transpose(1, 2) + intercept[:, None, :]             # (n, m, t)
    res = Y - est
    wt = w[:, :, None]
    loss = (wt * res * res).sum(1)
    y_mean = _weighted_mean(Y, w, torch.where(wsum == 0, torch.ones_like(wsum), wsum))
    tss = (wt * (Y - y_mean[:, None, :]) ** 2).sum(1)
    r2 = 1.0 - loss / torch.where(tss == 0, torch.ones_like(tss), tss)
    r2 = torch.where(tss == 0, torch.where(loss == 0, torch.ones_like(r2),
                                           torch.full_like(r2, -float("inf"))), r2)
    if alpha > 0.0:
        loss = loss + alpha * beta.abs().sum(-1)
    return beta, intercept, r2, loss


def _f32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def fit_regression_batch(X, Y, w, alpha: float = 0.0, fit_intercept: bool = True,
                         max_iter: int = 100, device: Optional[str] = None) -> RegressionResult:
    """Batch of fits on ``device`` (default: the GPU; a tensor argument's own
    device when ``device`` is None and it is a tensor).

    ``X`` (n, m, k) sample states per instance; ``Y`` (n, m, t) model outputs
    per target; ``w`` (n, m) sample weights. Returns coefficients (n, t, k),
    intercept / r_squared / loss (n, t), as numpy arrays."""
    if device is None and isinstance(X, torch.Tensor):
        dev = X.device
    else:
        dev = resolve_device(device)
    X, Y, w = _f32(X, dev), _f32(Y, dev), _f32(w, dev)
    with full_f32():
        beta, b0, r2, loss = _fit(X, Y, w, float(alpha), bool(fit_intercept), int(max_iter))
    host = lambda a: a.cpu().numpy()
    return RegressionResult(host(beta), host(b0), host(r2), host(loss))


def fit_regression(X, y, w: Optional[np.ndarray] = None, alpha: float = 0.0,
                   fit_intercept: bool = True, max_iter: int = 100,
                   device: Optional[str] = None) -> RegressionResult:
    """Fit one weighted (lasso if ``alpha>0``) regression. X (m,k), y (m,)."""
    X = np.asarray(X, np.float32)
    w = np.ones(X.shape[0], np.float32) if w is None else np.asarray(w, np.float32)
    res = fit_regression_batch(X[None], np.asarray(y, np.float32)[None, :, None], w[None],
                               alpha, fit_intercept, max_iter, device)
    return RegressionResult(res.coefficients[0, 0], res.intercept[0, 0],
                            res.r_squared[0, 0], res.loss[0, 0])
