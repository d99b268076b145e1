"""The split search of one growth step (kernel E).

Port of ``synapseml_tpu/gbdt/grow.py`` ``_prefix_bins`` + ``gain_table`` +
``combined_gain`` + ``best_splits`` (non-voting branch, ``grow.py:95-116``,
``:252-313``). From the (L, d, B, 3) histograms of every leaf it finds, per
leaf, the best (gain, feature, bin):

- numeric features: entry ``b`` is the split 'bin <= b', from an inclusive
  prefix over bins;
- categorical features (``cat_mask``): the bins are ordered by
  G / (H + cat_smooth), descending and stable, and entry ``b`` is the set of
  the first ``b + 1`` bins in that order, at most ``max_cat_threshold``;
- the gain ``thresh_l1(GL)^2/(HL + l2) + thresh_l1(GR)^2/(HR + l2) -
  thresh_l1(G)^2/(H + l2)`` counts where ``b < B - 1``, both sides hold at
  least ``min_data_in_leaf`` rows and ``min_sum_hessian`` hessian, and the
  feature is in ``feature_mask``; elsewhere it is -inf;
- per leaf, the first maximum of the (d * B) table (a NaN counts as the
  maximum, as in ``torch.argmax`` and ``jnp.argmax``); leaves at or beyond
  ``n_active`` get gain -inf.

On CUDA tensors :func:`split_search` launches ``csrc/split_search.cu``; on CPU
tensors it runs :func:`split_search_plain`, these torch ops. On gradients
pre-rounded by ``boost._preround`` every prefix is exact in any order, and the
kernel, which rounds the gain as the torch ops do, gives the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import CudaKernel

__all__ = ["split_search", "split_search_plain", "split_gains_plain", "category_key",
           "SPLIT_KERNEL"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SPLIT_KERNEL = CudaKernel(
    name="gbdt_split_search", source="split_search", symbol="smt_split_search",
    argtypes=[_P, _I, _I, _I, _P, _P, _I, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P, _P, _P],
    replaces="synapseml_tpu/gbdt/grow.py:300 (best_splits over gain_table, "
             "_prefix_bins :95)")


def category_key(G: torch.Tensor, H: torch.Tensor, cat_smooth: float) -> torch.Tensor:
    """Sort key of the categorical bins: -G / (H + cat_smooth), ascending and
    stable. Adding 0.0 turns -0.0 into +0.0, which a comparison sort treats
    as equal already; the kernel compares the same way."""
    return -(G / (H + cat_smooth)) + 0.0


def _thresh_l1(g, l1: float):
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def split_gains_plain(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask, cfg):
    """(L, d, B) gain table: the reference's ``combined_gain``."""
    B = hists.shape[2]
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2
    pos = torch.arange(B, device=hists.device)
    G, H, C = hists[..., 0], hists[..., 1], hists[..., 2]
    GT = G.sum(-1, keepdim=True)
    HT = H.sum(-1, keepdim=True)
    CT = C.sum(-1, keepdim=True)
    neg_inf = torch.tensor(float("-inf"), device=hists.device)

    def gain_term(g, h):
        return _thresh_l1(g, l1) ** 2 / (h + l2)

    def split_gain(cum, extra_valid):
        GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
        GR, HR, CR = GT - GL, HT - HL, CT - CL
        g = gain_term(GL, HL) + gain_term(GR, HR) - gain_term(GT, HT)
        valid = ((pos < B - 1)
                 & (CL >= cfg.min_data_in_leaf) & (CR >= cfg.min_data_in_leaf)
                 & (HL >= cfg.min_sum_hessian) & (HR >= cfg.min_sum_hessian)
                 & extra_valid & (feature_mask[:, None] > 0))
        return torch.where(valid, g, neg_inf)

    gain = split_gain(torch.cumsum(hists, dim=-2), torch.ones((), dtype=torch.bool,
                                                               device=hists.device))
    if cat_mask is not None:
        order = torch.argsort(category_key(G, H, cfg.cat_smooth), dim=-1, stable=True)
        sorted_h = torch.take_along_dim(hists, order[..., None], dim=-2)
        gain_cat = split_gain(torch.cumsum(sorted_h, dim=-2),
                              pos + 1 <= cfg.max_cat_threshold)
        gain = torch.where(cat_mask[:, None] > 0, gain_cat, gain)
    return gain


def split_search_plain(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask,
                       n_active: int, cfg):
    """Plain PyTorch version: (L,) f32 best gain, (L,) int32 feature and bin."""
    L, d, B, _ = hists.shape
    flat = split_gains_plain(hists, feature_mask, cat_mask, cfg).reshape(L, d * B)
    neg_inf = torch.tensor(float("-inf"), device=hists.device)
    # torch.argmax and jnp.argmax both pick the FIRST maximal index (a NaN first)
    idx = torch.argmax(flat, dim=-1)
    best = flat.gather(1, idx[:, None])[:, 0]
    best = torch.where(torch.arange(L, device=hists.device) < n_active, best, neg_inf)
    return (best, torch.div(idx, B, rounding_mode="floor").to(torch.int32),
            (idx % B).to(torch.int32))


def _check(hists, feature_mask, cat_mask):
    if hists.dim() != 4 or hists.shape[-1] != 3 or hists.dtype != torch.float32:
        raise TypeError(f"hists must be (L, d, B, 3) float32, got {hists.dtype} of shape "
                        f"{tuple(hists.shape)}")
    d = hists.shape[1]
    for name, m in (("feature_mask", feature_mask), ("cat_mask", cat_mask)):
        if m is None:
            continue
        if m.shape != (d,) or m.dtype != torch.float32:
            raise TypeError(f"{name} must be ({d},) float32, got {m.dtype} of shape "
                            f"{tuple(m.shape)}")
        if m.device != hists.device:
            raise ValueError(f"hists on {hists.device} but {name} on {m.device}")


def split_search(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask, n_active: int,
                 cfg):
    """Best (gain, feature, bin) of each of the L leaves: (L,) f32, (L,) int32,
    (L,) int32.

    ``hists`` (L, d, B, 3) f32; ``feature_mask`` and ``cat_mask`` (d,) f32 in
    {0, 1} (``cat_mask`` None: every feature numeric); ``cfg`` a
    ``grow.TreeConfig``. CPU tensors take the plain version; CUDA tensors
    launch kernel E (two launches a call: one block per (leaf, feature),
    then one per leaf over the features)."""
    _check(hists, feature_mask, cat_mask)
    if hists.device.type == "cpu":
        return split_search_plain(hists, feature_mask, cat_mask, n_active, cfg)
    if hists.device.type != "cuda":
        raise ValueError(f"unsupported device {hists.device}")
    L, d, B, _ = hists.shape
    dev = hists.device
    hists = hists.contiguous()
    feature_mask = feature_mask.contiguous()
    cat_ptr = None if cat_mask is None else cat_mask.contiguous()
    # two allocations a call (the fit calls this once a split step, from the
    # host): per-(leaf, feature) scratch and the (L,) results side by side
    fbuf = torch.empty(L * d + L, dtype=torch.float32, device=dev)
    ibuf = torch.empty(L * d + 2 * L, dtype=torch.int32, device=dev)
    gain, feat, bins = fbuf[L * d:], ibuf[L * d:L * d + L], ibuf[L * d + L:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        SPLIT_KERNEL(hists.data_ptr(), L, d, B, feature_mask.data_ptr(),
                     None if cat_ptr is None else cat_ptr.data_ptr(), int(n_active),
                     float(cfg.lambda_l1), float(cfg.lambda_l2),
                     float(cfg.min_data_in_leaf), float(cfg.min_sum_hessian),
                     float(cfg.cat_smooth), int(cfg.max_cat_threshold),
                     fbuf.data_ptr(), ibuf.data_ptr(), gain.data_ptr(),
                     feat.data_ptr(), bins.data_ptr(), stream)
    return gain, feat, bins
