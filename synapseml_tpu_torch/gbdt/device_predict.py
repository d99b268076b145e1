"""Batched booster scoring on the device (kernel B).

Port of ``synapseml_tpu/gbdt/device_predict.py::device_raw_scores``. The
model is a stack of replay-list trees (T, C, S); scoring replays every split
of every tree on BINNED features and accumulates ``scale_t * leaf_value`` in
an (n, C) f32 buffer in tree order — the reference's ``lax.scan`` over trees
(``device_predict.py:95-98``), so the sums round the same way.

On a CUDA tensor :func:`device_raw_scores` launches ``csrc/tree_score.cu``
(one thread per row, trees staged in shared memory); on a CPU tensor it runs
the plain PyTorch version :func:`raw_scores_plain`. Numeric splits only: the
categorical ``cat_set`` path is not ported yet.
"""

from __future__ import annotations

import ctypes
import numpy as np
import torch

from ..kernels.build import CudaKernel
from .grow import GrownTree, predict_binned

__all__ = ["device_raw_scores", "raw_scores_plain", "SCORE_KERNEL", "MAX_CLASSES"]

MAX_CLASSES = 8  # per-row accumulators the kernel keeps in registers

SCORE_KERNEL = CudaKernel(
    name="gbdt_tree_score", source="tree_score", symbol="smt_tree_score",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/device_predict.py:61 (_score_kernel)")


def raw_scores_plain(binned, parent, feature, bins, leaf_value, scale) -> torch.Tensor:
    """Plain PyTorch version: each tree's leaves by :func:`~.grow.predict_binned`,
    summed tree by tree."""
    T, C, _ = parent.shape
    acc = torch.zeros(binned.shape[0], C, dtype=torch.float32, device=binned.device)
    for t in range(T):
        vals = []
        for c in range(C):
            tree = GrownTree(parent[t, c], feature[t, c], bins[t, c], None,
                             leaf_value[t, c], None)
            vals.append(tree.leaf_value[predict_binned(tree, binned).long()])
        acc = acc + scale[t] * torch.stack(vals, dim=1)
    return acc


def device_raw_scores(binned: torch.Tensor, parent, feature, bins, leaf_value,
                      scale) -> torch.Tensor:
    """(n, d) bins -> (n, C) f32 sum over trees of ``scale_t * leaf_value``.

    ``binned`` is an int8/int16/int32 tensor on the device that scores; the
    tree arrays (numpy or tensors) are ``parent``/``feature``/``bins``
    (T, C, S) int, ``leaf_value`` (T, C, S+1) f32 and ``scale`` (T,), which is
    rounded to f32 as the reference does."""
    if binned.dim() != 2 or binned.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(f"binned must be a 2-D int8/int16/int32 tensor, got "
                        f"{binned.dtype} of shape {tuple(binned.shape)}")
    dev = binned.device
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                                         else a, device=dev).to(dt).contiguous()
    parent, feature, bins = (as_t(a, torch.int32) for a in (parent, feature, bins))
    leaf_value = as_t(leaf_value, torch.float32)
    scale = as_t(scale, torch.float32)
    T, C, S = parent.shape
    if feature.shape != (T, C, S) or bins.shape != (T, C, S):
        raise ValueError("parent, feature and bins must share one (T, C, S) shape")
    if leaf_value.shape != (T, C, S + 1) or scale.shape != (T,):
        raise ValueError(f"leaf_value must be ({T}, {C}, {S + 1}) and scale ({T},), "
                         f"got {tuple(leaf_value.shape)} and {tuple(scale.shape)}")
    if T and (int(feature.min()) < 0 or int(feature.max()) >= binned.shape[1]):
        raise ValueError(f"split features must lie in [0, {binned.shape[1]})")
    if dev.type == "cpu":
        return raw_scores_plain(binned, parent, feature, bins, leaf_value, scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if C > MAX_CLASSES:
        raise ValueError(f"the scoring kernel keeps at most {MAX_CLASSES} classes, got {C}")
    binned = binned.contiguous()
    n, d = binned.shape
    out = torch.zeros(n, C, dtype=torch.float32, device=dev)
    if n == 0 or T == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        SCORE_KERNEL(binned.data_ptr(), binned.element_size(), n, d,
                     parent.data_ptr(), feature.data_ptr(), bins.data_ptr(),
                     leaf_value.data_ptr(), scale.data_ptr(), T, C, S,
                     out.data_ptr(), stream)
    return out
