"""A binned training dataset that fits many times: bin once, upload once.

The port's counterpart of the JAX package's ``gbdt/dataset.py`` (LightGBM's
``SharedState`` analogue, ``lightgbm/.../SharedState.scala:15-122``): a
hyperparameter sweep or a continued fit passes one :class:`GBDTDataset` to
every :func:`~.boost.train`, which takes the dataset's cached binned buffer
on its device and bins and uploads nothing.

Four ways in:

- host dense rows (numpy): ``BinMapper.fit`` and ``transform`` run once on
  the host; :meth:`GBDTDataset.device_binned` uploads the bins once;
- a ``torch.Tensor`` (device-resident): only the bin sample's rows
  (``mapper.sample_indices``, sorted) come to the host to fit the mapper;
  the whole matrix is binned on its device by kernel D
  (``BinMapper.transform_torch``), so it never crosses to the host;
- CSR rows (:class:`~.sparse.CSRMatrix` or scipy sparse): ``fit_csr`` runs
  once and :meth:`GBDTDataset.device_binned` builds the
  :class:`~.sparse.SparseBinned` (with kernel G's row-major view) once;
- :meth:`GBDTDataset.from_binned`: bins and a fitted mapper made elsewhere.

The dataset's device is ``device`` (the GPU by default, ``"cpu"`` for the
plain PyTorch path); a CPU tensor given with ``device=None`` moves to the
GPU. The binning parameters are fixed here and win over those of any fit
that uses the dataset (LightGBM's Dataset owns binning). On a mesh
(``train(ds, mesh=...)``) each rank takes its block of the rows: a
device-resident dataset's cached bins by row on its device (no binning
again), a host dataset's bins, a CSR dataset's rows binned a block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..runtime.device import resolve_device
from .binning import BinMapper, bin_dtype
from .sparse import CSRMatrix, as_csr, build_sparse_binned, is_sparse_input

__all__ = ["GBDTDataset"]


class GBDTDataset:
    """Binned features (and optionally the label) cached on one device.

    ``x``: (n, d) numpy rows, a (n, d) ``torch.Tensor`` (device-resident) or
    CSR rows. ``label``: numpy or tensor, optional (``train(params, ds)``
    then needs no ``y``). The binning parameters are those of
    :class:`~.binning.BinMapper`."""

    def __init__(self, x, *, label=None, max_bin: int = 255, seed: int = 0,
                 categorical_features: Optional[Sequence[int]] = None,
                 feature_names: Optional[List[str]] = None,
                 bin_sample_count: int = 200_000,
                 max_bin_by_feature: Optional[List[int]] = None, device=None):
        self.is_device = isinstance(x, torch.Tensor)
        if self.is_device and device is None and x.device.type == "cuda":
            device = x.device
        self.device = resolve_device(device)
        self._label_in = label
        self._label_np = None
        self._label_d = None
        self._device = None
        self.binned_np = None
        self.max_bin = int(max_bin)
        self.feature_names = list(feature_names) if feature_names else None
        self.mapper = BinMapper(max_bin=self.max_bin, seed=int(seed),
                                sample_cnt=int(bin_sample_count),
                                max_bin_by_feature=max_bin_by_feature,
                                categorical_features=sorted(
                                    int(c) for c in (categorical_features or [])))
        if self.is_device:
            if x.dim() != 2:
                raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
            self.x = x.to(self.device, torch.float32)
            # the edges (and category codes) come from the rows BinMapper.fit
            # would sample, pulled in row order; the matrix stays on its device
            idx = self.mapper.sample_indices(self.x.shape[0])
            sample = (self.x if idx is None else
                      self.x[torch.from_numpy(np.sort(idx)).to(self.device)])
            self.mapper.fit(sample.cpu().numpy())
            self.bin_dtype = bin_dtype(self.mapper.n_bins)
            self._device = self.mapper.transform_torch(self.x)  # kernel D
            return
        if is_sparse_input(x):
            self.x = as_csr(x)
            self.mapper.fit_csr(self.x)
            self.bin_dtype = bin_dtype(self.mapper.realized_n_bins)
            return
        self.x = np.asarray(x, dtype=np.float64)
        if self.x.ndim != 2:
            raise ValueError(f"x must be (n, d), got shape {self.x.shape}")
        self.mapper.fit(self.x)
        self.binned_np = self.mapper.transform(self.x)
        self.bin_dtype = bin_dtype(self.mapper.n_bins)

    @classmethod
    def from_binned(cls, binned, mapper: BinMapper, *, x, label=None,
                    feature_names: Optional[List[str]] = None,
                    device=None) -> "GBDTDataset":
        """A host dataset from bins ``mapper`` made of ``x`` (the tuning
        transport: bins made once, shipped to each trial). ``x`` stays
        required: a continued fit whose init booster bins otherwise scores
        the raw rows."""
        ds = cls.__new__(cls)
        ds.is_device = False
        ds.device = resolve_device(device)
        ds._label_in = label
        ds._label_np = None
        ds._label_d = None
        ds._device = None
        ds.mapper = mapper
        ds.max_bin = int(mapper.max_bin)
        ds.feature_names = list(feature_names) if feature_names else None
        ds.x = np.asarray(x, dtype=np.float64)
        if ds.x.ndim != 2:
            raise ValueError(f"x must be (n, d), got shape {ds.x.shape}")
        binned = np.asarray(binned)
        if binned.shape != ds.x.shape:
            raise ValueError(f"binned shape {binned.shape} != raw x shape {ds.x.shape}")
        ds.binned_np = binned
        ds.bin_dtype = bin_dtype(mapper.n_bins)
        return ds

    @property
    def label_np(self) -> Optional[np.ndarray]:
        """The label as host float64 (brought over once for a tensor label)."""
        if self._label_np is None and self._label_in is not None:
            lab = self._label_in
            if isinstance(lab, torch.Tensor):
                lab = lab.detach().cpu().numpy()
            self._label_np = np.asarray(lab, dtype=np.float64)
        return self._label_np

    def label_device(self) -> Optional[torch.Tensor]:
        """The label as float32 on the dataset's device (moved once)."""
        if self._label_d is None and self._label_in is not None:
            lab = self._label_in
            if not isinstance(lab, torch.Tensor):
                lab = torch.as_tensor(np.asarray(lab, dtype=np.float64))
            self._label_d = lab.to(self.device, torch.float32)
        return self._label_d

    @property
    def num_rows(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def is_sparse(self) -> bool:
        return isinstance(self.x, CSRMatrix)

    def device_binned(self):
        """The bins on the dataset's device, made once and kept: a dense
        (n, d) integer tensor or a :class:`~.sparse.SparseBinned`."""
        if self._device is None:
            if self.is_sparse:
                self._device = build_sparse_binned(self.x, self.mapper, self.device)
            else:
                self._device = torch.from_numpy(
                    self.binned_np.astype(self.bin_dtype)).to(self.device)
        return self._device

    def __repr__(self) -> str:
        return (f"GBDTDataset(rows={self.num_rows}, features={self.num_features}, "
                f"max_bin={self.max_bin}, device={self.device}, "
                f"device_cached={self._device is not None})")
