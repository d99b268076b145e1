"""Edge-case inputs for kernels D (device binning) and E (split search).

Shared by ``tests/test_torch_kernels.py`` (on the card),
``tests/test_torch_categorical.py`` and ``tests/test_torch_split_step.py``
(the plain versions on the CPU) and ``chip_smoke.py`` (phase 4), so they
check the same cases. Everything is made from a seed with numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..gbdt.binning import BinMapper
from ..gbdt.device_predict import pack_feature_table
from ..gbdt.grow import TreeConfig
from ..gbdt.split_search import SplitWorkspace, _thresh_l1, left_set

__all__ = ["bin_edge_case", "bin_ragged_case", "split_cases", "step_cases",
           "LARGEST_KERNEL_A_BINS", "offgrid_split_case", "check_offgrid", "check_left_sets",
           "synthetic_update", "grow_synthetic", "diff_runs"]

# the most bins kernel A takes: one feature's (B, 3) f32 histogram plus a
# word within 227 KB of shared memory (histogram.py)
LARGEST_KERNEL_A_BINS = (227 * 1024 // 4 - 1) // 3


def bin_edge_case(seed: int = 5) -> Tuple[BinMapper, np.ndarray]:
    """A mapper with 2 numeric and 2 categorical features, whose f64 edges
    include midpoints that round UP to f32, and (n, 4) f32 probes: every
    rounded edge, +-inf, NaN, -0.0 and +0.0, unseen codes, random values."""
    rng = np.random.default_rng(seed)
    n = 3000
    x = np.empty((n, 4))
    x[:, 0] = rng.integers(0, 40, size=n) * 0.1 + 1e-9
    x[:, 1] = rng.integers(-4, 6, size=n)
    x[:, 2] = rng.normal(size=n) * 1e3
    x[:, 3] = rng.integers(0, 3, size=n)
    mapper = BinMapper(max_bin=31, categorical_features=[1, 3]).fit(x)
    table, _, _ = pack_feature_table(mapper)
    probe = np.concatenate([
        table[0][:, None].repeat(4, 1),
        table[2][:, None].repeat(4, 1),
        np.array([[np.inf] * 4, [-np.inf] * 4, [np.nan] * 4, [-0.0] * 4, [0.0] * 4,
                  [99.0] * 4, [-4.0] * 4, [2.5] * 4]),
        rng.normal(size=(64, 4)) * 3]).astype(np.float32)
    return mapper, probe


def bin_ragged_case(n: int, d: int, seed: int = 7) -> Tuple[BinMapper, np.ndarray]:
    """A 63-bin mapper over ``d`` features (every third one from the second
    categorical) and (n, d) f32 rows to bin with it, NaN and unseen codes
    included: ``n * d`` need not be a multiple of 4, so kernel D's last
    group of 4 elements is ragged."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cats = list(range(1, d, 3))
    x[:, cats] = rng.integers(-2, 30, size=(n, len(cats)))
    x[rng.random((n, d)) < 0.02] = np.nan
    mapper = BinMapper(max_bin=63, categorical_features=cats).fit(x[: max(n // 2, 1)])
    return mapper, x


def _grid_hists(rng, L, d, B, empty=0.2, k=64, unit=2.0 ** -8):
    """(L, d, B, 3) histograms on a summation-exact grid (multiples of
    ``unit``, sums far below 2**24 units), a share ``empty`` of bins empty."""
    G = rng.integers(-k, k + 1, size=(L, d, B)) * unit
    H = rng.integers(1, k + 1, size=(L, d, B)) * unit
    C = rng.integers(1, 60, size=(L, d, B)).astype(np.float64)
    live = rng.random((L, d, B)) >= empty
    return np.stack([G * live, H * live, C * live], -1).astype(np.float32)


def split_cases(seed: int = 0) -> Dict[str, tuple]:
    """name -> (hists (L, d, B, 3) f32, feature_mask (d,), cat_mask (d,) or
    None, n_active, TreeConfig), every histogram on the exact grid."""
    rng = np.random.default_rng(seed)
    out = {}
    f32 = lambda a: np.asarray(a, np.float32)

    h = _grid_hists(rng, 31, 28, 64)
    out["numeric"] = (h, np.ones(28), None, 20, TreeConfig(n_bins=64))

    h = _grid_hists(rng, 31, 14, 256)
    cm = f32([0] * 6 + [1] * 8)                               # Adult's layout
    out["mixed_cat"] = (h, np.ones(14), cm, 31, TreeConfig(n_bins=256))

    h = _grid_hists(rng, 8, 6, 64, empty=0.0)
    out["max_cat_threshold"] = (h, np.ones(6), np.ones(6), 8,
                                TreeConfig(n_bins=64, max_cat_threshold=2, cat_smooth=1.0))

    h = _grid_hists(rng, 8, 10, 64, empty=0.7)
    out["empty_bins"] = (h, np.ones(10), f32([0, 1] * 5), 8,
                         TreeConfig(n_bins=64, min_data_in_leaf=1.0))

    # exact ties: numeric features 2, 5 and 7 hold one row (ties across
    # features), whose empty bins repeat a prefix (ties across bins); the
    # other features' gains are a sixteenth of theirs
    h = _grid_hists(rng, 4, 9, 64, empty=0.5)
    h[:, 5] = h[:, 2]
    h[:, 7] = h[:, 2]
    h[:, [0, 1, 3, 4, 6, 8]] *= 0.0625
    out["ties"] = (h, np.ones(9), None, 4, TreeConfig(n_bins=64))
    # the same among categorical features 1 and 4
    h = _grid_hists(rng, 4, 6, 64, empty=0.5)
    h[:, 4] = h[:, 1]
    h[:, [0, 2, 3, 5]] *= 0.0625
    out["cat_ties"] = (h, np.ones(6), f32([0, 1, 0, 0, 1, 0]), 4, TreeConfig(n_bins=64))

    # 0/0 gains: empty leading bins, no hessian or count limits, l2 = 0
    h = _grid_hists(rng, 4, 6, 32, empty=0.3)
    h[:, 2:4, :3] = 0.0
    out["nan_gain"] = (h, np.ones(6), None, 4,
                       TreeConfig(n_bins=32, min_data_in_leaf=0.0, min_sum_hessian=0.0))

    h = _grid_hists(rng, 6, 8, 64)
    out["masked_l1_l2"] = (h, f32([1, 0, 1, 1, 0, 1, 1, 1]), f32([0, 0, 0, 1, 1, 0, 0, 1]),
                           6, TreeConfig(n_bins=64, lambda_l1=0.25, lambda_l2=1.5,
                                         min_sum_hessian=0.5))

    B = LARGEST_KERNEL_A_BINS
    h = _grid_hists(rng, 2, 3, B, k=8)
    out["largest_B"] = (h, np.ones(3), f32([0, 1, 0]), 2,
                        TreeConfig(n_bins=B, max_cat_threshold=B))
    h = _grid_hists(rng, 31, 12, 256)
    cm = f32([0] * 10 + [1] * 2)                              # Covertype's layout
    out["covertype"] = (h, np.ones(12), cm, 31, TreeConfig(n_bins=256))
    return {k: (f32(v[0]), f32(v[1]), None if v[2] is None else f32(v[2])) + v[3:]
            for k, v in out.items()}


def step_cases(seed: int = 0) -> Dict[str, tuple]:
    """:func:`split_cases` plus cases for whole trees of growth steps: an
    inert step (``min_gain_to_split`` above most leaves' gains), a depth cap,
    and B = 100 (not a power of two) with categorical features. Each
    case's histograms are the pool :func:`grow_synthetic` draws from."""
    out = split_cases(seed)
    rng = np.random.default_rng(seed + 100)
    f32 = lambda a: np.asarray(a, np.float32)
    h, fm, cm, n_active, cfg = out["numeric"]
    out["inert"] = (h, fm, cm, n_active, cfg._replace(min_gain_to_split=2.5))
    h, fm, cm, n_active, cfg = out["mixed_cat"]
    out["max_depth"] = (h, fm, cm, n_active, cfg._replace(max_depth=2))
    out["B100"] = (f32(_grid_hists(rng, 8, 5, 100)), f32(np.ones(5)), f32([1, 0, 1, 0, 0]),
                   8, TreeConfig(n_bins=100, num_leaves=15))
    return out


def synthetic_update(ws: SplitWorkspace, pool: torch.Tensor, s: int) -> None:
    """What routing and kernel A would do after step ``s``, from a pool of
    (Lp, d, B, 3) histograms: when the step split leaf l, leaf ``s + 1``
    takes ``pool[(s + 1) % Lp]`` and leaf l ``pool[(s + 2) % Lp]``, or on
    every third step the same histogram as leaf ``s + 1`` (a tie across
    leaves); an inert step leaves leaf ``s + 1`` empty."""
    Lp = pool.shape[0]
    if bool(ws.ok):
        child = pool[(s + 1) % Lp]
        ws.hists[s + 1] = child
        ws.hists[int(ws.leaf)] = child if s % 3 == 0 else pool[(s + 2) % Lp]
    else:
        ws.hists[s + 1] = 0.0


def grow_synthetic(ws: SplitWorkspace, pool: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every step of one tree on ``ws``, leaf 0 starting as ``pool[0]`` and the
    histograms changing as :func:`synthetic_update` says. Returns, on the
    CPU, what the steps wrote: ``steps`` (per step: leaf, feature, ok, then
    the left set), the record's fields, ``depth``, and the per-leaf bests of
    the leaves the tree scored (leaf L - 1 is made by the last step)."""
    ws.begin_tree()
    ws.hists[0] = pool[0]
    steps = []
    for s in range(ws.cfg.num_leaves - 1):
        ws.step(s)
        steps.append(torch.cat([ws.choice, ws.ok.long(), ws.in_set.long()]))
        synthetic_update(ws, pool, s)
    scored = ws.cfg.num_leaves - 1
    out = {"steps": torch.stack(steps), "depth": ws.depth,
           **{k: v for k, v in ws.record._asdict().items() if v is not None},
           **{k: getattr(ws, k)[:scored] for k in ("leaf_gain", "leaf_feat", "leaf_bin")}}
    return {k: v.cpu() for k, v in out.items()}


def diff_runs(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> list:
    """The names whose tensors differ in bits (NaN equal to NaN)."""
    differ = []
    for name, x in a.items():
        y = b[name]
        if x.is_floating_point():
            same = torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                     y.nan_to_num())
        else:
            same = torch.equal(x, y)
        if not same:
            differ.append(name)
    return differ


def offgrid_split_case(seed: int = 1):
    """Histograms OFF the exact grid at the main path's shape (L=31, d=28,
    B=64): sums round in the order they are taken."""
    rng = np.random.default_rng(seed)
    L, d, B = 31, 28, 64
    G = rng.normal(size=(L, d, B))
    H = rng.uniform(0.1, 2.0, size=(L, d, B))
    C = rng.integers(20, 60, size=(L, d, B)).astype(np.float64)
    cm = np.zeros(d, np.float32)
    cm[:4] = 1.0
    return (np.stack([G, H, C], -1).astype(np.float32), np.ones(d, np.float32), cm, L,
            TreeConfig(n_bins=B))


def check_offgrid(gains_plain: torch.Tensor, got) -> Tuple[int, int]:
    """The off-grid rule: wherever the plain table's runner-up is more than
    one ulp below its best, the kernel's (feature, bin) must be the plain
    version's. Returns (leaves held, leaves with a closer runner-up); raises
    AssertionError on a differing split."""
    L, d, B = gains_plain.shape
    flat = gains_plain.reshape(L, d * B).double().cpu()
    _, feat, bins = (t.cpu() for t in got)
    held = close = 0
    for leaf in range(L):
        row = flat[leaf]
        idx = int(torch.argmax(row))
        best = float(row[idx])
        rest = row.clone()
        rest[idx] = float("-inf")
        ulp = float(np.spacing(np.float32(abs(best))))
        if not float(rest.max()) < best - ulp:
            close += 1
            continue
        assert (int(feat[leaf]), int(bins[leaf])) == (idx // B, idx % B), (
            f"leaf {leaf}: kernel split ({int(feat[leaf])}, {int(bins[leaf])}), plain "
            f"({idx // B}, {idx % B})")
        held += 1
    return held, close


def check_left_sets(hists: torch.Tensor, cat_mask, n_active: int, cfg, got) -> int:
    """For every active leaf with a finite gain, rebuild the chosen split's
    left set as growth does (:func:`~..gbdt.grow.left_set`) and recompute its
    gain from the histogram: it must equal the search's gain exactly (on the
    pre-rounded grid every sum is exact). Returns the leaves checked."""
    gain, feat, bins = got
    checked = 0
    for leaf in range(min(n_active, hists.shape[0])):
        if not torch.isfinite(gain[leaf]):
            continue
        f = int(feat[leaf])
        row = hists[leaf, f]
        is_cat = torch.tensor(cat_mask is not None and bool(cat_mask[f] > 0),
                              device=row.device)
        left = left_set(row, is_cat, int(bins[leaf]), cfg)
        GT, HT = row[:, 0].sum(), row[:, 1].sum()
        GL, HL = row[left, 0].sum(), row[left, 1].sum()
        term = lambda g, h: _thresh_l1(g, cfg.lambda_l1) ** 2 / (h + cfg.lambda_l2)
        want = term(GL, HL) + term(GT - GL, HT - HL) - term(GT, HT)
        assert float(want) == float(gain[leaf]), (
            f"leaf {leaf}: the left set's gain {float(want)} is not the search's "
            f"{float(gain[leaf])}")
        checked += 1
    return checked
