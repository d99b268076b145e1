"""Edge-case inputs for kernels D (device binning), E (split search), F
(the LambdaRank gradient), G (the sparse histogram), P (the row
partition), V (the VW learner's step), Q (the ONNX integer GEMM / conv), R
(the ONNX LSTM / GRU steps), L (the explainers' lasso: its fixtures, a
torch model of its arithmetic order, the ties that rounding decides) and K
(the top-k select: ties, signed zeros, NaN and infinities, and the rule that
holds a card's neighbours to a CPU run's), and the full-pass growths that the
dense and the sparse growth are held to.

Shared by ``tests/test_torch_kernels.py`` (on the card),
``tests/test_torch_categorical.py``, ``tests/test_torch_split_step.py`` and
``tests/test_torch_ranker.py``, ``tests/test_torch_sparse.py``,
``tests/test_torch_onnx_quant.py``, ``tests/test_torch_lasso_order.py``,
``tests/test_torch_nn.py`` (the plain versions on the CPU) and
``chip_smoke.py`` (phases 2m, 2n and 4), so they
check the same cases. Everything is made from a seed with numpy.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..gbdt import boost, grow
from ..gbdt.binning import BinMapper
from ..gbdt.device_predict import pack_feature_table
from ..gbdt.grow import TreeConfig, finish_tree
from ..gbdt.histogram import histogram
from ..gbdt.sparse import (G_ENTRIES, CSRMatrix, SparseBinned, build_sparse_binned,
                           pack_entries, sparse_hist)
from ..gbdt.split_search import SplitWorkspace, _thresh_l1, left_set
from ..vw.learner import pad_examples

__all__ = ["TOPK_CASES", "topk_case", "same_up_to_ties", "lasso_case", "lasso_cd_order", "lasso_ties", "LASSO_TIE", "forest_rows", "forest_probe_rows", "Q_CONV3D_CASES", "bin_edge_case", "bin_ragged_case", "split_cases", "step_cases",
           "LARGEST_KERNEL_A_BINS", "offgrid_split_case", "check_offgrid", "check_left_sets",
           "synthetic_update", "grow_synthetic", "diff_runs", "rank_rows", "RANK_CASES",
           "RANK_CASES_WIDE", "rank_case", "rank_nan_case", "one_split_text", "TWO_TREES",
           "native_texts", "many_thresholds_text", "many_thresholds_rows", "PARTITION_CASES",
           "partition_case", "rows_histogrammed", "grow_full_pass", "full_pass",
           "SPARSE_HIST_CASES", "sparse_hist_case", "sparse_case_inputs",
           "VW_STEP_CASES", "VW_ODD_BATCHES", "VW_REGIMES", "vw_step_case", "vw_case_batch",
           "pairs_column", "vw_state_differs", "Q_KINDS", "Q_SIGN_PAIRS", "Q_ZP_FORMS",
           "Q_CONV_CASES", "RESNET50_CONVS", "BERT_BASE_PROJECTIONS", "q_operand",
           "q_zero_point", "q_seed", "rnn_step_case"]

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


def rank_rows(seed: int = 0, n_queries: int = 150, d: int = 10):
    """(x (n, d) f32, labels 0-4, query sizes): about 20 documents a query
    (5-35), two queries of one document and two whose documents share one
    label; the labels from a latent score, an integer count column with
    heavy ties."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 36, n_queries)
    sizes[[3, n_queries // 2]] = 1
    n = int(sizes.sum())
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 3] = rng.integers(0, 5, n)
    latent = x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=n)
    y = np.clip(np.floor(latent + 1.5), 0, 4)
    starts = np.cumsum(sizes) - sizes
    for q in (7, n_queries - 5):
        y[starts[q]:starts[q] + sizes[q]] = 2.0
    return x, y, sizes


# kernel F's edge cases: every case holds size-1 queries and queries of one
# label; "signed_zeros" ties -0.0 with +0.0 across many documents;
# "truncation_1" keeps one top document a query; "truncation_past_largest"
# makes every document top (queries over the kernel's TOP_MAX documents take
# its two-sided second loop); "one_label" gives every query a single label
# (no pair counts); "smem_boundary" adds queries of exactly 2,048 and 2,049
# documents (the last shared-memory query and the first global-scratch one);
# "large_query" adds one query of 20,000 documents
RANK_CASES = ("ties", "all_tied", "truncation_below_size", "sigma", "zero_weights",
              "large_query", "signed_zeros", "truncation_1", "truncation_past_largest",
              "one_label", "smem_boundary")
# the cases whose reference (Q, G, G) tensors do not fit a CPU test: card and
# plain-version tests only
RANK_CASES_WIDE = ("large_query", "smem_boundary")


def rank_case(case: str, seed: int = 1):
    """(score f32, label f32, weight f32, sizes, truncation, sigma) of one of
    :data:`RANK_CASES`; scores on a 0.1 grid, so documents tie."""
    x, y, sizes = rank_rows(seed)
    wide = {"large_query": [20_000], "smem_boundary": [2_048, 2_049]}.get(case)
    if wide:  # the wide queries after the first ten
        big = np.random.default_rng(seed + 100).integers(0, 5, sum(wide)).astype(np.float64)
        head = int(sizes[:10].sum())
        y = np.concatenate([y[:head], big, y[head:]])
        sizes = np.concatenate([sizes[:10], wide, sizes[10:]])
    n = len(y)
    rng = np.random.default_rng(seed)
    score = np.round(rng.normal(size=n), 1).astype(np.float32)
    w = np.ones(n, np.float32)
    truncation, sigma = 30, 1.0
    if case == "all_tied":
        score[:] = 0.0
    elif case == "truncation_below_size":
        truncation = 4
    elif case == "sigma":
        sigma = 2.5
    elif case == "zero_weights":
        w = rng.random(n).astype(np.float32)
        w[rng.random(n) < 0.2] = 0.0
    elif case == "signed_zeros":
        zero = rng.random(n) < 0.4
        score[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    elif case == "truncation_1":
        truncation = 1
    elif case == "truncation_past_largest":
        truncation = int(sizes.max()) + 5
    elif case == "one_label":
        y = np.repeat(np.arange(len(sizes)) % 5, sizes).astype(np.float64)
    return score, y.astype(np.float32), w, sizes, truncation, sigma


def rank_nan_case(seed: int = 3):
    """(score, label, weight, sizes, truncation 4): ``rank_case("ties")``'s
    first 40 queries with NaN scores in five of them: one NaN, three, half
    the query, and a query of NaN only (whose top documents are NaN)."""
    score, y, w, sizes, _, _ = rank_case("ties", seed)
    sizes = sizes[:40]
    n = int(sizes.sum())
    score, y, w = score[:n].copy(), y[:n], w[:n]
    starts = np.cumsum(sizes) - sizes
    rng = np.random.default_rng(seed)
    for q in (0, 5, 9, 12, 20):
        m = int(sizes[q])
        k = {0: 1, 5: 3, 9: m, 12: 1, 20: max(1, m // 2)}[q]
        score[starts[q] + rng.choice(m, k, replace=False)] = np.nan
    return score, y, w, sizes, 4


# -- LightGBM text models (the booster's import path) ------------------------------

def one_split_text(dt: int, thr: float) -> str:
    """A one-split LightGBM text on feature 0 with ``decision_type`` ``dt``."""
    return "\n".join([
        "tree", "num_class=1", "num_tree_per_iteration=1",
        "max_feature_idx=0", "objective=regression", "",
        "Tree=0", "num_leaves=2", "num_cat=0",
        "split_feature=0", "split_gain=1",
        f"threshold={thr}", f"decision_type={dt}",
        "left_child=-1", "right_child=-2",
        "leaf_value=-1.0 1.0", "leaf_weight=3 3", "",
        "end of trees", "",
    ])


# tree 0 numeric, tree 1 a categorical bitset split
TWO_TREES = "\n".join([
    "tree", "num_class=1", "num_tree_per_iteration=1", "max_feature_idx=1",
    "objective=regression", "",
    "Tree=0", "num_leaves=2", "num_cat=0", "split_feature=0", "split_gain=1",
    "threshold=0.5", "decision_type=8", "left_child=-1", "right_child=-2",
    "leaf_value=-1.0 1.0", "leaf_weight=4 2", "",
    "Tree=1", "num_leaves=2", "num_cat=1", "split_feature=1", "threshold=0",
    "decision_type=1", "left_child=-1", "right_child=-2", "leaf_value=0.5 -0.5",
    "leaf_weight=1 1", "cat_boundaries=0 1", "cat_threshold=5", "",
    "end of trees", ""])


def native_texts() -> Dict[str, str]:
    """The hand-written LightGBM texts of ``tests/test_native_model.py`` (a
    real dump with CRLF and extra fields, default_left, a categorical
    bitset, zero_as_missing and missing_type None splits), by name."""
    real_dump = "\r\n".join([
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1", "label_index=0",
        "max_feature_idx=1", "objective=binary sigmoid:1", "feature_names=f0 f1",
        "feature_infos=[-5:5] [-5:5]", "", "Tree=0", "num_leaves=3", "num_cat=0",
        "split_feature=0 1", "split_gain=10 5", "threshold=1.5 -2.0000000000000001e-01",
        "decision_type=8 8", "left_child=1 -1", "right_child=-3 -2",
        "leaf_value=-0.5 2.5e-01 0.75", "leaf_weight=10 12 8", "leaf_count=10 12 8",
        "internal_value=0 0.1", "internal_weight=30 22", "internal_count=30 22",
        "is_linear=0", "shrinkage=0.1", "", "end of trees", "", "feature_importances:",
        "f0=10", "", "parameters:", "[boosting: gbdt]", "end of parameters"])
    default_left = "\n".join([
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
        "max_feature_idx=1", "objective=regression", "feature_names=f0 f1", "",
        "Tree=0", "num_leaves=3", "num_cat=0", "split_feature=0 1", "split_gain=10 5",
        "threshold=1.5 0.0", "decision_type=10 8", "left_child=1 -1", "right_child=-3 -2",
        "leaf_value=1.0 2.0 3.0", "leaf_weight=5 5 5", "", "end of trees", ""])
    bitset = ("tree\nnum_class=1\nnum_tree_per_iteration=1\nmax_feature_idx=0\n"
              "objective=regression\n\n"
              "Tree=0\nnum_leaves=2\nnum_cat=1\nsplit_feature=0\nthreshold=0\n"
              "decision_type=1\nleft_child=-1\nright_child=-2\n"
              "leaf_value=1.0 -1.0\nleaf_weight=1 1\n"
              "cat_boundaries=0 1\ncat_threshold=5\n\nend of trees\n")
    out = {"real_dump": real_dump, "default_left": default_left, "bitset": bitset,
           "two_trees": TWO_TREES}
    for dt, thr in ((6, -1.0), (4, 1.0), (4, -1e-35), (10, 0.25), (0, -1.0), (2, -1.0),
                    (0, 1.0), (2, 1.0), (10, -1.0), (8, 1.0)):
        out[f"one_split_dt{dt}_t{thr}"] = one_split_text(dt, thr)
    return out


def many_thresholds_text(n_thr: int, seed: int = 0, zero_split: bool = False) -> str:
    """A LightGBM text whose tree 0 is a comb of ``n_thr`` splits on feature
    0 at distinct thresholds (``n_thr + 1`` bins; past 32,767 the bins are
    int32 and kernel B's records wide); with ``zero_split`` a second tree
    splits feature 1 with missing_type=Zero (a set split over all the bins)."""
    rng = np.random.default_rng(seed)
    thr = np.sort(rng.choice(np.arange(1, 50 * n_thr), n_thr, replace=False)) / 7.0 - 3.0 * n_thr
    thr = thr.tolist()
    left = [~k for k in range(n_thr)]
    right = [k + 1 for k in range(n_thr - 1)] + [~n_thr]
    leaves = np.round(rng.normal(size=n_thr + 1), 4).tolist()
    lines = ["tree", "num_class=1", "num_tree_per_iteration=1", "max_feature_idx=1",
             "objective=regression", "",
             "Tree=0", f"num_leaves={n_thr + 1}", "num_cat=0",
             "split_feature=" + " ".join(["0"] * n_thr),
             "split_gain=" + " ".join(["1"] * n_thr),
             "threshold=" + " ".join(repr(t) for t in thr),
             "decision_type=" + " ".join(["8"] * n_thr),
             "left_child=" + " ".join(map(str, left)),
             "right_child=" + " ".join(map(str, right)),
             "leaf_value=" + " ".join(map(repr, leaves)),
             "leaf_weight=" + " ".join(["1"] * (n_thr + 1)), ""]
    if zero_split:
        lines += ["Tree=1", "num_leaves=3", "num_cat=0", "split_feature=1 1",
                  "split_gain=1 1", "threshold=0.5 -0.25", "decision_type=6 4",
                  "left_child=1 -1", "right_child=-3 -2", "leaf_value=0.25 -0.5 0.75",
                  "leaf_weight=2 2 2", ""]
    return "\n".join(lines + ["end of trees", ""])


def many_thresholds_rows(text_booster, n: int, seed: int = 1) -> np.ndarray:
    """f32 rows over the comb's range, with exact thresholds, zeros and NaN."""
    rng = np.random.default_rng(seed)
    edges = text_booster.mapper.upper_edges[0][:-1]
    x = np.empty((n, 2), np.float32)
    x[:, 0] = rng.uniform(edges[0] - 5, edges[-1] + 5, n)
    x[: n // 8, 0] = edges[rng.integers(0, len(edges), n // 8)]
    x[:, 1] = rng.normal(size=n)
    x[::5, 1] = 0.0
    x[::11, 1] = np.nan
    x[::13, 0] = np.nan
    return x


# kernel P's cases, (the split leaf's rows, its left set): the whole root, a
# leaf of one row, a leaf whose rows all go right (empty left child) and one
# whose rows all go left (empty right child), and a deep leaf of scattered
# rows held in the second id buffer
PARTITION_CASES = {"all_rows": ("root", "random"), "one_row": ("one", "random"),
                   "empty_left": ("half", "none"), "empty_right": ("half", "every"),
                   "deep": ("deep", "random")}
# leaves of a partition case: a split at step s <= 6, then step s + 1
_CASE_LEAVES = 9


def partition_case(n: int, B: int, d: int, dtype, case: str, seed: int = 0):
    """(bins (n, d), ids (2, n) int32, seg (9, 2) int32, side (9,) int32,
    node (n,) int32, step s, leaf, in_set (B,) bool) of one of
    :data:`PARTITION_CASES`: the root at step 0; three leaves after two
    steps (``ids[0]`` a permutation, leaf 2 holding one row or half the
    rows, split at step 2); or (``deep``) seven leaves after six steps, laid
    out out of order across both buffers, leaf 5 holding n // 16 scattered
    rows in buffer 1, split at step 6. Where no leaf holds a range, the other
    buffer holds other row ids, so a read from the wrong buffer shows."""
    kind, sets = PARTITION_CASES[case]
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, d)).astype(dtype)
    ids = np.stack([np.arange(n), rng.permutation(n)]).astype(np.int32)
    seg = np.zeros((_CASE_LEAVES, 2), np.int32)
    side = np.zeros(_CASE_LEAVES, np.int32)
    node = np.zeros(n, np.int32)
    s, leaf = 0, 0
    seg[0] = (0, n)
    if kind in ("one", "half"):  # [0, a) leaf 0, [a, a + k) leaf 2, the rest leaf 1
        ids[0] = rng.permutation(n)
        k = 1 if kind == "one" else n // 2
        a = (n - k) // 3
        seg[0], seg[2], seg[1] = (0, a), (a, k), (a + k, n - a - k)
        node[ids[0, a:a + k]] = 2
        node[ids[0, a + k:]] = 1
        s, leaf = 2, 2
    elif kind == "deep":
        perm = rng.permutation(n).astype(np.int32)
        k = max(1, n // 16)
        rest = np.diff(np.linspace(0, n - k, 7).astype(np.int64))
        sizes = dict(zip((3, 0, 1, 6, 2, 4), rest))
        sizes[5] = k
        side[[1, 2, 5]] = 1
        begin = 0
        for j in (3, 0, 5, 1, 6, 2, 4):  # the slices' order in the buffers
            seg[j] = (begin, sizes[j])
            ids[side[j], begin:begin + sizes[j]] = perm[begin:begin + sizes[j]]
            node[perm[begin:begin + sizes[j]]] = j
            begin += sizes[j]
        s, leaf = 6, 5
    in_set = {"random": rng.random(B) < 0.5, "none": np.zeros(B, bool),
              "every": np.ones(B, bool)}[sets]
    return bins, ids, seg, side, node, s, leaf, in_set


def rows_histogrammed(parent: np.ndarray, leaf_counts: np.ndarray) -> Tuple[int, int, int]:
    """(rows of the split leaves, rows of the right children, rows of the
    smaller children) over one tree's split steps, from its replay list
    ``parent`` (L-1,) and the member rows of each final leaf (L,): walking
    the steps backwards, leaf ``s + 1``'s rows fold into ``parent[s]``, so
    each step's two children are known. Kernel P reads the split leaf's
    rows; the full pass's kernel A adds the right child's, the leaf-local
    path's the smaller child's (right iff its count is at most the left's)."""
    counts = np.asarray(leaf_counts, dtype=np.int64).copy()
    split = right = small = 0
    for s in range(len(parent) - 1, -1, -1):
        p = int(parent[s])
        if p < 0:
            continue
        n_r, n_l = int(counts[s + 1]), int(counts[p])
        split += n_l + n_r
        right += n_r
        small += n_r if n_r <= n_l else n_l
        counts[p] += counts[s + 1]
        counts[s + 1] = 0
    return split, right, small


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("the full-pass oracles grow on one device; train without mesh=")


def grow_full_pass(binned, grad, hess, row_weight, feature_mask, cfg: TreeConfig,
                   cat_mask=None, workspace=None, partition=None, mesh=None):
    """``grow.grow_tree`` without the row partition: each step routes every
    row by the split (``node``), histograms the right child over all n rows
    (kernel A's full entry, the rows weighted by ``went_right``) and takes
    the left as parent minus child. The port's growth before kernel P, and
    the reference's full pass: the oracle that ``grow_tree`` equals bit for
    bit wherever histogram sums are exact, and the baseline that
    ``tools/profile_fit.py --ab full_pass`` times. ``partition`` is ignored;
    there is no mesh path (``mesh`` must be None)."""
    _no_mesh(mesh)
    n, d = binned.shape
    ws = workspace if workspace is not None else SplitWorkspace(d, feature_mask, cat_mask,
                                                                 cfg, binned.device)
    hists = ws.hists
    rec = ws.begin_tree()
    hists[0] = histogram(binned, grad, hess, row_weight, cfg.n_bins)
    node = torch.zeros(n, dtype=torch.int32, device=binned.device)
    for s in range(cfg.num_leaves - 1):
        ws.step(s)
        col = torch.index_select(binned, 1, ws.feature)[:, 0]
        go_left = ws.in_set[col.to(torch.int64)]
        went_right = (node == ws.leaf) & ~go_left & ws.ok
        node = torch.where(went_right, s + 1, node)
        child = histogram(binned, grad, hess, row_weight * went_right.to(torch.float32),
                          cfg.n_bins)
        child = torch.where(ws.ok, child, 0.0)  # an inert step changes nothing
        hists[s + 1] = child
        hists.index_add_(0, ws.leaf, child[None], alpha=-1)
    return finish_tree(hists, rec, cfg), node


def _sparse_hist_both(sb, panel, side, out, totals, ctrl, parent=None):
    """``sparse.sparse_hist`` summing both sides from the entries, whatever
    ``ctrl`` asks (no sibling by subtraction)."""
    both = torch.zeros_like(ctrl)
    both[2:].fill_(-1)
    sparse_hist(sb, panel, side, out, totals, both)


def grow_sparse_full_pass(sb, grad, hess, row_weight, feature_mask, cfg: TreeConfig,
                          cat_mask=None, mesh=None):
    """``grow.grow_tree_sparse`` with the reference's full pass: kernel G
    sums both children of every split from the entries, none by
    subtraction from a kept parent. The oracle that ``grow_tree_sparse``
    equals bit for bit wherever histogram sums are exact (no mesh path:
    ``mesh`` must be None)."""
    _no_mesh(mesh)
    shipped = grow.sparse_hist
    grow.sparse_hist = _sparse_hist_both
    try:
        return grow.grow_tree_sparse(sb, grad, hess, row_weight, feature_mask, cfg,
                                     cat_mask=cat_mask)
    finally:
        grow.sparse_hist = shipped


@contextlib.contextmanager
def full_pass():
    """Within the block, ``boost.train`` grows its trees with
    :func:`grow_full_pass` and its sparse trees with
    :func:`grow_sparse_full_pass`."""
    shipped = boost.grow_tree, boost.grow_tree_sparse
    boost.grow_tree, boost.grow_tree_sparse = grow_full_pass, grow_sparse_full_pass
    try:
        yield
    finally:
        boost.grow_tree, boost.grow_tree_sparse = shipped


# kernel G's edge cases (each run in every mode by its tests); the last four
# are small sides, which the rows pass sends down the row walk
SPARSE_HIST_CASES = ("every_row", "empty_features", "one_side", "non_members",
                     "nan_and_zeros", "two_bins", "no_entries", "ragged", "wide_rows",
                     "rows_40", "leaf_1pct", "stop_word", "empty_member_rows")


def sparse_case_inputs(sb: SparseBinned, seed: int, side_of="random"):
    """(panel (n, 4) f32 on ``_preround``'s grid, side (n,) int32, a (2, d,
    B, 3) f32 buffer for the kept histogram) on ``sb``'s device. ``side_of``:
    ``random`` (0, 1 or 2 for non-members), ``left`` (every row 0),
    ``mostly_out`` (nine rows in ten not members), or the (n,) sides."""
    rng = np.random.default_rng(seed)
    n, dev = sb.n, sb.device
    n_bound = 1 << max(n - 1, 1).bit_length()
    gh = np.stack([rng.normal(size=n), rng.random(n) * 0.25], axis=1).astype(np.float32)
    gh = boost._preround(torch.from_numpy(gh), n_bound)
    w = (rng.random(n) < 0.9).astype(np.float32)    # some rows of weight 0 (bagging)
    w_t = torch.from_numpy(w)
    panel = torch.stack([gh[:, 0] * w_t, gh[:, 1] * w_t, w_t, torch.zeros(n)], dim=1)
    if isinstance(side_of, np.ndarray):
        side = side_of
    else:
        side = {"random": lambda: rng.integers(0, 3, n),
                "left": lambda: np.zeros(n, np.int64),
                "mostly_out": lambda: np.where(rng.random(n) < 0.1, rng.integers(0, 2, n),
                                               7)}[side_of]()
    return (panel.contiguous().to(dev), torch.from_numpy(side.astype(np.int32)).to(dev),
            torch.zeros((2, sb.d, sb.n_bins, 3), dtype=torch.float32, device=dev))


def _leaf_sides(rng, n: int, rows: np.ndarray, right: Optional[np.ndarray] = None):
    """(n,) sides: ``rows`` the split leaf's members, each left or right at
    random (``right``: those of them on the right), every other row outside
    it (sides 2, 5 and 9, as other leaves' rows)."""
    side = rng.choice(np.array([2, 5, 9]), n)
    side[rows] = rng.integers(0, 2, len(rows)) if right is None else 0
    if right is not None:
        side[right] = 1
    return side


def sparse_hist_case(case: str, device="cpu", seed: int = 0):
    """One of :data:`SPARSE_HIST_CASES`: (SparseBinned on ``device``, panel,
    side, kept-histogram buffer) from :func:`sparse_case_inputs`.

    ``every_row``: a feature stored in every row, its entries in one cell
    (more entries than one block of kernel G takes); ``empty_features``:
    most features have no entry; ``one_side``: every row on the left;
    ``non_members``: nine rows in ten outside the split leaf; ``nan_and_zeros``:
    NaN values (the compact missing bin) and explicitly stored 0.0;
    ``two_bins``: B = 2; ``no_entries``: nnz = 0; ``ragged``: an entry count
    not a multiple of G's block of entries, with features just under and
    over it; ``wide_rows``: n past the range of a 16-bit index. The small
    sides: ``rows_40``, a leaf of 2,040 rows split 2,000 / 40 (the half
    pass sums the 40); ``leaf_1pct``, a leaf of 1 % of 20,000 rows (in
    both-sides mode, the grower's small leaf whose histograms were not
    kept); ``stop_word``, a feature in every row (a hot feature of the row
    walk: its cells take an add from every member row) over 3,000 sparse
    features and a leaf of 5 % of the rows; ``empty_member_rows``, a leaf
    of 220 rows of which 200 hold no entry."""
    rng = np.random.default_rng([seed, SPARSE_HIST_CASES.index(case)])
    dev = torch.device(device)
    side_of = {"one_side": "left", "non_members": "mostly_out"}.get(case, "random")
    if case == "two_bins":  # B = 2 is below what a mapper realises: entries packed as given
        n, d = 3000, 40
        rows = np.sort(rng.integers(0, n, 9000))
        cols = rng.integers(0, d, 9000)
        key = np.unique(rows.astype(np.int64) * d + cols)
        rows, cols = key // d, key % d
        bins = rng.integers(0, 2, len(rows))
        zero_bin = rng.integers(0, 2, d)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        sb = pack_entries(*(torch.from_numpy(a).to(dev) for a in (rows, cols, bins, indptr)),
                          zero_bin, n, d, 2)
        return (sb, *sparse_case_inputs(sb, seed, side_of))
    n, d, density = {"every_row": (9000, 30, 0.05), "empty_features": (2000, 4096, 0.0005),
                     "no_entries": (500, 64, 0.0), "ragged": (5000, 50, 0.0),
                     "wide_rows": (70_001, 200, 0.01), "leaf_1pct": (20_000, 300, 0.03),
                     "stop_word": (9000, 3000, 0.002),
                     "empty_member_rows": (4000, 300, 0.01)}.get(case, (4000, 300, 0.03))
    dense_rows = rng.random((n, d)) < density if d * n <= 50_000_000 else None
    if case == "empty_member_rows":  # rows below 1,000 hold no entry
        dense_rows[:1000] = False
    rows, cols = (np.nonzero(dense_rows) if dense_rows is not None
                  else (np.zeros(0, int), np.zeros(0, int)))
    vals = rng.integers(1, 6, len(rows)).astype(np.float64)
    extra = []
    if case in ("every_row", "stop_word"):  # feature 3 in every row, value 1 in most
        extra.append((np.arange(n), np.full(n, 3), np.where(rng.random(n) < 0.95, 1.0, 2.0)))
    if case == "ragged":          # 3 * G_ENTRIES + 17 entries; features at G_ENTRIES +- 1
        sizes = [G_ENTRIES - 1, G_ENTRIES + 1, G_ENTRIES, 17, G_ENTRIES - 1]
        for f, k in enumerate(sizes):
            r = np.sort(rng.choice(n, k, replace=False))
            extra.append((r, np.full(k, 10 * f + 1), rng.integers(1, 9, k).astype(float)))
    if case == "nan_and_zeros":
        vals[rng.random(len(vals)) < 0.1] = np.nan
        vals[rng.random(len(vals)) < 0.1] = 0.0
    for r, c, v in extra:
        rows, cols, vals = (np.concatenate(a) for a in ((rows, r), (cols, c), (vals, v)))
    key = rows.astype(np.int64) * d + cols
    key, first = np.unique(key, return_index=True)
    rows, cols, vals = key // d, key % d, vals[first]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    csr = CSRMatrix(indptr, cols, vals, (n, d))
    mapper = BinMapper(max_bin=15).fit_csr(csr)
    sb = build_sparse_binned(csr, mapper, dev)
    if case == "rows_40":
        leaf = rng.permutation(n)[:2040]
        side_of = _leaf_sides(rng, n, leaf, right=leaf[:40])
    elif case in ("leaf_1pct", "stop_word"):
        side_of = _leaf_sides(rng, n, rng.permutation(n)[:n // {"leaf_1pct": 100,
                                                                "stop_word": 20}[case]])
    elif case == "empty_member_rows":
        side_of = _leaf_sides(rng, n, np.concatenate([rng.permutation(1000)[:200],
                                                      1000 + rng.permutation(n - 1000)[:20]]))
    return (sb, *sparse_case_inputs(sb, seed, side_of))


# -- kernel V: the VW learner's batch step ------------------------------------------------

VW_STEP_CASES = ("dup_within_row", "dup_across_rows", "slot0_padding", "slot0_feature",
                 "tail_padding_rows", "hashed_text", "warp_paths")
# batch sizes that reach kernel V's other branches: a bias summed by warp
# shuffles alone (P <= 32), blocks of a 16-block cluster without rows (8), and
# rows the card does not stage in shared memory (2,048 at K >= 101)
VW_ODD_BATCHES = (8, 32, 2048)
# (l1, l2): the sparse regime (only the batch's slots move) and the dense ones
VW_REGIMES = {"sparse": (0.0, 0.0), "l1": (1e-3, 0.0), "l2": (0.0, 1e-2),
              "l1_l2": (1e-3, 1e-2)}


def pairs_column(csr) -> np.ndarray:
    """A :class:`~..gbdt.sparse.CSRMatrix` as the VW featurizer's column: one
    (indices, values) pair a row (uint32 indices)."""
    col = np.empty(csr.shape[0], dtype=object)
    ind, val, ptr = csr.indices.astype(np.uint32), csr.values, csr.indptr
    for i in range(csr.shape[0]):
        col[i] = (ind[ptr[i]:ptr[i + 1]], val[ptr[i]:ptr[i + 1]])
    return col


def vw_state_differs(a, b) -> str:
    """'' when two ``LinearLearnerState`` are equal bit for bit (NaN where
    the other has NaN), else the first field that differs."""
    for f, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        nan = np.isnan(x)
        if x.shape != y.shape or not np.array_equal(nan, np.isnan(y)) or not np.array_equal(
                x[~nan].view(np.int32), y[~nan].view(np.int32)):
            return f
    return ""


def vw_case_batch(name: str) -> int:
    """The batch size a test takes for one of :data:`VW_STEP_CASES`: 256,
    except ``warp_paths``' 300 (not a power of two)."""
    return 300 if name == "warp_paths" else 256


def vw_step_case(name: str, num_bits: int, seed: int = 0):
    """(idx, val, y_regression, y_pm1) of one of :data:`VW_STEP_CASES`, at
    2^``num_bits`` slots: 700 rows (the last batch of 256 is 188 rows and 68
    padding rows) of up to 7 entries, except ``tail_padding_rows`` (522
    rows: the last batch is 246 padding rows), ``hashed_text`` (1,000
    hashed reviews, ``schema_data.hashed_text_rows``, up to ~120 entries)
    and ``warp_paths`` (700 rows of up to K = 131 entries, batches of 300:
    the last one partial).
    - ``dup_within_row``: each row's first three entries share a slot;
    - ``dup_across_rows``: every slot drawn from 12;
    - ``slot0_padding``: ragged rows, no real entry on slot 0;
    - ``slot0_feature``: ragged rows, slot 0 a real feature in a third of
      them (non-zero values, and -0.0), and some (0, +0.0) entries inside
      rows, which act as padding does;
    - ``warp_paths``: kernel V's warp paths: K = 131 (more than a warp's
      128 entries at once, not a multiple of 4), a fifth of the rows full,
      the rest ragged; slot 1 in every row (a list of a whole batch), six
      slots drawn for one entry in a hundred (lists of about 40 entries a
      full batch at 2^10 slots and more: about the long-list threshold),
      slot 0 as padding."""
    rng = np.random.default_rng(seed)
    dim = 1 << num_bits
    if name == "warp_paths":
        n, K = 700, 131
        idx = (2 + rng.integers(0, dim - 2, size=(n, K))).astype(np.int32)
        hot = rng.random((n, K)) < 0.01
        idx[hot] = 2 + rng.integers(0, 6, size=int(hot.sum()))
        idx[:, 0] = 1
        val = (rng.normal(size=(n, K)) * rng.uniform(0.1, 20.0, size=(1, K))).astype(np.float32)
        lens = np.where(rng.random(n) < 0.2, K, rng.integers(1, K + 1, size=n))
        past = np.arange(K)[None, :] >= lens[:, None]
        idx[past] = 0
        val[past] = 0.0
    elif name == "hashed_text":
        from .schema_data import hashed_text_rows

        csr, y01 = hashed_text_rows(seed, 1000, num_bits)
        idx, val = pad_examples(pairs_column(csr), num_bits)
        y_pm1 = np.where(y01 > 0, 1.0, -1.0).astype(np.float32)
        y_reg = (y01 + rng.normal(0.0, 0.5, len(y01))).astype(np.float32)
        return idx, val, y_reg, y_pm1
    else:
        n, K = (522 if name == "tail_padding_rows" else 700), 7
        pool = 12 if name == "dup_across_rows" else dim - 1
        idx = (1 + rng.integers(0, pool, size=(n, K))).astype(np.int32)
        val = (rng.normal(size=(n, K)) * rng.uniform(0.1, 20.0, size=(1, K))).astype(np.float32)
    if name == "dup_within_row":
        idx[:, 1] = idx[:, 0]
        idx[:, 2] = idx[:, 0]
    if name in ("slot0_padding", "slot0_feature", "tail_padding_rows"):
        lens = rng.integers(1, K + 1, size=n)
        past = np.arange(K)[None, :] >= lens[:, None]
        idx[past] = 0
        val[past] = 0.0
    if name == "slot0_feature":
        real = rng.random(n) < 1 / 3
        idx[real, 0] = 0
        val[real & (rng.random(n) < 0.1), 0] = -0.0
        inside = (rng.random(n) < 0.1) & (idx[:, 2] != 0)
        idx[inside, 1] = 0
        val[inside, 1] = 0.0
    w_true = rng.normal(size=dim).astype(np.float32)
    score = (w_true[idx] * val).sum(axis=1)
    y_reg = (score + rng.normal(0.0, 0.3, n)).astype(np.float32)
    y_pm1 = np.where(score > np.median(score), 1.0, -1.0).astype(np.float32)
    return idx, val, y_reg, y_pm1


# -- kernel Q (the quantized ONNX ops' integer GEMM / conv) ------------------------------

Q_KINDS = {"u8": np.uint8, "s8": np.int8}
Q_SIGN_PAIRS = (("u8", "u8"), ("u8", "s8"), ("s8", "u8"), ("s8", "s8"))
# zero-point forms of (A, B): absent, scalar, per row of A, per column of B
Q_ZP_FORMS = (("none", "none"), ("scalar", "scalar"), ("row", "scalar"), ("scalar", "col"),
              ("row", "col"))
# NCHW x OIHW convolutions with the ONNX attributes that reach kernel Q
Q_CONV_CASES = {
    "plain": dict(x=(2, 3, 9, 9), w=(4, 3, 3, 3), attrs={}),
    "pads": dict(x=(1, 4, 7, 8), w=(6, 4, 3, 3), attrs={"pads": [1, 2, 0, 1]}),
    "stride2": dict(x=(2, 3, 11, 11), w=(5, 3, 7, 7), attrs={"strides": [2, 2],
                                                              "pads": [3, 3, 3, 3]}),
    "dilation2": dict(x=(1, 4, 12, 12), w=(4, 4, 3, 3), attrs={"dilations": [2, 2],
                                                                "pads": [2, 2, 2, 2]}),
    "groups": dict(x=(2, 64, 6, 6), w=(64, 2, 3, 3), attrs={"group": 32, "pads": [1, 1, 1, 1],
                                                            "strides": [2, 2],
                                                            "dilations": [2, 2]}),
    "same_upper": dict(x=(1, 2, 6, 5), w=(3, 2, 2, 3), attrs={"auto_pad": "SAME_UPPER"}),
    "1d": dict(x=(2, 3, 10), w=(4, 3, 3), attrs={"pads": [1, 1]}),
}
# NCDHW x OIDHW convolutions: kernel Q's 3-D route, one 2-D launch a depth
# tap; "c3d" is a C3D-style video block (3x3x3, 32 -> 64 channels at 8 x 28 x
# 28), the shape chip_smoke.py times
Q_CONV3D_CASES = {
    "plain": dict(x=(2, 4, 5, 9, 9), w=(6, 4, 3, 3, 3), attrs={}),
    "pads_strides": dict(x=(1, 3, 7, 8, 8), w=(5, 3, 3, 3, 3),
                         attrs={"pads": [1, 1, 1, 1, 2, 0], "strides": [2, 1, 2]}),
    "dilated_groups": dict(x=(2, 4, 6, 7, 7), w=(8, 2, 2, 3, 3),
                           attrs={"dilations": [2, 1, 1], "group": 2,
                                  "pads": [1, 0, 1, 0, 1, 1]}),
    "c3d": dict(x=(2, 32, 8, 28, 28), w=(64, 32, 3, 3, 3), attrs={"pads": [1, 1, 1, 1, 1, 1]}),
}


def _resnet50_convs(n: int = 2) -> Dict[str, dict]:
    """ResNet-50's convolutions at 224 x 224 (the zoo's v1.5 graph), one of
    each shape: the stem, and per stage the first block's 1x1 / 3x3 (stride 2
    from stage 1) / expanding 1x1 / shortcut, and the later blocks' 1x1 and
    3x3."""
    out = {"stem_7x7_s2": dict(x=(n, 3, 224, 224), w=(64, 3, 7, 7),
                               attrs={"strides": [2, 2], "pads": [3, 3, 3, 3]})}
    c, hw = 64, 56
    for stage, width in enumerate((64, 128, 256, 512)):
        s = 1 if stage == 0 else 2
        cout = 4 * width
        o = hw // s
        out[f"s{stage}_first_1x1"] = dict(x=(n, c, hw, hw), w=(width, c, 1, 1), attrs={})
        out[f"s{stage}_first_3x3_s{s}"] = dict(x=(n, width, hw, hw), w=(width, width, 3, 3),
                                               attrs={"strides": [s, s], "pads": [1, 1, 1, 1]})
        out[f"s{stage}_expand_1x1"] = dict(x=(n, width, o, o), w=(cout, width, 1, 1), attrs={})
        out[f"s{stage}_shortcut_s{s}"] = dict(x=(n, c, hw, hw), w=(cout, c, 1, 1),
                                              attrs={"strides": [s, s]})
        out[f"s{stage}_later_1x1"] = dict(x=(n, cout, o, o), w=(width, cout, 1, 1), attrs={})
        out[f"s{stage}_later_3x3"] = dict(x=(n, width, o, o), w=(width, width, 3, 3),
                                          attrs={"pads": [1, 1, 1, 1]})
        c, hw = cout, o
    return out


RESNET50_CONVS = _resnet50_convs()
# (M, K, N) of BERT-base's projections at batch 64 x 128 tokens
BERT_BASE_PROJECTIONS = {"qkvo_768x768": (8192, 768, 768), "ffn1_768x3072": (8192, 768, 3072),
                         "ffn2_3072x768": (8192, 3072, 768)}


def q_seed(*parts) -> int:
    """A stable seed from a case's name parts (Python's str hash is salted)."""
    import zlib

    return zlib.crc32("-".join(str(p) for p in parts).encode())


def q_operand(rng: np.random.Generator, shape, kind: str) -> np.ndarray:
    lo, hi = (0, 256) if kind == "u8" else (-128, 128)
    return rng.integers(lo, hi, size=shape).astype(Q_KINDS[kind])


def q_zero_point(rng: np.random.Generator, kind: str, form: str, n: int):
    """None, a scalar, or n values (per row / column / channel)."""
    if form == "none":
        return None
    return q_operand(rng, () if form == "scalar" else (n,), kind)


# -- kernel R (the ONNX LSTM / GRU steps) ---------------------------------------------------

def rnn_step_case(kind: str, S: int, B: int, H: int, dtype, device="cpu", seed: int = 0,
                  peepholes: bool = True, rb: bool = True):
    """Operands of the LSTM (kind 'LSTM': gx (S, B, 4H), r (4H, H), h0, c0,
    p (3H)) or GRU ('GRU': gx (S, B, 3H), r (3H, H), h0, rb (3H)) steps, from
    a seed, in ``dtype`` on ``device``: gx ~ N(0, 1), R ~ N(0, 1/H)."""
    g = 4 if kind == "LSTM" else 3
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen) * s).to(dtype).to(device)
    out = {"gx": mk(S, B, g * H), "r": mk(g * H, H, s=H ** -0.5), "h0": mk(B, H, s=0.5)}
    if kind == "LSTM":
        out["c0"] = mk(B, H, s=0.5)
        out["p"] = mk(3 * H, s=0.1) if peepholes else None
    else:
        out["rb"] = mk(3 * H, s=0.1) if rb else None
    return out


# -- kernel L (the explainers' lasso) and B's isolation-forest use --------------------

def lasso_case(seed: int, n: int, m: int, k: int, t: int):
    """(X (n, m, k), Y (n, m, t), w (n, m)) f64 for ``n * t`` lasso fits:
    Y = X @ beta + 0.1 noise, half of beta's entries 0 and the rest 1-2 in
    magnitude, weights in [0.5, 1.5]. At alpha = 0.01 (lam = 0.01 m) every
    coefficient's |rho| stays far from lam at the fit's end (about m for a
    live coefficient, sqrt(m)/10 for a zero one), so rounding moves no
    coefficient between 0 and non-zero."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m, k))
    live = rng.random((n, k, t)) < 0.5
    beta = np.where(live, rng.choice([-1.0, 1.0], (n, k, t)) * rng.uniform(1, 2, (n, k, t)),
                    0.0)
    Y = X @ beta + 0.1 * rng.normal(size=(n, m, t))
    return X, Y, rng.uniform(0.5, 1.5, (n, m))


def lasso_cd_order(gram: torch.Tensor, xty: torch.Tensor, sq: torch.Tensor, lam: float,
                   max_iter: int, triangle: bool = True) -> torch.Tensor:
    """Kernel L's arithmetic in torch f32, step for step: ``gram`` (n, k, k),
    ``xty`` (n, t, k), ``sq`` (n, k) -> beta (n, t, k).

    Each fit keeps c = Xty - G beta: step j takes rho = c_j + G_jj b_j, the
    reference's soft threshold and division, and where delta = b_j' - b_j
    is not exactly 0, c <- c - G[j] delta, every product and difference
    rounded on its own. A row of ``gram`` with a NaN or an infinity has a
    NaN diagonal (its rho is NaN at every step, as the reference's dot is).
    ``triangle`` takes G's off-diagonal entries from its upper triangle (the
    kernel's shared-memory path); without it, row j as it lies (the path
    past ``lasso_smem_k()``)."""
    n, t, k = xty.shape
    bad = ~torch.isfinite(gram).all(-1)
    d = torch.where(bad, torch.full_like(sq, float("nan")),
                    torch.diagonal(gram, dim1=1, dim2=2))
    if triangle:
        upper = torch.triu(gram, 1)
        g = upper + upper.transpose(1, 2)
    else:
        g = gram.clone()
    g.diagonal(dim1=1, dim2=2).copy_(d)
    beta = torch.zeros(n, t, k, dtype=torch.float32, device=xty.device)
    c = xty.clone()
    pos = sq > 0
    den = torch.where(pos, sq, torch.ones_like(sq))
    for _ in range(int(max_iter)):
        for j in range(k):
            bj = beta[:, :, j]
            rho = c[:, :, j] + d[:, None, j] * bj
            soft = torch.sign(rho) * torch.clamp(torch.abs(rho) - lam, min=0.0)
            soft = torch.where(torch.isnan(rho), rho, soft)
            new = torch.where(pos[:, None, j], soft / den[:, None, j], torch.zeros_like(soft))
            delta = new - bj
            beta[:, :, j] = new
            c = torch.where((delta != 0)[..., None], c - g[:, None, j, :] * delta[..., None], c)
    return beta


# A coefficient is at a tie where its |rho| lies within LASSO_TIE * lam of
# lam: the sign of |rho| - lam is then a matter of rounding (rho's terms are
# ~m |beta|, a few ulps of them ~1e-4 at m = 1,000), so one order may leave it
# at 0 and another at a value of order (|rho| - lam) / sq.
LASSO_TIE = 1e-4


def lasso_ties(gram: torch.Tensor, xty: torch.Tensor, beta: torch.Tensor,
               lam: float) -> torch.Tensor:
    """(n, t, k) bool: the coefficients of ``beta`` (one descent's result)
    whose rho = Xty_j - gram[j] @ beta + gram[j, j] beta_j lies within
    ``LASSO_TIE * lam`` of +-lam. ``lasso_case`` keeps coefficients clear of
    lam, but over 10^5 coefficients (k past 250, 512 fits) a few land
    there."""
    dot = torch.matmul(beta.unsqueeze(-2), gram.unsqueeze(1).transpose(-1, -2)).squeeze(-2)
    rho = xty - dot + torch.diagonal(gram, dim1=1, dim2=2)[:, None, :] * beta
    return (rho.abs() - lam).abs() <= LASSO_TIE * lam


def forest_rows(seed: int, n: int, d: int) -> np.ndarray:
    """(n, d) f64 rows for an isolation forest: normal inliers, 2 % shifted
    outliers."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    out = rng.random(n) < 0.02
    x[out] += rng.normal(4.0, 1.0, size=(int(out.sum()), d))
    return x


def forest_probe_rows(model, x: np.ndarray) -> np.ndarray:
    """``x`` (f32) with rows that sit on a threshold of each split feature (a
    tie goes left), NaN, +inf and -inf cells appended."""
    feat = np.asarray(model.tree_features)
    thr = np.asarray(model.tree_thresholds)
    x = np.asarray(x, np.float32)
    ties = np.repeat(x[:1], 64, axis=0)
    t, i = np.nonzero(feat >= 0)
    for r in range(64):
        j = r % len(t)
        ties[r, feat[t[j], i[j]]] = thr[t[j], i[j]]
    special = np.repeat(x[:1], 3 * x.shape[1], axis=0)
    for f in range(x.shape[1]):
        special[3 * f:3 * f + 3, f] = (np.nan, np.inf, -np.inf)
    return np.concatenate([x, ties, special])


# kernel K's edge cases (``topk_case``): name -> (rows, n, k) where fixed
TOPK_CASES = ("probe_ties", "probe_signed", "ties", "specials", "all_neg_inf", "k1",
              "k_eq_n", "n1", "ragged_n", "smem_k", "past_smem_k", "long_ties",
              "long_distinct")


def topk_case(case: str, seed: int = 0) -> Tuple[np.ndarray, int]:
    """(scores (rows, n) f32, k) of one of :data:`TOPK_CASES`. The two probe
    rows are the ones where ``torch.topk`` and a descending sort depart from
    ``lax.top_k``; ``ties`` and ``long_ties`` make the k-th value straddle
    a run of equal scores (the lowest indices win), ``specials`` mixes +-NaN,
    +-0.0 and +-inf into normal scores; ``smem_k`` / ``past_smem_k`` put k on
    both sides of ``nn.topk.TOPK_SMEM_K``, the ``long`` cases rows of
    tens of thousands of scores; ``ragged_n`` is no multiple of the block."""
    from ..nn.topk import TOPK_SMEM_K

    rng = np.random.default_rng([seed, 24, TOPK_CASES.index(case)])
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    neg_nan = np.float32(np.copysign(np.nan, -1.0))
    if case == "probe_ties":
        return np.array([[1, 3, 3, nan, -inf, 3, 2]], np.float32), 5
    if case == "probe_signed":
        return np.array([[-0.0, 0.0, 1, neg_nan, nan, -inf, -inf]], np.float32), 7
    if case == "ties":
        return rng.integers(0, 6, (16, 1000)).astype(np.float32), 37
    if case == "specials":
        x = rng.normal(size=(16, 3000)).astype(np.float32)
        pick = rng.integers(0, 8, x.shape)
        for code, v in enumerate((nan, neg_nan, 0.0, -0.0, inf, -inf)):
            x[pick == code] = v
        return x, 600
    if case == "all_neg_inf":
        x = np.full((8, 3000), -inf, np.float32)
        x[1, 17] = 0.0
        return x, 10
    if case == "k1":
        return rng.integers(-3, 3, (32, 777)).astype(np.float32), 1
    if case == "k_eq_n":
        x = rng.integers(-2, 2, (4, 777)).astype(np.float32)
        x[:, ::50] = -0.0
        return x, 777
    if case == "n1":
        return np.array([[2.5], [nan], [-0.0]], np.float32), 1
    if case == "ragged_n":
        return rng.normal(size=(8, 3 * 4096 + 17)).astype(np.float32), 13
    if case in ("smem_k", "past_smem_k"):
        x = np.round(rng.normal(size=(4, 3 * TOPK_SMEM_K)) * 64).astype(np.float32)
        return x, TOPK_SMEM_K + (case == "past_smem_k")
    if case == "long_ties":
        return rng.integers(0, 4, (6, 73_733)).astype(np.float32), 100
    if case == "long_distinct":
        return rng.normal(size=(6, 98_307)).astype(np.float32), 10
    raise KeyError(case)


def same_up_to_ties(idx_a, val_a, idx_b, val_b, tol: float) -> bool:
    """Whether two top-k results (rows of indices and values, largest first,
    finite values) agree but for places traded between scores within
    ``tol`` x max(1, the row's largest |value|): the values agree position by
    position within that, and an index that one result has and the other
    has elsewhere or not at all scores within it of the other's value there
    (or, if absent, of the other's last value)."""
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    val_a, val_b = np.asarray(val_a, np.float64), np.asarray(val_b, np.float64)
    if idx_a.shape != idx_b.shape:
        return False
    for ia, va, ib, vb in zip(idx_a, val_a, idx_b, val_b):
        if len(ia) == 0:
            continue
        eps = tol * max(1.0, float(np.abs(np.concatenate([va, vb])).max()))
        if not np.all(np.abs(va - vb) <= eps):
            return False
        where_b = {int(i): j for j, i in enumerate(ib)}
        for j, i in enumerate(ia):
            if int(i) == int(ib[j]):
                continue
            jb = where_b.get(int(i))
            other = vb[-1] if jb is None else vb[jb]
            if abs(va[j] - other) > eps:
                return False
    return True
