"""The hand kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode: these tests carry the ``cuda`` marker and skip
where no CUDA device is visible. Run them on a machine with an H100:
``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt import sampling
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, _preround, train
from synapseml_tpu_torch.gbdt.device_predict import (BIN_KERNEL, LEAF_KERNEL, SCORE_KERNEL,
                                                     device_bin_cat, device_bin_cat_plain,
                                                     device_leaf_indices, device_raw_scores,
                                                     leaf_indices_plain, pack_feature_table,
                                                     pack_trees, raw_scores_plain)
from synapseml_tpu_torch.gbdt.grow import TreeConfig, grow_tree
from synapseml_tpu_torch.gbdt.histogram import (HIST_KERNEL, HIST_ROWS_KERNEL, SIBLING_KERNEL,
                                                histogram, histogram_plain, histogram_rows,
                                                histogram_rows_plain, sibling)
from synapseml_tpu_torch.gbdt.partition import (PARTITION_KERNEL, PARTITION_MESH_KERNEL,
                                                PARTITION_PICK_KERNEL, RowPartition)
from synapseml_tpu_torch.gbdt.metrics import METRICS
from synapseml_tpu_torch.gbdt.sparse import (G_PATH_STREAM, G_PATH_WALK, SPARSE_HIST_KERNEL,
                                             SPARSE_HIST_MESH_KERNEL, CSRMatrix, g_path,
                                             g_summed_entries, sparse_hist, sparse_hist_mesh,
                                             sparse_hist_plain, sparse_hist_rows_plain)
from synapseml_tpu_torch.gbdt.split_search import (SPLIT_KERNEL, SplitWorkspace,
                                                   split_gains_plain, split_search,
                                                   split_search_plain)
from synapseml_tpu_torch.parallel.flash import (FLASH_F32_KERNEL, KERNEL_HEAD_DIMS,
                                                dense_attention, flash_attention, kernel_for)
from synapseml_tpu_torch.gbdt.lambdarank import (LAMBDARANK_KERNEL, QueryGroups,
                                                 lambda_grads, lambda_grads_plain)
from synapseml_tpu_torch.tools.kernel_cases import (PARTITION_CASES, RANK_CASES,
                                                    bin_edge_case, full_pass, grow_full_pass,
                                                    partition_case,
                                                    bin_ragged_case, check_left_sets,
                                                    check_offgrid, diff_runs, grow_synthetic,
                                                    many_thresholds_rows,
                                                    many_thresholds_text, native_texts,
                                                    offgrid_split_case, rank_case,
                                                    rank_nan_case,
                                                    split_cases, step_cases)
from synapseml_tpu_torch.tools.kernel_cases import SPARSE_HIST_CASES, sparse_hist_case
from synapseml_tpu_torch.tools.kernel_cases import (VW_ODD_BATCHES, VW_REGIMES, VW_STEP_CASES,
                                                    vw_case_batch, vw_state_differs,
                                                    vw_step_case)
from synapseml_tpu_torch.onnx import qgemm as onnx_qgemm
from synapseml_tpu_torch.onnx import rnn as onnx_rnn
from synapseml_tpu_torch.onnx.ops import OPS as ONNX_OPS
from synapseml_tpu_torch.tools.kernel_cases import (BERT_BASE_PROJECTIONS, Q_CONV3D_CASES,
                                                    Q_CONV_CASES,
                                                    Q_SIGN_PAIRS, Q_ZP_FORMS, RESNET50_CONVS,
                                                    q_operand, q_seed, q_zero_point,
                                                    rnn_step_case)
from synapseml_tpu_torch.vw import learner
from synapseml_tpu_torch.vw.learner import LOSSES as VW_LOSSES
from synapseml_tpu_torch.vw.learner import (VW_KERNEL, StepHyper, StepPlan, StepState,
                                            _Scratch, batch_step, batch_step_plain,
                                            step_batches, train_linear, train_linear_plain)
from synapseml_tpu_torch.tools.schema_data import (ADULT_CATEGORICAL, SAMPLED_MODES,
                                                   access_rows, adult_rows, adult_unseen_codes,
                                                   hashed_text_rows, higgs_width_rows,
                                                   movielens_rows, mslr_rows)
from synapseml_tpu_torch.nn import topk as nn_topk
from synapseml_tpu_torch.tools.kernel_cases import TOPK_CASES, same_up_to_ties, topk_case

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


def _replay_lists(seed, T, C, S, d, n_bins, n_cat=0):
    """Replay lists with -1 at any position and splits of leaves that do not
    exist yet (dead), the first ``n_cat`` features categorical (bin -1)."""
    rng = np.random.default_rng(seed)
    parent = np.zeros((T, C, S), np.int32)
    for s in range(S):
        parent[:, :, s] = rng.integers(-1, s + 2, size=(T, C))
    feature = rng.integers(0, d, size=(T, C, S)).astype(np.int32)
    bins = rng.integers(0, n_bins - 1, size=(T, C, S)).astype(np.int32)
    cat_set = None
    if n_cat:
        bins[feature < n_cat] = -1
        cat_set = (rng.random((T, C, S, n_bins)) < 0.5).astype(np.int8)
    leaf = rng.standard_normal((T, C, S + 1)).astype(np.float32)
    return parent, feature, bins, cat_set, leaf, rng.uniform(0.05, 0.3, size=T)


def _check_tree_kernels(cuda, binned, parent, feature, bins, cat_set, leaf, scale):
    """Both entries of kernel B, one launch each, bit-equal to the replay."""
    before = SCORE_KERNEL.launches, LEAF_KERNEL.launches
    out = device_raw_scores(binned, parent, feature, bins, leaf, scale, cat_set)
    leaves = device_leaf_indices(binned, parent, feature, bins, cat_set)
    torch.cuda.synchronize()
    assert (SCORE_KERNEL.launches, LEAF_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, raw_scores_plain(binned, parent, feature, bins, leaf, scale,
                                             cat_set))
    assert torch.equal(leaves, leaf_indices_plain(binned, parent, feature, bins, cat_set))


@pytest.mark.parametrize("dtype,n_bins,d", [(torch.int8, 64, 28), (torch.int16, 256, 28),
                                            (torch.int32, 4096, 30)])
@pytest.mark.parametrize("C", [1, 3, 9])
def test_tree_kernels_bit_equal(cuda, dtype, n_bins, d, C):
    """n = 50,001 is no multiple of the 1024-row tile, T = 13 of no tree chunk."""
    g = torch.Generator(device="cpu").manual_seed(5)
    binned = torch.randint(0, n_bins, (50_001, d), generator=g).to(dtype).to(cuda)
    _check_tree_kernels(cuda, binned, *_replay_lists(C, 13, C, 30, d, n_bins))


@pytest.mark.parametrize("C", [1, 3])
def test_tree_kernels_categorical(cuda, C):
    g = torch.Generator(device="cpu").manual_seed(6)
    binned = torch.randint(0, 256, (20_000, 28), generator=g).to(torch.int16).to(cuda)
    binned[:100, :4] = -3  # negative bins index a category set from its end
    _check_tree_kernels(cuda, binned, *_replay_lists(7 + C, 9, C, 62, 28, 256, n_cat=4))


@pytest.mark.parametrize("case", ["no_splits", "one_row", "chain", "wide_rows", "big_tree",
                                  "wide_records"])
def test_tree_kernels_edge_shapes(cuda, case):
    """S = 0; one row; a chain of 40 splits; rows too wide to stage in shared
    memory (read from global); a tree of 8191 splits, too large for the ring;
    thresholds past int16 (16-byte records)."""
    T, C, S, n, d, n_bins, dtype = {
        "no_splits": (5, 2, 0, 3000, 8, 64, torch.int8),
        "one_row": (6, 3, 20, 1, 8, 64, torch.int8),
        "chain": (4, 1, 40, 3000, 8, 64, torch.int8),
        "wide_rows": (7, 2, 30, 5000, 300, 64, torch.int8),
        "big_tree": (3, 1, 8191, 3000, 8, 64, torch.int8),
        "wide_records": (5, 2, 30, 3000, 8, 40_000, torch.int32)}[case]
    g = torch.Generator(device="cpu").manual_seed(8)
    binned = torch.randint(0, n_bins, (n, d), generator=g).to(dtype).to(cuda)
    parent, feature, bins, cat_set, leaf, scale = _replay_lists(9, T, C, S, d, n_bins)
    if case == "chain":
        parent = np.broadcast_to(np.arange(S, dtype=np.int32), (T, C, S)).copy()
        assert int(pack_trees(parent, feature, bins).depth.max()) == S
    assert pack_trees(parent, feature, bins).narrow == (case != "wide_records")
    _check_tree_kernels(cuda, binned, parent, feature, bins, cat_set, leaf, scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", [(2, 300, 300, 4, 2, 64), (1, 128, 512, 8, 8, 128),
                                   (2, 257, 257, 2, 1, 16),
                                   (1, 300, 700, 4, 2, 32)])  # S_k a multiple of neither 128 nor 256
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, dtype, tol, shape, causal):
    B, Sq, Sk, H, Hkv, D = shape
    g = torch.Generator(device="cpu").manual_seed(2)
    q = torch.randn(B, Sq, H, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Sk, Hkv, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Sk, Hkv, D, generator=g).to(dtype).to(cuda)
    kern = kernel_for(dtype, D)
    before = kern.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = dense_attention(q.float(), k.float(), v.float(), causal=causal)
    assert float((out.float() - ref).abs().max()) <= tol
    if dtype == torch.bfloat16:
        # per-row error against the plain version: one skipped key tile
        # (128 or 256 keys) moves a row of <= 700 keys by > 0.3, rounding by
        # ~2e-3
        rel = (out.float() - ref).norm(dim=-1) / ref.norm(dim=-1)
        assert float(rel.max()) <= 1e-2


@pytest.mark.parametrize("head_dim", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("shape,causal", [
    ((3, 200, 333, 48, 12), True),    # S_q < S_k, ragged, 4 query heads per K/V head, B*H > 132
    ((2, 257, 257, 8, 2), False),     # ragged S, not a multiple of either kernel's tiles
])
def test_flash_bf16_every_head_dim(cuda, head_dim, shape, causal):
    B, Sq, Sk, H, Hkv = shape
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(B, Sq, H, head_dim, generator=g).to(torch.bfloat16).to(cuda)
    k = torch.randn(B, Sk, Hkv, head_dim, generator=g).to(torch.bfloat16).to(cuda)
    v = torch.randn(B, Sk, Hkv, head_dim, generator=g).to(torch.bfloat16).to(cuda)
    kern = kernel_for(torch.bfloat16, head_dim)
    before = kern.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = dense_attention(q.float(), k.float(), v.float(), causal=causal)
    assert float((out.float() - ref).abs().max()) <= 5e-2
    rel = (out.float() - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(rel.max()) <= 1e-2


@pytest.mark.parametrize("head_dim", KERNEL_HEAD_DIMS)
def test_flash_bf16_misaligned_input_raises(cuda, head_dim):
    """TMA reads from 16-byte aligned bases: a tensor that starts 2 bytes into
    its storage is refused before any launch."""
    B, S, H = 1, 128, 2
    buf = torch.zeros(B * S * H * head_dim + 1, dtype=torch.bfloat16, device=cuda)
    q = buf[1:].view(B, S, H, head_dim)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.zeros(B, S, H, head_dim, dtype=torch.bfloat16, device=cuda)
    kern = kernel_for(torch.bfloat16, head_dim)
    before = kern.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k, causal=True)
    assert kern.launches == before


@pytest.mark.parametrize("head_dim", KERNEL_HEAD_DIMS)
def test_flash_f32_misaligned_input_raises(cuda, head_dim):
    """The f32 kernel copies K/V tiles with 16-byte cp.async: a tensor that
    starts 4 bytes into its storage is refused before any launch."""
    B, S, H = 1, 128, 2
    buf = torch.zeros(B * S * H * head_dim + 1, device=cuda)
    k = buf[1:].view(B, S, H, head_dim)
    assert k.is_contiguous() and k.data_ptr() % 16
    q = torch.zeros(B, S, H, head_dim, device=cuda)
    before = FLASH_F32_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, q, causal=False)
    assert FLASH_F32_KERNEL.launches == before


@pytest.mark.parametrize("case", ["sixteenth", "all_zero", "nonfinite"])
def test_histogram_kernel_skip_rule(cuda, case):
    """Rows of weight 0 with finite g and h are skipped; rows with a non-finite
    g or h are kept, so NaN lands in exactly the plain version's cells."""
    g = torch.Generator(device="cpu").manual_seed(4)
    n, d, n_bins = 200_003, 28, 64
    binned = torch.randint(0, n_bins, (n, d), generator=g).to(torch.int8).to(cuda)
    gh = _preround(torch.randn(n, 2, generator=g), 1 << 18).to(cuda)
    grad, hess = gh[:, 0].contiguous(), gh[:, 1].abs().contiguous()
    if case == "all_zero":
        weight = torch.zeros(n, device=cuda)
    else:
        weight = (binned[:, 3].to(torch.int32) < n_bins // 16).to(torch.float32)
    if case == "nonfinite":
        dead = torch.nonzero(weight == 0)[:64, 0]
        grad[dead[:32]] = float("nan")
        hess[dead[32:]] = float("inf")
    before = HIST_KERNEL.launches
    out = histogram(binned, grad, hess, weight, n_bins)
    torch.cuda.synchronize()
    assert HIST_KERNEL.launches == before + 1
    ref = histogram_plain(binned, grad, hess, weight, n_bins)
    if case == "nonfinite":
        assert ref.isnan().any()
        assert torch.equal(out.isnan(), ref.isnan())
        out, ref = out.nan_to_num(), ref.nan_to_num()
    if case == "all_zero":
        assert (out == 0).all() and not torch.signbit(out).any()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.int16, torch.int32])
def test_bin_kernel_edge_cases(cuda, out_dtype):
    """Kernel D bit-equal to its plain version on values on every rounded edge,
    +-inf, NaN, -0.0, unseen categories and edges whose f32 rounding goes up,
    and to the host binning."""
    mapper, probe = bin_edge_case()
    table, lens, flags = (torch.from_numpy(a).to(cuda) for a in pack_feature_table(mapper))
    x = torch.from_numpy(probe).to(cuda)
    before = BIN_KERNEL.launches
    out = device_bin_cat(x, table, lens, flags, mapper.missing_bin, out_dtype)
    torch.cuda.synchronize()
    assert BIN_KERNEL.launches == before + 1 and out.dtype == out_dtype
    assert torch.equal(out, device_bin_cat_plain(x, table, lens, flags, mapper.missing_bin,
                                                 out_dtype))
    np.testing.assert_array_equal(out.cpu().numpy(), mapper.transform(probe))


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("n,d", [(1001, 1), (4099, 13), (333, 300), (3, 1)])
def test_bin_kernel_ragged_tails(cuda, out_dtype, n, d):
    """Kernel D reads 4 elements a load and stores 4 bins at once: n*d not a
    multiple of 4 (or of the 64 rows the first version tiled by), d = 1, 13
    and 300, fewer than 4 elements, and rows that start off a 16-byte
    boundary (the wrapper copies them)."""
    mapper, x_np = bin_ragged_case(n, d)
    table, lens, flags = mapper.device_table(cuda)
    x = torch.from_numpy(x_np).to(cuda)
    shifted = torch.cat([torch.zeros(1, device=cuda), x.reshape(-1)])[1:].view(n, d)
    assert shifted.data_ptr() % 16
    want = device_bin_cat_plain(x, table, lens, flags, mapper.missing_bin, out_dtype)
    np.testing.assert_array_equal(want.cpu().numpy(), mapper.transform(x_np))
    for rows in (x, shifted):
        before = BIN_KERNEL.launches
        out = device_bin_cat(rows, table, lens, flags, mapper.missing_bin, out_dtype)
        torch.cuda.synchronize()
        assert BIN_KERNEL.launches == before + 1
        assert torch.equal(out, want)


@pytest.mark.parametrize("d,max_bin,n_cat", [(28, 63, 0), (14, 255, 8), (300, 255, 10)])
def test_bin_kernel_random_rows(cuda, d, max_bin, n_cat):
    """Whole mappers at the main path's widths (int8 and int16 out), and one
    whose table is too large for shared memory (read through the cache)."""
    rng = np.random.default_rng(d)
    n = 100_003
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, :n_cat] = rng.integers(0, 40, size=(n, n_cat))
    x[rng.random((n, d)) < 0.01] = np.nan
    mapper = BinMapper(max_bin=max_bin, sample_cnt=20_000,
                       categorical_features=list(range(n_cat))).fit(x[: n // 2])
    xt = torch.from_numpy(x).to(cuda)
    before = BIN_KERNEL.launches
    out = mapper.transform_torch(xt)
    torch.cuda.synchronize()
    assert BIN_KERNEL.launches == before + 1
    table, lens, flags = mapper.device_table(xt.device)
    assert torch.equal(out, device_bin_cat_plain(xt, table, lens, flags, mapper.missing_bin,
                                                 out.dtype))
    np.testing.assert_array_equal(out.cpu().numpy(), mapper.transform(x))


@pytest.mark.parametrize("case", ["numeric", "mixed_cat", "max_cat_threshold", "empty_bins",
                                  "ties", "cat_ties", "nan_gain", "masked_l1_l2",
                                  "largest_B", "covertype"])
def test_split_kernel_bit_equal(cuda, case):
    """Kernel E bit-equal (gain, feature, bin) to its plain version on
    histograms on the exact grid."""
    hists, fmask, cmask, n_active, cfg = split_cases()[case]
    args = [None if a is None else torch.from_numpy(a).to(cuda) for a in (hists, fmask, cmask)]
    before = SPLIT_KERNEL.launches
    got = split_search(*args, n_active, cfg)
    torch.cuda.synchronize()
    assert SPLIT_KERNEL.launches == before + 1
    want = split_search_plain(*args, n_active, cfg)
    for a, b, name in zip(got, want, ("gain", "feature", "bin")):
        assert torch.equal(a.isnan(), b.isnan()), name
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), name
    if case == "nan_gain":
        assert want[0].isnan().any()
    if case in ("ties", "cat_ties"):
        assert (want[1] == (2 if case == "ties" else 1)).all()
    # the left set growth rebuilds has the gain the kernel reports
    assert check_left_sets(args[0], args[2], n_active, cfg, got) > 0 or case == "nan_gain"


def test_split_kernel_off_grid(cuda):
    """Off the grid the sums round in another order; wherever the runner-up
    is more than one ulp below the best, the split is the same."""
    hists, fmask, cmask, n_active, cfg = offgrid_split_case()
    args = [torch.from_numpy(a).to(cuda) for a in (hists, fmask, cmask)]
    got = split_search(*args, n_active, cfg)
    held, close = check_offgrid(split_gains_plain(*args, cfg), got)
    assert held >= 25


@pytest.mark.parametrize("case", ["numeric", "mixed_cat", "max_cat_threshold", "empty_bins",
                                  "ties", "cat_ties", "nan_gain", "masked_l1_l2",
                                  "largest_B", "covertype", "inert", "max_depth", "B100"])
def test_split_step_kernel_bit_equal(cuda, case):
    """Kernel E's step entry over every step of a whole tree (histograms
    changing as ``kernel_cases.synthetic_update`` says): one launch a step,
    and the decisions, left sets, record, depths and per-leaf bests bit-equal
    to the plain step on the CPU."""
    hists, fm, cm, _, cfg = step_cases()[case]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        t = [None if a is None else torch.from_numpy(a).to(dev) for a in (hists, fm, cm)]
        ws = SplitWorkspace(t[0].shape[1], t[1], t[2], cfg, dev)
        before = SPLIT_KERNEL.launches
        runs.append(grow_synthetic(ws, t[0]))
        if dev.type == "cuda":
            assert SPLIT_KERNEL.launches == before + cfg.num_leaves - 1
    assert not diff_runs(*runs), "the kernel and the plain step differ"


def test_threefry_uniform_card_equals_cpu(cuda):
    """The reference's stream drawn on the card: bit-equal to the CPU's at
    4M + 3 rows (counters past 2**22, a ragged tail)."""
    key = sampling.fold_in(sampling.prng_key(3), 7)
    n = (1 << 22) + 3
    got = sampling.uniform(key, n, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sampling.uniform(key, n, "cpu"))


def _train_params(extra):
    """schema_data.SAMPLED_MODES' estimator params as train() takes them."""
    params = {("boosting" if k == "boosting_type" else k): v for k, v in extra.items()}
    return dict(objective="binary", num_iterations=3, num_leaves=31, max_bin=63, **params)


@pytest.mark.parametrize("mode", sorted(SAMPLED_MODES))
def test_sampled_fit_card_equals_cpu(cuda, mode):
    """Each training control at 16,384 HIGGS-width rows: the same bags, GOSS
    samples and feature masks on the card and the CPU, so identical trees,
    tree scales and bag sizes, and (with the eval set) the same stop."""
    x, y = higgs_width_rows(1, 16_384 + 4_096)
    params = _train_params(SAMPLED_MODES[mode])
    eval_set = [(x[16_384:], y[16_384:])] if mode == "bagged_eval" else None
    before = SPLIT_KERNEL.launches
    on_card = train(params, x[:16_384], y[:16_384], eval_set=eval_set, device=cuda)
    torch.cuda.synchronize()
    assert SPLIT_KERNEL.launches - before == 3 * 30
    on_cpu = train(params, x[:16_384], y[:16_384], eval_set=eval_set, device="cpu")
    for field in ("parent", "feature", "bin", "tree_scale", "sampled_rows"):
        a, b = getattr(on_card, field), getattr(on_cpu, field)
        assert (a is None and b is None) or np.array_equal(a, b), field
    np.testing.assert_allclose(on_card.leaf_value, on_cpu.leaf_value, rtol=0, atol=0)
    assert on_card.best_iteration == on_cpu.best_iteration
    if eval_set is not None:
        a = [r["eval0_auc"] for r in on_card.evals_result]
        b = [r["eval0_auc"] for r in on_cpu.evals_result]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)  # f32 sums in another order


def test_goss_off_grid_card_close_to_cpu(cuda):
    """GOSS with amp = 4.5 (top_rate=0.1, other_rate=0.2): g * amp leaves the
    exact grid, so the card's atomics may sum a histogram cell in another
    order than the CPU; the stated tolerance holds: held-out AUC within
    0.01, and leaves within 1e-3 wherever the trees are identical."""
    x, y = higgs_width_rows(2, 16_384 + 8_192)
    params = dict(objective="binary", num_iterations=5, num_leaves=31, max_bin=63,
                  boosting="goss", top_rate=0.1, other_rate=0.2)
    on_card = train(params, x[:16_384], y[:16_384], device=cuda)
    on_cpu = train(params, x[:16_384], y[:16_384], device="cpu")
    xe, ye = x[16_384:], y[16_384:]
    aucs = [METRICS["auc"][0](ye, b.raw_predict(xe, device=dev), np.ones(len(ye)))
            for b, dev in ((on_card, cuda), (on_cpu, "cpu"))]
    assert abs(aucs[0] - aucs[1]) <= 0.01
    if all(np.array_equal(getattr(on_card, f), getattr(on_cpu, f))
           for f in ("parent", "feature", "bin")):
        np.testing.assert_allclose(on_card.leaf_value, on_cpu.leaf_value, rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", RANK_CASES)
def test_lambdarank_kernel_bit_equal(cuda, case):
    """Kernel F against its plain version on the card and on the CPU: ties,
    size-1 queries, queries of one label, truncation below the size, sigma
    2.5, zero weights, -0.0 tied with +0.0, truncation 1, truncation past the
    largest query (the two-sided second loop beside the main loop), queries
    of 2,048 and 2,049 documents (the shared-memory boundary) and one of
    20,000 (the global scratch). Same bits: both sum in j order and share
    exp_f32."""
    score, y, w, sizes, truncation, sigma = rank_case(case)
    rows = [torch.from_numpy(a) for a in (score, y, w)]
    on_card = QueryGroups(sizes, y, truncation, cuda)
    before = LAMBDARANK_KERNEL.launches
    g, h = lambda_grads(*(a.to(cuda) for a in rows), on_card, sigma)
    torch.cuda.synchronize()
    assert LAMBDARANK_KERNEL.launches == before + 1
    g_plain, h_plain = lambda_grads_plain(*(a.to(cuda) for a in rows), on_card, sigma)
    assert torch.equal(g, g_plain) and torch.equal(h, h_plain)
    g_cpu, h_cpu = lambda_grads_plain(*rows, QueryGroups(sizes, y, truncation), sigma,
                                      cap=1 << 27)
    assert torch.equal(g.cpu(), g_cpu) and torch.equal(h.cpu(), h_cpu)


def test_lambdarank_kernel_nan_scores(cuda):
    """NaN scores rank after every other score of their query, in index
    order: the plain version's order where each query is its own chunk
    (``cap=1``). Rows agree bit for bit or are NaN in both."""
    score, y, w, sizes, truncation = rank_nan_case()
    rows = [torch.from_numpy(a).to(cuda) for a in (score, y, w)]
    groups = QueryGroups(sizes, y, truncation, cuda)
    got = lambda_grads(*rows, groups)
    want = lambda_grads_plain(*rows, groups, cap=1)
    for a, b in zip(got, want):
        assert torch.isnan(a).any() and torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(b)
        assert torch.equal(a[ok], b[ok])


def test_ranker_fit_card_equals_cpu(cuda):
    """A lambdarank fit at the MSLR schema with an eval set and early
    stopping: kernel F once an iteration, and the CPU's trees, leaves and
    NDCG series."""
    x, y, sizes = mslr_rows(2, 60, 4000)
    xe, ye, se = mslr_rows(2, 20, 1200, part=1)
    params = dict(objective="lambdarank", num_iterations=6, num_leaves=15, max_bin=63,
                  min_data_in_leaf=20, early_stopping_round=2)
    kw = dict(group=sizes, eval_set=[(xe, ye)], eval_group=[se])
    before = LAMBDARANK_KERNEL.launches
    on_card = train(params, x, y, **kw)
    torch.cuda.synchronize()
    assert LAMBDARANK_KERNEL.launches - before == len(on_card.evals_result)
    on_cpu = train(params, x, y, device="cpu", **kw)
    for field in ("parent", "feature", "bin", "leaf_value", "leaf_hess"):
        np.testing.assert_array_equal(getattr(on_card, field), getattr(on_cpu, field))
    assert on_card.evals_result == on_cpu.evals_result
    assert on_card.best_iteration == on_cpu.best_iteration


def test_contrib_on_card_binned_rows_equals_cpu(cuda):
    """TreeSHAP and Saabas of an Adult-schema model (8 categorical columns,
    unseen codes among the probes) on rows binned by kernel D equal the
    CPU's."""
    x, y, _ = adult_rows(0, 20_000)
    booster = train(dict(objective="binary", num_iterations=4, num_leaves=15, max_bin=255,
                         categorical_feature=ADULT_CATEGORICAL), x[:16_384], y[:16_384],
                    device="cpu")
    probe = adult_unseen_codes(x[16_384:], 1, 0.01)
    before = BIN_KERNEL.launches
    on_card = booster.predict_contrib(probe, device="cuda")
    assert BIN_KERNEL.launches == before + 1
    np.testing.assert_array_equal(on_card, booster.predict_contrib(probe, device="cpu"))


@pytest.mark.parametrize("name", sorted(native_texts()))
def test_imported_text_scores_on_card_as_cpu(cuda, name):
    booster = GBDTBooster.from_native_model(native_texts()[name])
    d = booster.mapper.n_features
    probes = np.array([-2.0, -1.0, 0.0, 5e-36, -5e-36, 1e-35, 2e-35, 0.25, 1.5, 3.0, np.nan],
                      np.float32)
    grid = np.stack(np.meshgrid(*([probes] * d), indexing="ij"), -1).reshape(-1, d)
    np.testing.assert_array_equal(booster.raw_predict(grid), booster.raw_predict(grid,
                                                                                 device="cpu"))


@pytest.mark.parametrize("n_thr,zero_split", [(3000, True), (33000, False)])
def test_imported_many_thresholds_card_equals_cpu(cuda, n_thr, zero_split):
    """Thousands of thresholds on one feature: kernel D's table past its
    shared memory, int16 and int32 bins, kernel B's narrow and wide records,
    a set split over 3,000 bins."""
    booster = GBDTBooster.from_native_model(many_thresholds_text(n_thr, zero_split=zero_split))
    x = many_thresholds_rows(booster, 50_000)
    before = (BIN_KERNEL.launches, SCORE_KERNEL.launches, LEAF_KERNEL.launches)
    raw, leaves = booster.raw_predict(x), booster.predict_leaf(x)
    torch.cuda.synchronize()
    assert (BIN_KERNEL.launches, SCORE_KERNEL.launches, LEAF_KERNEL.launches) == tuple(
        b + k for b, k in zip(before, (2, 1, 1)))
    packed = booster._trees_on(booster.num_trees, cuda)[0]
    assert packed.narrow == (n_thr < 32767)
    np.testing.assert_array_equal(raw, booster.raw_predict(x, device="cpu"))
    np.testing.assert_array_equal(leaves, booster.predict_leaf(x, device="cpu"))


def _partition_steps(dev, bins, ids, seg, side, node, steps):
    """Kernel P (on ``dev``) or its plain version (CPU) over ``steps`` of
    (s, leaf, feature, ok, in_set) from one state; the state after each."""
    part = RowPartition(ids.shape[1], seg.shape[0], dev)
    part.begin_tree()
    for t, a in ((part.ids, ids), (part.seg, seg), (part.side, side)):
        t.copy_(torch.from_numpy(a))
    node_t = torch.from_numpy(node.copy()).to(dev)
    bins_t = torch.from_numpy(bins).to(dev)
    states = []
    for s, leaf, feat, ok, in_set in steps:
        part.split(s, bins_t, node_t, torch.tensor([leaf, feat]).to(dev),
                   torch.tensor([ok]).to(dev), torch.from_numpy(in_set).to(dev))
        states.append({name: t.cpu().numpy().copy() for name, t in (
            ("ids", part.ids), ("seg", part.seg), ("side", part.side), ("small", part.small),
            ("smaller_right", part.smaller_right), ("node", node_t))})
    return states


def _same_partition(card, cpu):
    """The same segments, buffers, smaller child and node; each leaf's rows
    the same set, read from the buffer ``side`` names; every row in one leaf."""
    for key in ("seg", "side", "small", "smaller_right", "node"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    rows = []
    for leaf, (b, c) in enumerate(cpu["seg"]):
        got = card["ids"][card["side"][leaf], b:b + c]
        np.testing.assert_array_equal(np.sort(got),
                                      np.sort(cpu["ids"][cpu["side"][leaf], b:b + c]))
        rows.append(got)
    rows = np.concatenate(rows)
    assert np.array_equal(np.sort(rows), np.arange(card["ids"].shape[1]))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("n,d", [(257, 1), (257, 33), (257, 300), (1_000_003, 28)])
@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_kernel_matches_plain(cuda, case, n, d, dtype):
    """Kernel P against the stable partition of its plain version, two steps
    in a row (the case's split, then the new right child's, read from the
    other buffer): at the root (one launch routes every row), a one-row
    leaf, children that come out empty (the second step then splits an
    empty leaf), and a deep leaf of scattered rows in the second buffer."""
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(n, 17, d, dtype, case, seed=d)
    steps = [(s, leaf, d - 1, True, in_set),
             (s + 1, s + 1, 0, True, np.random.default_rng(d).random(17) < 0.5)]
    before = PARTITION_KERNEL.launches
    card = _partition_steps(cuda, bins, ids, seg, side, node, steps)
    torch.cuda.synchronize()
    assert PARTITION_KERNEL.launches == before + 2
    for got, want in zip(card, _partition_steps("cpu", bins, ids, seg, side, node, steps)):
        _same_partition(got, want)


def test_partition_kernel_inert_step(cuda):
    """An inert step changes nothing but the empty smaller child it records;
    the split after it (the same step number) runs as if it had not been."""
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(5000, 9, 4, np.int8, "deep",
                                                                 seed=1)
    steps = [(s, leaf, 0, False, in_set), (s, leaf, 0, True, in_set)]
    card = _partition_steps(cuda, bins, ids, seg, side, node, steps)
    inert = card[0]
    np.testing.assert_array_equal(inert["ids"], ids)
    np.testing.assert_array_equal(inert["seg"], seg)
    np.testing.assert_array_equal(inert["side"], side)
    np.testing.assert_array_equal(inert["node"], node)
    assert inert["small"].tolist() == [0, 0, 0] and bool(inert["smaller_right"][0])
    _same_partition(card[1], _partition_steps("cpu", bins, ids, seg, side, node, steps)[1])


def _rows_case(cuda, n, d, n_bins, dtype, seed):
    """Bins, pre-rounded g and h, 0/1 weights with a NaN g on two rows of
    weight 0, and two id buffers (permutations) of n rows, on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    binned = torch.randint(0, n_bins, (n, d), generator=g, device=cuda).to(dtype)
    gh = _preround(torch.randn(n, 2, generator=g, device=cuda), 1 << 20)
    grad, hess = gh[:, 0].contiguous(), gh[:, 1].contiguous()
    weight = (torch.rand(n, generator=g, device=cuda) < 0.6).to(torch.float32)
    grad[torch.nonzero(weight == 0)[:2, 0]] = float("nan")
    ids = torch.stack([torch.randperm(n, generator=g, device=cuda),
                       torch.randperm(n, generator=g, device=cuda)]).to(torch.int32)
    return binned, grad, hess, weight, ids


def _same_hist(out, want):
    assert torch.equal(out.isnan(), want.isnan())
    torch.testing.assert_close(out.nan_to_num(), want.nan_to_num(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,n_bins,d", [(torch.int8, 31, 1), (torch.int8, 31, 33),
                                            (torch.int16, 256, 300), (torch.int32, 31, 33),
                                            (torch.int32, 4096, 30)])
@pytest.mark.parametrize("span", ["empty", "one_row", "all_rows", "middle"])
def test_histogram_rows_kernel_bit_equal(cuda, span, dtype, n_bins, d):
    """Kernel A's row-list entry against its plain version on pre-rounded
    gradients, 0/1 weights and a NaN g on a row of zero weight: bit-equal
    (NaN in the same cells). d = 33 and 300 walk more than 32 features a
    lane; int32 at 4096 bins takes several feature tiles (grid y)."""
    g = torch.Generator(device="cpu").manual_seed(d)
    n = 100_003
    binned = torch.randint(0, n_bins, (n, d), generator=g).to(dtype)
    gh = _preround(torch.randn(n, 2, generator=g), 1 << 17)
    grad, hess = gh[:, 0].contiguous(), gh[:, 1].contiguous()
    weight = (torch.rand(n, generator=g) < 0.6).to(torch.float32)
    grad[torch.nonzero(weight == 0)[:2, 0]] = float("nan")
    order = torch.randperm(n, generator=g).to(torch.int32)
    ids = torch.stack([order, torch.randperm(n, generator=g).to(torch.int32)])
    span_t = torch.tensor({"empty": (500, 0, 0), "one_row": (7, 1, 0), "all_rows": (0, n, 0),
                           "middle": (1000, 60_000, 0)}[span], dtype=torch.int32)
    args = (binned, grad, hess, weight, n_bins, ids, span_t)
    before = HIST_ROWS_KERNEL.launches
    out = histogram_rows(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    assert HIST_ROWS_KERNEL.launches == before + 1
    _same_hist(out.cpu(), histogram_rows_plain(*args))


@pytest.mark.parametrize("dtype,n_bins,d", [(torch.int8, 64, 28), (torch.int16, 255, 136),
                                            (torch.int16, 255, 300)])
@pytest.mark.parametrize("length", [0, 1, 31, 33, 1024, 1025, 8192, 8193, 20_000, 1_000_003])
def test_histogram_rows_kernel_list_lengths(cuda, length, dtype, n_bins, d):
    """The row-list entry sizes its work from the list on the card: at every
    length around a warp's 32 rows (none active at 0), on both sides of the
    direct path's limit (kDirectRows = 8,192 in csrc/histogram.cu), and on
    the shared-memory path with fewer blocks than the grid (20,000 rows:
    79 blocks of kRowsPerBlock = 256) and with the whole grid; over a list
    in the second id buffer, added into a zeroed buffer, bit-equal to the
    plain version (on the card). d = 136 and 300 at 255 bins take three and
    five feature tiles (grid y), MSLR's width and more."""
    n = 1_000_003
    binned, grad, hess, weight, ids = _rows_case(cuda, n, d, n_bins, dtype, seed=length)
    span = torch.tensor([min(5, n - length), length, 1], dtype=torch.int32, device=cuda)
    out = torch.zeros(d, n_bins, 3, device=cuda)
    before = HIST_ROWS_KERNEL.launches
    got = histogram_rows(binned, grad, hess, weight, n_bins, ids, span, out=out)
    torch.cuda.synchronize()
    assert got is out and HIST_ROWS_KERNEL.launches == before + 1
    _same_hist(out, histogram_rows_plain(binned, grad, hess, weight, n_bins, ids, span))


@pytest.mark.parametrize("shape", [(31, 28, 64), (31, 136, 255), (4, 1, 5)])
@pytest.mark.parametrize("case", ["smaller_right", "smaller_left", "inert"])
def test_sibling_kernel_bit_equal(cuda, case, shape):
    """The epilogue against its plain version (the torch ops it replaced):
    bit for bit, NaN for NaN, with NaN, +-inf and -0.0 in the leaves and the
    child; ``small`` zero afterwards, and leaf s + 1 empty after an inert
    step."""
    L, d, B = shape
    rng = np.random.default_rng(L * d)
    hists = (rng.integers(-64, 64, size=(L, d, B, 3)) / 8).astype(np.float32)
    small = (rng.integers(-64, 64, size=(d, B, 3)) / 8).astype(np.float32)
    for a in (hists.reshape(-1), small.reshape(-1)):
        a[rng.permutation(a.size)[:12]] = [np.nan] * 3 + [np.inf] * 3 + [-np.inf] * 3 + [-0.0] * 3
    s, leaf = L - 2, L // 3
    right = case != "smaller_left"
    if case == "inert":
        small[:] = 0.0
    t = lambda a, dev: torch.from_numpy(a.copy()).to(dev)
    runs = {}
    for dev in (cuda, "cpu"):
        h_t, s_t = t(hists, dev), t(small, dev)
        sibling(h_t, s_t, torch.tensor([leaf], device=dev), torch.tensor([right], device=dev), s)
        runs[str(torch.device(dev).type)] = (h_t.cpu(), s_t.cpu())
    (h_k, s_k), (h_p, s_p) = runs["cuda"], runs["cpu"]
    assert torch.equal(h_k.isnan(), h_p.isnan())
    keep = ~h_k.isnan()
    assert torch.equal(h_k[keep].view(torch.int32), h_p[keep].view(torch.int32))
    assert torch.equal(s_k.view(torch.int32), torch.zeros_like(s_k, dtype=torch.int32))
    if case == "inert":
        assert torch.equal(h_k[:s + 1].nan_to_num(), torch.from_numpy(hists[:s + 1]).nan_to_num())


def test_grow_tree_card_equals_full_pass(cuda):
    """Two 30-step trees on the card from one RowPartition and one
    SplitWorkspace (E, P, A's row list and the epilogue once a step), equal
    to the full pass's on the card and to the CPU's grow_tree."""
    g = torch.Generator(device="cpu").manual_seed(11)
    n, d, B, L = 200_003, 12, 64, 31
    binned = torch.randint(0, B, (n, d), generator=g).to(torch.int8)
    cfg = TreeConfig(n_bins=B, num_leaves=L, min_data_in_leaf=20.0)
    fm = torch.ones(d)
    ws = SplitWorkspace(d, fm.to(cuda), None, cfg, cuda)
    part = RowPartition(n, L, cuda)
    for tree in range(2):
        signal = binned[:, tree].float() / B + 0.3 * binned[:, 5].float() / B
        gh = _preround(torch.stack([signal + 0.1 * torch.randn(n, generator=g),
                                    0.25 + 0.0 * signal], 1), 1 << 18)
        grad, hess = gh[:, 0].contiguous(), gh[:, 1].contiguous()
        weight = (torch.rand(n, generator=g) < 0.8).to(torch.float32)
        args = [a.to(cuda) for a in (binned, grad, hess, weight, fm)]
        before = [k.launches for k in (SPLIT_KERNEL, PARTITION_KERNEL, HIST_ROWS_KERNEL,
                                       SIBLING_KERNEL)]
        got, node = grow_tree(*args, cfg, workspace=ws, partition=part)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip((SPLIT_KERNEL, PARTITION_KERNEL,
                                                HIST_ROWS_KERNEL, SIBLING_KERNEL),
                                               before)] == [L - 1] * 4
        want, want_node = grow_full_pass(*args, cfg)
        cpu, cpu_node = grow_tree(binned, grad, hess, weight, fm, cfg)
        for other, other_node in ((want, want_node), (cpu, cpu_node)):
            fields = ("parent", "feature", "bin", "leaf_value", "leaf_hess")
            for field in fields + (("gain",) if other is want else ()):
                assert torch.equal(getattr(got, field).cpu(), getattr(other, field).cpu()), \
                    (tree, field)
            assert torch.equal(node.cpu(), other_node.cpu())
        assert (got.parent >= 0).sum() == L - 1
        assert not ws.small_hist.any()


@pytest.mark.parametrize("mode", ["binary", "multiclass", "categorical_bagged"])
def test_leaf_local_fit_card_equals_full_pass_and_cpu(cuda, mode):
    """A fit on the card grows over the row partition: kernel P and A's
    row-list entry once a split step, and the same trees and leaves as the
    card's full pass (``kernel_cases.grow_full_pass``) and the CPU's fit."""
    x, y = higgs_width_rows(3, 16_384)
    params = _train_params({})
    classes = 1
    if mode == "multiclass":
        y = np.digitize(x[:, 1] + 0.5 * x[:, 2], [-0.5, 0.5]).astype(np.float64)
        params.update(objective="multiclass", num_class=3)
        classes = 3
    elif mode == "categorical_bagged":
        x = x.copy()
        x[:, 2] = np.random.default_rng(0).integers(0, 12, len(x))
        params.update(categorical_feature=[2], bagging_fraction=0.5, bagging_freq=1,
                      feature_fraction=0.8)
    steps = params["num_iterations"] * classes * (params["num_leaves"] - 1)
    step_kernels = (PARTITION_KERNEL, HIST_ROWS_KERNEL, SIBLING_KERNEL)
    before = [k.launches for k in step_kernels]
    local = train(params, x, y, device=cuda)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(step_kernels, before)] == [steps] * 3
    with full_pass():
        full = train(params, x, y, device=cuda)
    cpu = train(params, x, y, device="cpu")
    for other in (full, cpu):
        for field in ("parent", "feature", "bin", "cat_set", "leaf_value", "leaf_hess",
                      "sampled_rows"):
            a, b = getattr(local, field), getattr(other, field)
            assert (a is None and b is None) or np.array_equal(a, b), field


# kernel G's modes: ctrl (half, slot of the kept histogram, forced side)
G_MODES = {"both_sides": (0, 0, -1), "half_kept_slot0": (1, 0, -1),
           "half_kept_slot1": (1, 1, -1), "forced_left": (1, 0, 0), "forced_right": (1, 1, 1)}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _g_calls(cuda, case, mode):
    """Kernel G twice, the plain version and the row walk's plain twin on one
    case and mode: [(out, totals)] and the path the rows pass chose (read
    back after the first call), with the path the CPU model predicts."""
    sb, panel, side, kept = sparse_hist_case(case, cuda)
    half, slot, forced = G_MODES[mode]
    g = torch.Generator(device="cpu").manual_seed(3)
    kept.copy_(_preround(torch.randn(kept.numel(), 1, generator=g), 1 << 20).view_as(kept))
    parent = kept if half and forced < 0 else None
    ctrl = torch.tensor([half, slot, forced], dtype=torch.int32, device=cuda)
    shape = (2, sb.d, sb.n_bins, 3)
    runs, paths = [], []
    for fn in (sparse_hist, sparse_hist, sparse_hist_plain, sparse_hist_rows_plain):
        out = torch.full(shape, float("nan"), device=cuda)
        tot = torch.full((2, 3), float("nan"), device=cuda)
        before = SPARSE_HIST_KERNEL.launches
        fn(sb, panel, side, out, tot, ctrl, parent)
        torch.cuda.synchronize()
        assert SPARSE_HIST_KERNEL.launches - before == (fn is sparse_hist)
        if fn is sparse_hist:
            paths.append(int(sb.plan.state[1]))
        runs.append((out, tot))
    pl = sb.plan
    assert not (pl.acc.any() or pl.tickets.any() or pl.rowsum.any() or pl.scratch.any()
                or pl.touched.any())
    return sb, runs, paths, g_path(g_summed_entries(sb, side, (half, slot, forced)), sb.nnz)


@pytest.mark.parametrize("mode", sorted(G_MODES))
@pytest.mark.parametrize("case", SPARSE_HIST_CASES)
def test_sparse_hist_kernel_bit_equal(cuda, case, mode):
    """Kernel G against its plain version and the row walk's plain twin on
    the shared edge cases, in each mode, twice (a call must leave its
    scratch, flags and tickets zero), on the path the CPU model predicts."""
    _, runs, paths, want = _g_calls(cuda, case, mode)
    for out, tot in runs[:2] + runs[3:]:
        assert _same_bits(out, runs[2][0]) and _same_bits(tot, runs[2][1])
    assert paths == [want, want]


def test_sparse_hist_kernel_takes_both_paths(cuda):
    """Together the cases drive both of G's paths (read back from ``state``):
    the small sides the row walk in every mode, a whole-leaf pass the
    stream."""
    seen = {}
    for case in SPARSE_HIST_CASES:
        for mode in G_MODES:
            seen[case, mode] = _g_calls(cuda, case, mode)[2][0]
    assert set(seen.values()) == {G_PATH_STREAM, G_PATH_WALK}
    for case in ("rows_40", "leaf_1pct", "stop_word", "empty_member_rows"):
        for mode in G_MODES:
            # rows_40's leaf is half the rows: only its 40-row side is small
            if case != "rows_40" or mode not in ("both_sides", "forced_left"):
                assert seen[case, mode] == G_PATH_WALK, (case, mode)
    assert seen["one_side", "forced_left"] == G_PATH_STREAM


def _sparse_fit_data(kind):
    if kind == "hashed_text":
        x, y = hashed_text_rows(1, 16_384, 14)
        return x, y, {}
    rng = np.random.default_rng(2)
    n, d = 6000, 300
    dense = np.where(rng.random((n, d)) < 0.03, rng.integers(1, 6, (n, d)), 0).astype(float)
    dense[:, 0] = rng.integers(0, 8, n)
    dense[rng.random(n) < 0.05, 1] = np.nan
    y = (np.isin(dense[:, 0], [1, 4, 6]) + 0.5 * dense[:, 2] > 0.5).astype(float)
    if kind == "multiclass_categorical":
        y = (y + (dense[:, 3] > 0)).astype(float)
        return (CSRMatrix.from_scipy(__import__("scipy.sparse").sparse.csr_matrix(dense)), y,
                dict(objective="multiclass", num_class=3, categorical_feature=[0]))
    return (CSRMatrix.from_scipy(__import__("scipy.sparse").sparse.csr_matrix(dense)), y,
            dict(categorical_feature=[0], bagging_fraction=0.5, bagging_freq=1))


@pytest.mark.parametrize("kind,oracle", [("hashed_text", False), ("hashed_text", True),
                                         ("categorical_bagged", True),
                                         ("multiclass_categorical", False)])
def test_sparse_fit_card_equals_cpu(cuda, kind, oracle):
    """A sparse fit on the card: kernel G once at each tree's root and once
    a split step, E's full entry as often, and the CPU's trees, leaves and
    CSR margins; with ``oracle``, the card's full pass
    (``kernel_cases.grow_sparse_full_pass``) gives them too."""
    x, y, extra = _sparse_fit_data(kind)
    params = dict(dict(objective="binary", num_iterations=3, num_leaves=31,
                       min_data_in_leaf=5), **extra)
    classes = params.get("num_class", 1)
    calls = params["num_iterations"] * classes * params["num_leaves"]
    before = SPARSE_HIST_KERNEL.launches, SPLIT_KERNEL.launches
    card = train(params, x, y, device=cuda)
    torch.cuda.synchronize()
    assert (SPARSE_HIST_KERNEL.launches - before[0], SPLIT_KERNEL.launches - before[1]) == \
        (calls, calls)
    others = [train(params, x, y, device="cpu")]
    if oracle:
        with full_pass():
            others.append(train(params, x, y, device=cuda))
    for field in ("parent", "feature", "bin", "cat_set", "leaf_value", "leaf_hess",
                  "sampled_rows"):
        for other in others:
            a, b = getattr(card, field), getattr(other, field)
            assert (a is None and b is None) or np.array_equal(a, b), field
    cpu = others[0]
    assert np.array_equal(card.raw_predict(x), cpu.raw_predict(x, device="cpu"))


def test_grow_tree_sparse_reads_nothing_back(cuda):
    """The sparse grower queues a whole tree, half passes and categorical
    splits included, without a synchronising call (G's plan is made at its
    first call, from pinned memory)."""
    from synapseml_tpu_torch.gbdt.binning import BinMapper
    from synapseml_tpu_torch.gbdt.grow import grow_tree_sparse
    from synapseml_tpu_torch.gbdt.sparse import build_sparse_binned

    x, y, _ = _sparse_fit_data("categorical_bagged")
    mapper = BinMapper(max_bin=63, categorical_features=[0]).fit_csr(x)
    sb = build_sparse_binned(x, mapper, cuda)
    gh = _preround(torch.from_numpy(np.stack([y - 0.5, np.full(len(y), 0.25)], 1)
                                    .astype(np.float32)), 1 << 13).to(cuda)
    w = torch.ones(len(y), device=cuda)
    fm, cm = torch.ones(sb.d, device=cuda), torch.zeros(sb.d, device=cuda)
    cm[0] = 1.0
    cfg = TreeConfig(n_bins=sb.n_bins, num_leaves=31, min_data_in_leaf=5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tree, node = grow_tree_sparse(sb, gh[:, 0], gh[:, 1], w, fm, cfg, cat_mask=cm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tree.parent >= 0).sum() > 0 and (tree.bin < 0).any()


# -- the mesh's entries (their plain twins' CPU tests: tests/test_torch_mesh.py) --------

def _mesh_partition_steps(dev, bins, ids, seg, side, node, steps, flip):
    """Kernel P's mesh entry, then its pick (on ``dev``), or their plain
    twins (CPU), over ``steps`` from one state; between the two the local
    counts get another rank's (``flip``: counts that make the locally
    smaller child the globally larger). The state after each step."""
    part = RowPartition(ids.shape[1], seg.shape[0], dev)
    part.begin_tree()
    for t, a in ((part.ids, ids), (part.seg, seg), (part.side, side)):
        t.copy_(torch.from_numpy(a))
    node_t = torch.from_numpy(node.copy()).to(dev)
    bins_t = torch.from_numpy(bins).to(dev)
    states = []
    for s, leaf, feat, ok, in_set in steps:
        choice, ok_t = torch.tensor([leaf, feat]).to(dev), torch.tensor([ok]).to(dev)
        part.split(s, bins_t, node_t, choice, ok_t, torch.from_numpy(in_set).to(dev),
                   mesh=True)
        local = part.counts.cpu().numpy().copy()
        if flip:
            other = 2 * ids.shape[1] + 1
            extra = [0, other] if local[1] <= local[0] else [other, 0]
            part.counts.add_(torch.tensor(extra, dtype=torch.int32, device=dev))
        part.pick(s, choice, ok_t)
        states.append({name: t.cpu().numpy().copy() for name, t in (
            ("ids", part.ids), ("seg", part.seg), ("side", part.side), ("small", part.small),
            ("smaller_right", part.smaller_right), ("node", node_t))})
        states[-1]["counts"] = local
    return states


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("n,d", [(257, 33), (1_000_003, 28)])
@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_mesh_entry_matches_plain(cuda, case, n, d, flip):
    """Kernel P's mesh entry (routing, local counts) and its pick (the
    smaller child from the counts after another rank's are added) against
    their plain twins, two steps in a row, each entry launched once a
    step; with no other rank's counts the mesh entry and pick ARE the
    one-launch step."""
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(n, 17, d, np.int16, case,
                                                                 seed=d)
    steps = [(s, leaf, d - 1, True, in_set),
             (s + 1, s + 1, 0, True, np.random.default_rng(d).random(17) < 0.5)]
    before = (PARTITION_KERNEL.launches, PARTITION_MESH_KERNEL.launches,
              PARTITION_PICK_KERNEL.launches)
    card = _mesh_partition_steps(cuda, bins, ids, seg, side, node, steps, flip)
    torch.cuda.synchronize()
    assert (PARTITION_KERNEL.launches, PARTITION_MESH_KERNEL.launches,
            PARTITION_PICK_KERNEL.launches) == (before[0], before[1] + 2, before[2] + 2)
    cpu = _mesh_partition_steps("cpu", bins, ids, seg, side, node, steps, flip)
    for got, want in zip(card, cpu):
        _same_partition(got, want)
        np.testing.assert_array_equal(got["counts"], want["counts"])
    if not flip:
        for got, want in zip(card, _partition_steps("cpu", bins, ids, seg, side, node, steps)):
            _same_partition(got, want)


def test_partition_mesh_entry_inert_step(cuda):
    """An inert step: the mesh entry writes counts (0, 0) and moves nothing;
    the pick records the empty child on the right."""
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(5000, 9, 4, np.int8, "deep",
                                                                 seed=1)
    card = _mesh_partition_steps(cuda, bins, ids, seg, side, node,
                                 [(s, leaf, 0, False, in_set)], False)[0]
    assert card["counts"].tolist() == [0, 0]
    np.testing.assert_array_equal(card["ids"], ids)
    np.testing.assert_array_equal(card["node"], node)
    assert card["small"].tolist() == [0, 0, 0] and bool(card["smaller_right"][0])


@pytest.mark.parametrize("forced", [0, 1])
@pytest.mark.parametrize("case", SPARSE_HIST_CASES)
def test_sparse_hist_mesh_entry_bit_equal(cuda, case, forced):
    """Kernel G's mesh use (the side forced, no parent): the forced side's
    histogram and both totals bit-equal to the plain version, the other
    slot left as it was, one launch counted by the mesh entry's counter."""
    sb, panel, side, _ = sparse_hist_case(case, cuda)
    ctrl = torch.tensor([1, 0, forced], dtype=torch.int32, device=cuda)
    shape = (2, sb.d, sb.n_bins, 3)
    runs = []
    for fn in (sparse_hist_mesh, sparse_hist_plain):
        out = torch.full(shape, float("nan"), device=cuda)
        tot = torch.full((2, 3), float("nan"), device=cuda)
        before = (SPARSE_HIST_KERNEL.launches, SPARSE_HIST_MESH_KERNEL.launches)
        fn(sb, panel, side, out, tot, ctrl)
        torch.cuda.synchronize()
        mine = fn is sparse_hist_mesh
        assert (SPARSE_HIST_KERNEL.launches, SPARSE_HIST_MESH_KERNEL.launches) == (
            before[0], before[1] + mine)
        runs.append((out, tot))
    (out, tot), (want, want_tot) = runs
    assert _same_bits(out[forced], want[forced]) and _same_bits(tot, want_tot)
    assert out[1 - forced].isnan().all()


# -- kernel V: the VW learner's batch step ----------------------------------------------

def _vw_card_passes(case, bits, loss, regime, passes, how, batch=None):
    """The state after ``passes`` passes over a case's batches of ``batch``
    rows (default: the case's) on the card from the learner's initial state:
    ``how`` = "whole" (one launch a pass, :func:`step_batches`), "batches"
    (one launch a batch, :func:`batch_step`) or "plain"
    (:func:`batch_step_plain` on the card)."""
    idx, val, y_reg, y_pm1 = vw_step_case(case, bits)
    y = y_pm1 if loss in ("logistic", "hinge") else y_reg
    B, dim = batch or vw_case_batch(case), 1 << bits
    nb = -(-len(y) // B)
    cut = lambda a: torch.from_numpy(np.concatenate(
        [a, np.zeros((nb * B - len(a),) + a.shape[1:], a.dtype)]).reshape(
            (nb, B) + a.shape[1:])).cuda()
    bi, bv, by = cut(idx), cut(val), cut(y.astype(np.float32))
    bw = cut(np.ones(len(y), np.float32))
    l1, l2 = VW_REGIMES[regime]
    hp = StepHyper.make(loss, 0.5, l1, l2, 0.3)
    st = StepState(np.zeros(dim, np.float32), np.full(dim, 1e-6, np.float32), 0.0, 1e-6,
                   np.zeros(dim, np.float32), device="cuda")
    plan, scratch = StepPlan(bi, bv, dim), _Scratch(B, dim, bi.device)
    before = VW_KERNEL.launches
    for p in range(passes):
        if how == "whole":
            step_batches(st, bi, bv, by, bw, hp, plan, 0, nb, scratch)
        for j in range(nb):
            if how == "batches":
                batch_step(st, bi[j], bv[j], by[j], bw[j], hp, plan, j, scratch)
            elif how == "plain":
                batch_step_plain(st, bi[j], bv[j], by[j], bw[j], hp)
    torch.cuda.synchronize()
    return st.numpy(), VW_KERNEL.launches - before, nb


@pytest.mark.parametrize("bits", [10, 18])
@pytest.mark.parametrize("regime", sorted(VW_REGIMES))
@pytest.mark.parametrize("loss", VW_LOSSES)
@pytest.mark.parametrize("case", VW_STEP_CASES)
def test_vw_step_kernel_bit_equal(cuda, case, loss, regime, bits):
    """Kernel V equals the plain step on the card and on the CPU, bit for
    bit, launched a pass at a time (as the fit launches it, once a pass)
    and a batch at a time: duplicate slots within and across rows, slot 0
    as padding and as a feature, a last batch of padding rows, the warp
    paths (K = 131, a slot in every row, batches of 300), each loss and
    regime, 2^10 and 2^18 slots."""
    idx, val, y_reg, y_pm1 = vw_step_case(case, bits)
    y = y_pm1 if loss in ("logistic", "hinge") else y_reg
    l1, l2 = VW_REGIMES[regime]
    kw = dict(num_bits=bits, loss=loss, l1=l1, l2=l2, num_passes=2, quantile_tau=0.3,
              batch_size=vw_case_batch(case))
    VW_KERNEL.launches = 0
    card = train_linear(idx, val, y, device="cuda", **kw)
    torch.cuda.synchronize()
    assert VW_KERNEL.launches == 2  # once a pass
    assert not vw_state_differs(card, train_linear_plain(idx, val, y, device="cuda", **kw))
    assert not vw_state_differs(card, train_linear(idx, val, y, device="cpu", **kw))
    whole, n_whole, nb = _vw_card_passes(case, bits, loss, regime, 2, "whole")
    batches, n_batches, _ = _vw_card_passes(case, bits, loss, regime, 2, "batches")
    plain, _, _ = _vw_card_passes(case, bits, loss, regime, 2, "plain")
    assert (n_whole, n_batches) == (2, 2 * nb)
    assert not vw_state_differs(whole, plain)
    assert not vw_state_differs(batches, plain)


@pytest.mark.parametrize("regime", ["sparse", "l1_l2"])
@pytest.mark.parametrize("loss", VW_LOSSES)
@pytest.mark.parametrize("case", ["slot0_feature", "hashed_text", "warp_paths"])
@pytest.mark.parametrize("batch", VW_ODD_BATCHES)
def test_vw_step_kernel_batch_sizes_bit_equal(cuda, batch, case, loss, regime):
    """Kernel V at batch sizes that reach its other branches: the bias
    summed by shuffles alone (8 and 32 rows), blocks of the cluster without
    rows (8), rows not staged in shared memory (2,048): two passes launched
    whole and batch by batch, each bit-equal to the plain steps on the card,
    at 2^18 slots."""
    whole, n_whole, nb = _vw_card_passes(case, 18, loss, regime, 2, "whole", batch)
    batches, n_batches, _ = _vw_card_passes(case, 18, loss, regime, 2, "batches", batch)
    plain, _, _ = _vw_card_passes(case, 18, loss, regime, 2, "plain", batch)
    assert (n_whole, n_batches) == (2, 2 * nb)
    assert not vw_state_differs(whole, plain)
    assert not vw_state_differs(batches, plain)


@pytest.mark.parametrize("regime", ["sparse", "l2"])
def test_vw_step_kernel_nonfinite_gradient(cuda, regime):
    """An infinite label in a padded row: its padding adds NaN to slot 0, on
    the card as in the plain version (the state goes NaN alike)."""
    idx, val, y_reg, _ = vw_step_case("slot0_padding", 10)
    y_reg = y_reg.copy()
    y_reg[3] = np.inf
    l1, l2 = VW_REGIMES[regime]
    kw = dict(num_bits=10, loss="squared", l1=l1, l2=l2, num_passes=1)
    card = train_linear(idx, val, y_reg, device="cuda", **kw)
    assert np.isnan(card.g2[0])
    assert not vw_state_differs(card, train_linear(idx, val, y_reg, device="cpu", **kw))


def test_vw_step_plan_lists_each_batch_slot_once(cuda):
    """The fit's plan on the card: each batch's distinct slots once, slot 0
    in every batch with padding, the entries of a slot in row-major order,
    the short lists (at most V_LONG_LIST entries) before the long ones."""
    idx, val, _, _ = vw_step_case("slot0_feature", 10)
    bi = torch.from_numpy(np.concatenate([idx, np.zeros((68, 7), np.int32)])).cuda()
    bv = torch.from_numpy(np.concatenate([val, np.zeros((68, 7), np.float32)])).cuda()
    plan = StepPlan(bi.view(3, 256, 7), bv.view(3, 256, 7), 1 << 10, long_list=4)
    ent, useg = plan.ent.cpu().numpy(), plan.useg.cpu().numpy()
    for j, (u0, u1) in enumerate(plan.ranges):
        slots = plan.uslot[u0:u1].cpu().numpy()
        assert len(np.unique(slots)) == len(slots) and 0 in slots
        sizes = np.diff(useg[u0:u1 + 1])
        ul = plan.long_from[j] - u0
        assert 0 < ul < len(slots)
        assert np.all(sizes[:ul] <= 4) and np.all(sizes[ul:] > 4)
        for u in range(u0, u1):
            e = ent[useg[u]:useg[u + 1]]
            e = e[e >= 0]
            assert np.all(np.diff(e) > 0)
            assert np.all(bi.view(3, -1)[j].cpu().numpy()[e] == slots[u - u0])


@pytest.mark.parametrize("what", ["shared_memory", "cluster"])
def test_vw_step_kernel_launch_that_cannot_fit_raises(cuda, what, monkeypatch):
    """A launch the card cannot place raises with the CUDA error's text and
    leaves the state and the launch count as they were: a batch whose dl
    and bias tree do not fit in a block's shared memory (2^16 rows), or a
    cluster of 32 blocks (the H100 takes at most 16)."""
    (B, K), dim = ((1 << 16, 4) if what == "shared_memory" else (256, 4)), 1 << 10
    if what == "cluster":
        monkeypatch.setattr(learner, "V_CLUSTER_CTAS", 32)
    g = torch.Generator().manual_seed(0)
    bi = torch.randint(1, dim, (1, B, K), generator=g, dtype=torch.int32).cuda()
    bv = torch.rand(1, B, K, generator=g).cuda()
    by, bw = torch.ones(1, B, device="cuda"), torch.ones(1, B, device="cuda")
    hp = StepHyper.make("squared", 0.5, 0.0, 0.0, 0.5)
    st = StepState(np.zeros(dim, np.float32), np.full(dim, 1e-6, np.float32), 0.0, 1e-6,
                   np.zeros(dim, np.float32), device="cuda")
    before, buf = VW_KERNEL.launches, st.buf.clone()
    with pytest.raises(RuntimeError, match="smt_vw_step: CUDA error"):
        step_batches(st, bi, bv, by, bw, hp, StepPlan(bi, bv, dim))
    torch.cuda.synchronize()
    assert VW_KERNEL.launches == before and torch.equal(st.buf, buf)


# -- kernel Q: the ONNX integer GEMM / conv --------------------------------------------------

class _Live:
    """A computed ONNX op input (a tensor on the device the op runs on)."""

    def __init__(self, a):
        self.a = np.asarray(a)


def _onnx_op(op_type, inputs, attrs, device):
    ins = [torch.from_numpy(np.array(v.a)).to(device) if isinstance(v, _Live) else v
           for v in inputs]
    out = ONNX_OPS[op_type](ins, dict(attrs), {"op_type": op_type, "opset": 17})
    torch.cuda.synchronize()
    return tuple(o.cpu() for o in out) if isinstance(out, tuple) else out.cpu()


def _q_card_equals_plain(op_type, inputs, attrs=None):
    """The op on the card (kernel Q, one launch) bit-equal to the op on the
    CPU (Q's plain version)."""
    kernel = onnx_qgemm.QCONV_KERNEL if "Conv" in op_type else onnx_qgemm.QMATMUL_KERNEL
    before = kernel.launches
    got = _onnx_op(op_type, inputs, attrs or {}, "cuda")
    assert kernel.launches == before + 1
    want = _onnx_op(op_type, inputs, attrs or {}, "cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{op_type}: {(got != want).sum().item()} values differ"


@pytest.mark.parametrize("ka,kb", Q_SIGN_PAIRS)
@pytest.mark.parametrize("za_form,zb_form", Q_ZP_FORMS)
def test_qgemm_matmul_kernel_bit_equal_to_plain(cuda, ka, kb, za_form, zb_form):
    rng = np.random.default_rng(q_seed(ka, kb, za_form, zb_form, "card"))
    for M, K, N in ((7, 37, 5), (130, 200, 129), (257, 768, 65), (1, 1, 1)):
        a, b = q_operand(rng, (M, K), ka), q_operand(rng, (K, N), kb)
        _q_card_equals_plain("MatMulInteger", [_Live(a), _Live(b),
                                               q_zero_point(rng, ka, za_form, M),
                                               q_zero_point(rng, kb, zb_form, N)])


def test_qgemm_matmul_kernel_batches_broadcasts_and_wraps(cuda):
    rng = np.random.default_rng(1)
    a, b = q_operand(rng, (2, 3, 6, 48), "u8"), q_operand(rng, (48, 4), "s8")
    _q_card_equals_plain("MatMulInteger", [_Live(a), b, np.uint8(9), np.int8(-3)])
    b3 = q_operand(rng, (3, 48, 4), "s8")
    _q_card_equals_plain("MatMulInteger", [_Live(a), _Live(b3), np.uint8(9),
                                           q_operand(rng, (4,), "s8")])
    _q_card_equals_plain("MatMulInteger", [_Live(a[0, 0]), _Live(b3), q_operand(rng, (6,), "u8")])
    _q_card_equals_plain("MatMulInteger", [_Live(a[0, 0, 0]), _Live(b)])   # 1-D A
    # 255 x 127 over 70,000 products passes 2^31: the sum wraps modulo 2^32
    K = 70_000
    _q_card_equals_plain("MatMulInteger", [_Live(np.full((2, K), 255, np.uint8)),
                                           _Live(np.full((K, 3), 127, np.int8))])


@pytest.mark.parametrize("ka,kb", Q_SIGN_PAIRS)
@pytest.mark.parametrize("ky", ["u8", "s8"])
def test_qgemm_qlinear_matmul_epilogue_bit_equal(cuda, ka, kb, ky):
    rng = np.random.default_rng(q_seed(ka, kb, ky, "qlm-card"))
    M, K, N = 300, 160, 70
    a, b = q_operand(rng, (M, K), ka), q_operand(rng, (K, N), kb)
    for per_axis in (False, True):
        _q_card_equals_plain("QLinearMatMul", [
            _Live(a), rng.uniform(0.01, 0.05, size=M if per_axis else ()).astype(np.float32),
            q_operand(rng, (M,) if per_axis else (), ka), _Live(b),
            rng.uniform(0.01, 0.05, size=N if per_axis else ()).astype(np.float32),
            q_operand(rng, (N,) if per_axis else (), kb),
            rng.uniform(0.5, 2.0, size=M if per_axis else ()).astype(np.float32),
            q_operand(rng, (M,) if per_axis else (), ky)])


@pytest.mark.parametrize("case", sorted(Q_CONV_CASES))
@pytest.mark.parametrize("kx,kw", Q_SIGN_PAIRS)
def test_qgemm_conv_kernel_bit_equal_to_plain(cuda, case, kx, kw):
    c = Q_CONV_CASES[case]
    rng = np.random.default_rng(q_seed(case, kx, kw, "card"))
    x, w = q_operand(rng, c["x"], kx), q_operand(rng, c["w"], kw)
    for w_zp in (q_operand(rng, (), kw), q_operand(rng, (c["w"][0],), kw)):
        _q_card_equals_plain("ConvInteger", [_Live(x), _Live(w), q_operand(rng, (), kx), w_zp],
                             c["attrs"])
    _q_card_equals_plain("ConvInteger", [_Live(x), _Live(w)], c["attrs"])
    # the zero point computed on the card (DynamicQuantizeLinear's), read there
    _q_card_equals_plain("ConvInteger", [_Live(x), _Live(w), _Live(q_operand(rng, (), kx))],
                         c["attrs"])


@pytest.mark.parametrize("kx,kw", Q_SIGN_PAIRS)
@pytest.mark.parametrize("ky", ["u8", "s8"])
def test_qgemm_qlinear_conv_epilogue_bit_equal(cuda, kx, kw, ky):
    c = Q_CONV_CASES["groups"]
    rng = np.random.default_rng(q_seed(kx, kw, ky, "qlc-card"))
    x, w = q_operand(rng, c["x"], kx), q_operand(rng, c["w"], kw)
    co = c["w"][0]
    ins = [_Live(x), np.float32(0.021), q_operand(rng, (), kx), _Live(w),
           rng.uniform(0.001, 0.02, size=co).astype(np.float32), q_operand(rng, (co,), kw),
           np.float32(0.37), q_operand(rng, (), ky),
           rng.integers(-5000, 5000, size=co).astype(np.int32)]
    _q_card_equals_plain("QLinearConv", ins, c["attrs"])
    _q_card_equals_plain("QLinearConv", ins[:8], c["attrs"])


@pytest.mark.parametrize("name", sorted(RESNET50_CONVS))
def test_qgemm_resnet50_conv_shapes_bit_equal(cuda, name):
    """Every ResNet-50 convolution shape at 224 x 224 (batch 2), in the
    types quantize_dynamic gives (uint8 activations, int8 weights), a
    scalar and a per-channel weight zero point."""
    c = RESNET50_CONVS[name]
    rng = np.random.default_rng(q_seed(name))
    x, w = q_operand(rng, c["x"], "u8"), q_operand(rng, c["w"], "s8")
    for w_zp in (np.int8(0), q_operand(rng, (c["w"][0],), "s8")):
        _q_card_equals_plain("ConvInteger", [_Live(x), _Live(w), np.uint8(131), w_zp],
                             c["attrs"])


@pytest.mark.parametrize("name", sorted(BERT_BASE_PROJECTIONS))
def test_qgemm_bert_base_projection_shapes_bit_equal(cuda, name):
    M, K, N = BERT_BASE_PROJECTIONS[name]
    rng = np.random.default_rng(q_seed(name))
    a = q_operand(rng, (64, M // 64, K), "u8")   # (batch, tokens, hidden), as the graph has it
    b = q_operand(rng, (K, N), "s8")
    _q_card_equals_plain("MatMulInteger", [_Live(a), b, _Live(np.uint8(117)), np.int8(0)])


@pytest.mark.parametrize("ka,kb", Q_SIGN_PAIRS)
def test_qgemm_wgmma_edges_bit_equal(cuda, ka, kb):
    """M, N and K off the wgmma tile and the TMA box (K = 1, 31, 33, 769: A's
    rows not 16-byte aligned, copied to a padded A), an A that starts off a
    16-byte boundary, B computed on the card (packed a call) and B's zero
    point non-zero and 1-D (the kernel takes A's row sums)."""
    rng = np.random.default_rng(q_seed(ka, kb, "wgmma-edges"))
    for M, K, N in ((1, 1, 1), (129, 31, 65), (200, 33, 257), (64, 769, 64), (130, 256, 384)):
        a, b = q_operand(rng, (M, K), ka), q_operand(rng, (K, N), kb)
        za = q_zero_point(rng, ka, "scalar", M)
        _q_card_equals_plain("MatMulInteger", [_Live(a), _Live(b), za,
                                               q_zero_point(rng, kb, "col", N)])
        _q_card_equals_plain("MatMulInteger", [_Live(a), b, za, q_zero_point(rng, kb, "scalar", N)])
    # A one byte into its storage: the wrapper copies it to an aligned A
    a = torch.from_numpy(q_operand(rng, (97, 65), ka).reshape(-1)).to("cuda")[1:]
    b = torch.from_numpy(q_operand(rng, (96, 70), kb)).to("cuda")
    a2 = a[:96 * 64].reshape(96, 64)
    got = onnx_qgemm.qmatmul(a2, b[:64], a2[0, 0], None)
    want = onnx_qgemm.qmatmul_plain(a2.cpu(), b[:64].cpu(), a2[0, 0].cpu(), None)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kx,kw", Q_SIGN_PAIRS)
def test_qgemm_conv_wgmma_edges_bit_equal(cuda, kx, kw):
    """A per-channel w zero point with groups > 1 and dilation (A's row sums
    in the kernel), the NCHW epilogue at N = 64 and at N not a multiple of 8,
    channel counts that take 16-byte pieces (32) and 4-byte ones (3, 12)."""
    rng = np.random.default_rng(q_seed(kx, kw, "conv-edges"))
    cases = (((2, 32, 9, 9), (64, 32, 3, 3), {"pads": [1, 1, 1, 1]}),
             ((1, 12, 8, 7), (21, 4, 3, 3), {"group": 3, "dilations": [2, 1],
                                             "pads": [2, 1, 2, 1]}),
             ((2, 3, 17, 15), (13, 3, 5, 5), {"strides": [2, 2], "pads": [2, 2, 2, 2]}),
             ((1, 64, 12, 12), (64, 16, 3, 3), {"group": 4, "dilations": [2, 2],
                                                "pads": [2, 2, 2, 2]}))
    for xs, ws, attrs in cases:
        x, w = q_operand(rng, xs, kx), q_operand(rng, ws, kw)
        x_zp = q_operand(rng, (), kx)
        _q_card_equals_plain("ConvInteger", [_Live(x), w, x_zp, q_operand(rng, (ws[0],), kw)],
                             attrs)
        _q_card_equals_plain("ConvInteger", [_Live(x), _Live(w), _Live(x_zp)], attrs)


@pytest.mark.parametrize("kind", ["u8", "s8"])
def test_qgemm_channels_last_kernel_bit_equal(cuda, kind):
    """The conv entry's channels-last copy: pixels off the 64-pixel tile,
    channels padded (3 -> 4, 4 groups of 6 -> 8) with the zero point's byte
    or with 0, channel counts past one 64-channel tile."""
    rng = np.random.default_rng(q_seed(kind, "channels-last"))
    for shape, groups, cin_p in (((2, 3, 17, 15), 1, 4), ((1, 24, 9, 7), 4, 8),
                                 ((3, 160, 5, 13), 1, 160), ((1, 130, 8, 8), 2, 68)):
        x = torch.from_numpy(q_operand(rng, shape, kind)).cuda()
        for zp in (None, torch.from_numpy(q_operand(rng, (), kind)).cuda()):
            before = onnx_qgemm.QCL_KERNEL.launches
            got = onnx_qgemm.channels_last(x, groups, cin_p, zp)
            torch.cuda.synchronize()
            assert onnx_qgemm.QCL_KERNEL.launches == before + 1
            want = onnx_qgemm.channels_last_plain(x.cpu(), groups, cin_p,
                                                  None if zp is None else zp.cpu())
            assert torch.equal(got.cpu(), want)


def test_qgemm_packed_weight_is_the_kernels_b(cuda):
    """A weight packed once (as the executor keeps it) gives the same bits as
    the same weight packed on each call, for both entries."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(q_operand(rng, (300, 200), "u8")).cuda()
    b = torch.from_numpy(q_operand(rng, (200, 96), "s8")).cuda()
    za = torch.tensor(37, dtype=torch.uint8, device="cuda")
    packed = onnx_qgemm.pack_matmul_b(b)
    assert torch.equal(onnx_qgemm.qmatmul(a, b, za, packed=packed),
                       onnx_qgemm.qmatmul(a, b, za))
    x = torch.from_numpy(q_operand(rng, (2, 16, 10, 10), "u8")).cuda()
    w = torch.from_numpy(q_operand(rng, (24, 16, 3, 3), "s8")).cuda()
    pw = onnx_qgemm.pack_conv_w(w)
    assert torch.equal(onnx_qgemm.qconv(x, w, za, None, (1, 1), ((1, 1), (1, 1)), packed=pw),
                       onnx_qgemm.qconv(x, w, za, None, (1, 1), ((1, 1), (1, 1))))


# -- kernel R: the ONNX LSTM / GRU steps -----------------------------------------------------

def _rnn_err(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return float((got - want).abs().max())
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,lbr", [("LSTM", 0), ("GRU", 0), ("GRU", 1)])
def test_rnn_kernel_matches_plain_at_gnmt_width(cuda, kind, lbr, dtype):
    """S=128, B=64, I=H=1024 (GNMT's layer width): within 1e-5 (f32, max
    abs) / 2e-2 (bf16, a row's norm) of the plain version on the card; one
    launch of the wrapper for all S steps."""
    c = rnn_step_case(kind, 128, 64, 1024, dtype, "cuda", seed=3)
    before = onnx_rnn.RNN_KERNEL.launches
    if kind == "LSTM":
        got = onnx_rnn.lstm_steps(c["gx"], c["r"], c["h0"], c["c0"], c["p"], 3.0)
        want = onnx_rnn.lstm_steps_plain(c["gx"], c["r"], c["h0"], c["c0"], c["p"], 3.0)
    else:
        got = onnx_rnn.gru_steps(c["gx"], c["r"], c["h0"], c["rb"], lbr, None)
        want = onnx_rnn.gru_steps_plain(c["gx"], c["r"], c["h0"], c["rb"], lbr, None)
    torch.cuda.synchronize()
    assert onnx_rnn.RNN_KERNEL.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rnn_err(g, w, dtype) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("acts", [("Sigmoid", "Tanh", "Tanh"), ("Relu", "Sigmoid", "Relu"),
                                  ("Tanh", "Relu", "Sigmoid")])
def test_rnn_kernel_ragged_shapes_and_activations(cuda, dtype, acts):
    """Batch and hidden sizes off the kernel's tiles, every activation, a
    clip, no peepholes / no recurrent bias, and a zero-length sequence."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for S, B, H in ((5, 37, 33), (1, 1, 17), (0, 3, 8)):
        c = rnn_step_case("LSTM", S, B, H, dtype, "cuda", seed=S, peepholes=S != 1)
        got = onnx_rnn.lstm_steps(c["gx"], c["r"], c["h0"], c["c0"], c["p"], 1.25, acts)
        want = onnx_rnn.lstm_steps_plain(c["gx"], c["r"], c["h0"], c["c0"], c["p"], 1.25, acts)
        for g, w in zip(got, want):
            assert g.shape == w.shape and (g.numel() == 0 or _rnn_err(g, w, dtype) <= tol)
        for lbr in (0, 1):
            c = rnn_step_case("GRU", S, B, H, dtype, "cuda", seed=S, rb=S != 1)
            got = onnx_rnn.gru_steps(c["gx"], c["r"], c["h0"], c["rb"], lbr, 1.25, acts[:2])
            want = onnx_rnn.gru_steps_plain(c["gx"], c["r"], c["h0"], c["rb"], lbr, 1.25,
                                            acts[:2])
            for g, w in zip(got, want):
                assert g.shape == w.shape and (g.numel() == 0 or _rnn_err(g, w, dtype) <= tol)


def _rnn_both(kind, lbr, S, B, H, dtype, seed, clip=None, acts=None):
    """(got, want) of the LSTM / GRU steps on the card and their plain version."""
    c = rnn_step_case(kind, S, B, H, dtype, "cuda", seed=seed)
    if kind == "LSTM":
        acts = acts or ("Sigmoid", "Tanh", "Tanh")
        return (onnx_rnn.lstm_steps(c["gx"], c["r"], c["h0"], c["c0"], c["p"], clip, acts),
                onnx_rnn.lstm_steps_plain(c["gx"], c["r"], c["h0"], c["c0"], c["p"], clip, acts))
    acts = acts or ("Sigmoid", "Tanh")
    return (onnx_rnn.gru_steps(c["gx"], c["r"], c["h0"], c["rb"], lbr, clip, acts),
            onnx_rnn.gru_steps_plain(c["gx"], c["r"], c["h0"], c["rb"], lbr, clip, acts))


def _rnn_limits():
    return onnx_rnn._card_limits(torch.device("cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,lbr", [("LSTM", 0), ("GRU", 0), ("GRU", 1)])
def test_rnn_persistent_entry_edges(cuda, kind, lbr, dtype):
    """The largest H whose R the persistent entry holds and the next one
    (which takes the one-launch-a-step entry), each entry counted apart; S =
    1 and B off the 64-row chunk (37, 100), on the persistent entry."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    k, bf16 = (0 if kind == "LSTM" else 1), dtype == torch.bfloat16
    sms, smem = _rnn_limits()
    H = 1024
    while onnx_rnn.rnn_plan(k, lbr, bf16, 64, H + 8, sms, smem):
        H += 8
    assert onnx_rnn.rnn_plan(k, lbr, bf16, 64, H, sms, smem)
    for h_, entry in ((H, onnx_rnn.RNN_KERNEL), (H + 8, onnx_rnn.RNN_STEP_KERNEL)):
        before = (onnx_rnn.RNN_KERNEL.launches, onnx_rnn.RNN_STEP_KERNEL.launches)
        got, want = _rnn_both(kind, lbr, 3, 64, h_, dtype, seed=h_)
        torch.cuda.synchronize()
        after = (onnx_rnn.RNN_KERNEL.launches, onnx_rnn.RNN_STEP_KERNEL.launches)
        assert after == tuple(n + (e is entry) for n, e in
                              zip(before, (onnx_rnn.RNN_KERNEL, onnx_rnn.RNN_STEP_KERNEL)))
        for g, w in zip(got, want):
            assert _rnn_err(g, w, dtype) <= tol
    for S, B in ((1, 64), (4, 37), (3, 100)):
        before = onnx_rnn.RNN_KERNEL.launches
        got, want = _rnn_both(kind, lbr, S, B, 256, dtype, seed=S + B)
        torch.cuda.synchronize()
        assert onnx_rnn.RNN_KERNEL.launches == before + 1
        for g, w in zip(got, want):
            assert _rnn_err(g, w, dtype) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("acts", [("Sigmoid", "Tanh", "Tanh"), ("Relu", "Sigmoid", "Relu"),
                                  ("Tanh", "Relu", "Sigmoid")])
def test_rnn_persistent_entry_clip_and_activations(cuda, dtype, acts):
    """Every activation and a clip on the persistent entry (H a multiple of
    8), LSTM and both GRU modes (linear_before_reset=0 under its two grid
    barriers a step)."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for kind, lbr in (("LSTM", 0), ("GRU", 0), ("GRU", 1)):
        before = onnx_rnn.RNN_KERNEL.launches
        got, want = _rnn_both(kind, lbr, 6, 19, 136, dtype, seed=7, clip=1.25,
                              acts=acts if kind == "LSTM" else acts[:2])
        torch.cuda.synchronize()
        assert onnx_rnn.RNN_KERNEL.launches == before + 1
        for g, w in zip(got, want):
            assert _rnn_err(g, w, dtype) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,lbr", [("LSTM", 0), ("GRU", 0), ("GRU", 1)])
def test_rnn_step_entry_at_h2048(cuda, kind, lbr, dtype):
    """H = 2,048 (R past every block's shared memory: the one-launch-a-step
    entry) at B = 64: within 1e-5 (f32) / 2e-2 of a row's norm (bf16) of
    the plain steps; one counted launch of the wrapper, none of the
    persistent entry's."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    sms, smem = _rnn_limits()
    assert onnx_rnn.rnn_plan(0 if kind == "LSTM" else 1, lbr, dtype == torch.bfloat16, 64,
                             2048, sms, smem) is None
    before = (onnx_rnn.RNN_KERNEL.launches, onnx_rnn.RNN_STEP_KERNEL.launches)
    got, want = _rnn_both(kind, lbr, 4, 64, 2048, dtype, seed=11, clip=None)
    torch.cuda.synchronize()
    assert (onnx_rnn.RNN_KERNEL.launches, onnx_rnn.RNN_STEP_KERNEL.launches) == \
        (before[0], before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rnn_err(g, w, dtype) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,lbr", [("LSTM", 0), ("GRU", 0), ("GRU", 1)])
def test_rnn_step_entry_ragged_edges(cuda, kind, lbr, dtype):
    """The step entry's masked edges: B of 1 and 65 (a second, almost empty
    batch tile), H not a multiple of 8 (1,332: 16-byte f32 rows, bf16 by
    plain loads; 1,105: odd) and S = 1, with a clip."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for S, B, H in ((1, 1, 2048), (2, 65, 2048), (3, 65, 1332), (1, 1, 1105), (2, 37, 1105)):
        before = onnx_rnn.RNN_STEP_KERNEL.launches
        got, want = _rnn_both(kind, lbr, S, B, H, dtype, seed=S * B + H, clip=2.5)
        torch.cuda.synchronize()
        assert onnx_rnn.RNN_STEP_KERNEL.launches == before + 1, (S, B, H)
        for g, w in zip(got, want):
            assert g.shape == w.shape and _rnn_err(g, w, dtype) <= tol, (S, B, H)


# -- the ONNX executor on the card -------------------------------------------------------------

def test_onnx_resnet50_on_card_matches_cpu(cuda):
    """The zoo's ResNet-50 at 224 x 224 (batch 2) on the card against the
    port's CPU run: f32 within 1e-4 of each output's max-abs (TF32 off under
    the f32 policy), bf16 within 2e-2 of each row's norm; no Q or R launch."""
    from synapseml_tpu_torch.models import build_model_bytes
    from synapseml_tpu_torch.onnx import OnnxFunction

    mb = build_model_bytes("ResNet50")
    x = np.random.default_rng(0).normal(size=(2, 3, 224, 224)).astype(np.float32)
    launches = (onnx_qgemm.QCONV_KERNEL.launches, onnx_qgemm.QMATMUL_KERNEL.launches,
                onnx_rnn.RNN_KERNEL.launches)
    for policy, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        card = OnnxFunction(mb, dtype_policy=policy)({"data": x})
        cpu = OnnxFunction(mb, dtype_policy=policy, device="cpu")({"data": x})
        for k in ("logits", "features"):
            g, w = card[k].cpu().double(), cpu[k].double()
            assert card[k].device.type == "cuda" and card[k].dtype == torch.float32
            if policy == "float32":
                assert float((g - w).abs().max()) <= tol * float(w.abs().max())
            else:
                assert float(((g - w).norm(dim=1) / w.norm(dim=1)).max()) <= tol
    assert launches == (onnx_qgemm.QCONV_KERNEL.launches, onnx_qgemm.QMATMUL_KERNEL.launches,
                        onnx_rnn.RNN_KERNEL.launches)


def test_onnx_quantized_graphs_launch_q_and_recurrent_launch_r(cuda):
    """quantize_dynamic_graph of ResNet-18 launches kernel Q's conv entry once
    for each of its 20 convolutions, of BERTTiny its matmul entry once for
    each of its 14 weighted MatMuls; an LSTM graph launches R once; each
    holds the port's CPU run."""
    from synapseml_tpu_torch.models.zoo import bert_encoder, resnet
    from synapseml_tpu_torch.onnx import OnnxFunction
    from synapseml_tpu_torch.onnx.wire import serialize_model
    from synapseml_tpu_torch.tools.onnx_graphs import quantize_dynamic_graph, recurrent_graph

    cases = [(quantize_dynamic_graph(resnet(18, num_classes=10)), onnx_qgemm.QCONV_KERNEL, 20,
              {"data": np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32)}),
             (quantize_dynamic_graph(bert_encoder(layers=2, hidden=128, heads=2, vocab=1000)),
              onnx_qgemm.QMATMUL_KERNEL, 14,
              {"input_ids": np.random.default_rng(2).integers(0, 1000, (2, 16))}),
             (recurrent_graph("LSTM", 12, 4, 16, 32, peepholes=True, clip=2.0),
              onnx_rnn.RNN_KERNEL, 1,
              {"x": np.random.default_rng(3).normal(size=(12, 4, 16)).astype(np.float32)})]
    for model, kernel, n, feeds in cases:
        mb = serialize_model(model)
        fn = OnnxFunction(mb)
        before = kernel.launches
        card = fn(feeds)
        torch.cuda.synchronize()
        assert kernel.launches == before + n
        cpu = OnnxFunction(mb, device="cpu")(feeds)
        for k, w in cpu.items():
            g = card[k].cpu().double().reshape(-1, w.shape[-1])
            w = w.double().reshape(-1, w.shape[-1])
            assert float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)).max()) <= 2e-2


# -- kernel C's log-sum-exp entries -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("shape,causal", [((2, 300, 333, 4, 2), True),
                                          ((1, 257, 257, 3, 3), False),
                                          ((2, 130, 130, 4, 1), True)])
def test_flash_lse_matches_plain(cuda, dtype, head_dim, shape, causal):
    """The lse entry writes each row's log-sum-exp within 1e-4 of the plain
    version's (relative to max(1, |lse|); f32 and bf16 scores are f32 sums of
    the same products), and its output is the output of the entry without
    lse, bit for bit."""
    B, Sq, Sk, H, Hkv = shape
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(B, Sq, H, head_dim, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, Sk, Hkv, head_dim, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, Sk, Hkv, head_dim, generator=g).to(dtype).to(cuda)
    kern = kernel_for(dtype, head_dim, lse=True)
    before = kern.launches
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _, want = dense_attention(q.float(), k.float(), v.float(), causal=causal,
                              return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    err = ((lse - want).abs() / want.abs().clamp(min=1.0)).max()
    assert float(err) <= 1e-4, float(err)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


# -- kernel Q's 3-D convolution, and the ops whose card values were undefined --------------------

@pytest.mark.parametrize("case", sorted(Q_CONV3D_CASES))
@pytest.mark.parametrize("op", ["ConvInteger", "QLinearConv"])
def test_qgemm_conv3d_bit_equal_to_plain(cuda, case, op):
    """A 3-D ConvInteger / QLinearConv on the card: kernel Q's 2-D conv once a
    depth tap, bit-equal to the 3-D plain version on the CPU."""
    c = Q_CONV3D_CASES[case]
    rng = np.random.default_rng(q_seed(case, op, "conv3d"))
    x, w = q_operand(rng, c["x"], "u8"), q_operand(rng, c["w"], "s8")
    co = c["w"][0]
    if op == "ConvInteger":
        ins = [_Live(x), w, np.uint8(117), q_operand(rng, (co,), "s8")]
    else:
        ins = [_Live(x), np.float32(0.02), np.uint8(117), w,
               rng.uniform(0.001, 0.02, size=co).astype(np.float32), q_operand(rng, (co,), "s8"),
               np.float32(0.4), np.uint8(128), rng.integers(-5000, 5000, co).astype(np.int32)]
    before = onnx_qgemm.QCONV_KERNEL.launches
    got = _onnx_op(op, ins, c["attrs"], "cuda")
    assert onnx_qgemm.QCONV_KERNEL.launches == before + c["w"][2]   # one a depth tap
    want = _onnx_op(op, ins, c["attrs"], "cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{(got != want).sum().item()} values differ"


# the reference's values (``synapseml_tpu/onnx/ops.py`` on the CPU), which
# the CPU tests hold the port to (``tests/test_torch_onnx.py``)
_CARD_OP_CASES = {
    "cast_int32": ("Cast", [np.array([1e10, -1e10, np.nan, np.inf, 3e9, -2.7], np.float32)],
                   {"to": 6}, [2147483647, -2147483648, 0, 2147483647, 2147483647, -2]),
    "cast_uint8": ("Cast", [np.array([-1.7, 300, np.nan, 254.9], np.float32)], {"to": 2},
                   [0, 255, 0, 254]),
    "cast_int8": ("Cast", [np.array([-1.7, 300, np.nan, -200, 1e9], np.float32)], {"to": 3},
                  [-1, 127, 0, -128, 127]),
    "mod_int32": ("Mod", [np.array([5, -5, 7, -7], np.int32), np.array([0, 0, 3, 3], np.int32)],
                  {}, [0, 0, 1, 2]),
    "mod_int64": ("Mod", [np.array([5, -5, 7, -7], np.int64), np.array([0, 0, 3, 3], np.int64)],
                  {}, [0, 0, 1, 2]),
}


@pytest.mark.parametrize("case", sorted(_CARD_OP_CASES))
def test_cast_and_integer_mod_on_the_card_give_the_reference_values(cuda, case):
    op, ins, attrs, want = _CARD_OP_CASES[case]
    got = _onnx_op(op, [_Live(a) for a in ins], attrs, "cuda")
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    np.testing.assert_array_equal(got.numpy(), _onnx_op(op, [_Live(a) for a in ins], attrs,
                                                        "cpu").numpy())


# -- kernel L (the explainers' lasso), B's isolation-forest use, the blur ------------

from synapseml_tpu_torch.explainers import regression as expl_regression  # noqa: E402
from synapseml_tpu_torch.image import ops as image_ops  # noqa: E402
from synapseml_tpu_torch.isolationforest import forest as iforest  # noqa: E402
from synapseml_tpu_torch.tools.kernel_cases import (forest_probe_rows, forest_rows,  # noqa: E402
                                                    lasso_case, lasso_cd_order)


def _lasso_system(dev, n, m, k, t, seed=0):
    X, Y, w = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
               for a in lasso_case(seed, n, m, k, t))
    *_, Xr, Yr = expl_regression.rescaled(X, Y, w)
    return expl_regression.lasso_system(Xr, Yr)


def _lasso_k(spec: str) -> int:
    limit = expl_regression.lasso_smem_k()
    return {"limit": limit, "past_limit": limit + 1}.get(spec) or int(spec)


@pytest.mark.parametrize("t", [1, 2, 5])
@pytest.mark.parametrize("k", ["32", "200", "limit", "past_limit"])
def test_lasso_kernel_matches_plain_below_and_above_the_smem_limit(cuda, k, t):
    """512 fits' worth of L's cases at LIME's 1,000 samples on both sides
    of the shared-memory limit: within LASSO_TOL of the plain version with
    the same zero coefficients, bit-equal to the order model
    (``lasso_cd_order``: the upper triangle up to the limit, row j as it
    lies past it), one launch a batch."""
    limit = expl_regression.lasso_smem_k()
    assert 300 <= limit <= 352                      # 336 on the H100's 227 KB
    assert expl_regression.lasso_plan(limit, 1) == (True, 1)
    assert expl_regression.lasso_plan(limit + 1, 9) == (False, 8)
    k = _lasso_k(k)
    gram, xty, sq = _lasso_system(cuda, 6, 1000, k, t)
    lam = 0.01 * 1000
    before = expl_regression.LASSO_KERNEL.launches
    got = expl_regression.lasso_cd(gram, xty, sq, lam, 100)
    torch.cuda.synchronize()
    assert expl_regression.LASSO_KERNEL.launches == before + 1
    want = expl_regression.lasso_cd_plain(gram, xty, sq, lam, 100)
    err = (got - want).abs().max().item()
    assert err <= expl_regression.LASSO_TOL * max(1.0, want.abs().max().item()), err
    assert torch.equal(got == 0, want == 0)
    order = lasso_cd_order(gram, xty, sq, lam, 100, triangle=k <= limit)
    assert torch.equal(got, order), (got - order).abs().max().item()


@pytest.mark.parametrize("k", ["40", "past_limit"])
def test_lasso_kernel_nan_fit(cuda, k):
    """A NaN in one instance's Gram matrix (off the diagonal, one side
    only) and an infinity in another's: NaN wherever the plain version has
    NaN, the rest as the order model, the clean instance as without them."""
    k = _lasso_k(k)
    gram, xty, sq = _lasso_system(cuda, 3, 600, k, 2)
    lam = 0.01 * 600
    clean = expl_regression.lasso_cd(gram, xty, sq, lam, 20)
    gram[1, k - 3, 2] = float("nan")
    gram[2, 5, 5] = float("inf")
    got = expl_regression.lasso_cd(gram, xty, sq, lam, 20)
    want = expl_regression.lasso_cd_plain(gram, xty, sq, lam, 20)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[1:]).any()
    order = lasso_cd_order(gram, xty, sq, lam, 20, triangle=k <= expl_regression.lasso_smem_k())
    torch.testing.assert_close(got, order, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got[0], clean[0])


def test_lasso_kernel_edge_cases(cuda):
    gram, xty, sq = _lasso_system(cuda, 3, 300, 40, 3)
    sq[1, 5] = 0.0                                  # a zero-variance column: beta 0
    got = expl_regression.lasso_cd(gram, xty, sq, 3.0, 7)
    want = expl_regression.lasso_cd_plain(gram, xty, sq, 3.0, 7)
    assert (got[1, :, 5] == 0).all()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    zero = expl_regression.lasso_cd(gram, xty, sq, 3.0, 0)   # no sweep: beta stays 0
    assert (zero == 0).all()
    huge = expl_regression.lasso_cd(gram, xty, sq, 1e12, 3)  # lam above every |rho|
    assert (huge == 0).all()


def test_fit_regression_batch_on_the_card_matches_the_cpu(cuda):
    X, Y, w = lasso_case(1, 5, 400, 12, 2)
    X[:, :, 10:] = 0.0                              # padded columns
    for alpha in (0.0, 0.01):
        a = expl_regression.fit_regression_batch(X, Y, w, alpha=alpha, device="cuda")
        b = expl_regression.fit_regression_batch(X, Y, w, alpha=alpha, device="cpu")
        assert (a.coefficients[:, :, 10:] == 0).all()
        np.testing.assert_allclose(a.coefficients, b.coefficients, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.r_squared, b.r_squared, rtol=1e-5, atol=1e-5)


def test_forest_through_b_matches_the_heap_descent(cuda):
    from synapseml_tpu_torch.core import Table

    x = forest_rows(0, 20_000, 28)
    model = iforest.IsolationForest(num_estimators=100, max_samples=256, random_seed=3,
                                    device="cpu").fit(Table({"features": x}))
    probe = torch.from_numpy(forest_probe_rows(model, x)).to(cuda)
    before = iforest.IFOREST_KERNEL.launches
    got = model.score_tensor(probe)
    torch.cuda.synchronize()
    assert iforest.IFOREST_KERNEL.launches == before + 1
    T = np.shape(model.tree_features)[0]
    heap = iforest.path_lengths_plain(probe, model.tree_features, model.tree_thresholds,
                                      model.tree_path_lens, model.depth_limit)
    want = iforest.scores_from_total(heap, T, model.c_norm)
    assert torch.equal(got, want), (got - want).abs().max().item()
    # the CPU's pow rounds a score an ulp apart from the card's at most
    cpu = model.score_tensor(probe.cpu())
    assert (got.cpu() - cpu).abs().max().item() <= 1e-6


def test_blur_and_resize_stay_f32_with_tf32_switched_on(cuda):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, (4, 301, 257, 3)).astype(np.uint8))
        for fn in (lambda t: image_ops.gaussian_blur(t, 7, -1.0),
                   lambda t: image_ops.box_blur(t, 5, 3),
                   lambda t: image_ops.resize(t, 224, 190),
                   lambda t: image_ops.resize(t, 512, 400, "cubic")):
            got, want = fn(x.to(cuda)).cpu(), fn(x)
            err = (got - want).abs().max().item()
            assert err <= 2e-4, err                 # TF32 would be ~1e-1 at 255
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# -- kernel K (the top-k in lax.top_k's order) and the paths that rank with it ---------------

@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_kernel_bit_equal_to_plain(cuda, case):
    x, k = topk_case(case)
    xd = torch.from_numpy(x).to(cuda)
    before = nn_topk.TOPK_KERNEL.launches
    v, i = nn_topk.topk_select(xd, k)
    torch.cuda.synchronize()
    assert nn_topk.TOPK_KERNEL.launches == before + 1
    pv, pi = nn_topk.topk_select_plain(xd, k)
    assert torch.equal(i, pi)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("n,k", [(1_048_576, 10), (262_144, 5), (10_677, 10)])
def test_topk_kernel_at_the_phase_shapes(cuda, n, k):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(64, n, device=cuda, generator=g)
    x[::3] = torch.round(x[::3] * 8)            # rows of heavy ties
    x[5, ::7] = -float("inf")
    v, i = nn_topk.topk_select(x, k)
    pv, pi = nn_topk.topk_select_plain(x, k)
    assert torch.equal(i, pi) and torch.equal(v.view(torch.int32), pv.view(torch.int32))


def _knn_tables(seed, n, d, nq, labels=None):
    from synapseml_tpu_torch.core import Table

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + nq, d)).astype(np.float32)
    cols = {"features": x[:n], "values": np.arange(n)}
    q = {"features": x[n:]}
    if labels:
        cols["labels"] = rng.integers(0, labels, n)
        conds = np.empty(nq, dtype=object)
        for r in range(nq):
            conds[r] = rng.choice(labels, size=int(rng.integers(1, 3)), replace=False).tolist()
        q["conditioner"] = conds
    return Table(cols), Table(q)


def _knn_arrays(out):
    return (np.array([[m["value"] for m in r] for r in out["output"]]),
            np.array([[m["distance"] for m in r] for r in out["output"]]))


@pytest.mark.parametrize("conditional", [False, True])
def test_knn_on_the_card_matches_the_cpu(cuda, conditional):
    from synapseml_tpu_torch.nn import ConditionalKNN, KNN

    keys, queries = _knn_tables(1, 50_000, 64, 300, labels=4 if conditional else None)
    est = (ConditionalKNN if conditional else KNN)(k=7)
    model = est.fit(keys)
    before = nn_topk.TOPK_KERNEL.launches
    gi, gv = _knn_arrays(model.transform(queries))
    assert nn_topk.TOPK_KERNEL.launches > before
    cpu = type(model).from_state(model.state_dict(), device="cpu")
    wi, wv = _knn_arrays(cpu.transform(queries))
    assert same_up_to_ties(gi, gv, wi, wv, nn_topk.TOPK_TIE_TOL)


def test_sar_on_the_card_matches_the_cpu(cuda):
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.recommendation import SAR

    u, i, r, t = small_movielens(3)
    table = Table({"user": u, "item": i, "rating": r, "time": t})
    card = SAR().fit(table)
    cpu = SAR(device="cpu").fit(table)
    for name in ("user_affinity", "item_similarity"):
        a, b = np.asarray(card.get(name)), np.asarray(cpu.get(name))
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name
    before = nn_topk.TOPK_KERNEL.launches
    got = card.recommend_for_all_users(10, remove_seen=True)
    assert nn_topk.TOPK_KERNEL.launches > before
    want = cpu.recommend_for_all_users(10, remove_seen=True)
    arr = lambda t: (np.array([[x[0] for x in row] for row in t["recommendations"]]),
                     np.array([[x[1] for x in row] for row in t["recommendations"]]))
    gi, gv = arr(got)
    wi, wv = arr(want)
    assert same_up_to_ties(gi, gv, wi, wv, nn_topk.TOPK_TIE_TOL)
    pairs = Table({"user": u[:5000], "item": i[::-1][:5000]})
    np.testing.assert_allclose(card.transform(pairs)["prediction"],
                               cpu.transform(pairs)["prediction"], rtol=1e-5, atol=1e-6)


def small_movielens(seed):
    """A small MovieLens-shaped log (3,000 users x 800 items)."""
    return movielens_rows(seed, 3000, 800, 60_000)


def test_anomaly_on_the_card_matches_the_cpu(cuda):
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.cyber import AccessAnomaly
    from synapseml_tpu_torch.cyber import anomaly as cyber_anomaly

    cols = access_rows(4, [("a", 2000, 400, 40_000), ("b", 500, 100, 8_000)])
    card = AccessAnomaly().fit(Table(cols))
    cpu = AccessAnomaly(device="cpu").fit(Table(cols))
    assert card.user_components == cpu.user_components
    probe = {k: cols[k][::3] for k in ("tenant", "user", "res")}
    probe["res"] = np.roll(probe["res"], 1)
    a = np.asarray(card.transform(Table(probe))["anomaly_score"])
    b = np.asarray(cpu.transform(Table(probe))["anomaly_score"])
    for kind in (np.isnan, np.isposinf, lambda s: s == 0.0):
        assert np.array_equal(kind(a), kind(b))
    ok = np.isfinite(b)
    assert cyber_anomaly.scores_agree(a[ok], b[ok]), np.abs(a[ok] - b[ok]).max()
