"""Kernel E's step entry on the CPU: the plain step, which rescores only the
leaves the last step changed, against full rescoring (the reference's step:
``split_search_plain`` over every leaf, the depth-capped argmax and
``left_set``), at every step of whole trees."""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt.boost import _preround
from synapseml_tpu_torch.gbdt.grow import TreeConfig, grow_tree
from synapseml_tpu_torch.gbdt.split_search import (SplitWorkspace, left_set,
                                                   split_search_plain)
from synapseml_tpu_torch.tools.kernel_cases import step_cases, synthetic_update

STEP_CASES = ["numeric", "mixed_cat", "max_cat_threshold", "empty_bins", "ties", "cat_ties",
              "nan_gain", "masked_l1_l2", "largest_B", "covertype", "inert", "max_depth",
              "B100"]


def full_step(hists, depth, s, fmask, cmask, cfg):
    """Step ``s`` as the reference takes it, from every leaf's histogram."""
    gain, feat, bins = split_search_plain(hists, fmask, cmask, s + 1, cfg)
    if cfg.max_depth > 0:
        gain = torch.where(depth < cfg.max_depth, gain, float("-inf"))
    l = int(torch.argmax(gain))
    ok = bool(gain[l] > max(cfg.min_gain_to_split, 0.0))
    f, b = int(feat[l]), int(bins[l])
    is_cat = cmask is not None and bool(cmask[f] > 0)
    in_set = left_set(hists[l, f], torch.tensor(is_cat), b, cfg)
    new_depth = depth.clone()
    if ok:
        new_depth[s + 1] = new_depth[l] = depth[l] + 1
    return dict(parent=l if ok else -1, feature=f, bin=-1 if is_cat else b,
                gain=float(gain[l]) if ok else 0.0, cat_set=in_set & is_cat & ok,
                leaf=l, ok=ok, in_set=in_set & ok, depth=new_depth)


def _same_float(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or a == b


def check_step(ws: SplitWorkspace, s: int, fmask, cmask) -> dict:
    """Take step ``s`` on ``ws`` and hold everything it wrote to full
    rescoring of the same histograms; returns the reference's step."""
    want = full_step(ws.hists.clone(), ws.depth.clone() if s else torch.zeros_like(ws.depth),
                     s, fmask, cmask, ws.cfg)
    SplitWorkspace.step(ws, s)
    rec = ws.record
    got = dict(parent=int(rec.parent[s]), feature=int(rec.feature[s]), bin=int(rec.bin[s]),
               leaf=int(ws.leaf), ok=bool(ws.ok))
    for key, value in got.items():
        assert value == want[key], f"step {s}: {key} {value}, full rescoring {want[key]}"
    assert int(ws.feature) == want["feature"]
    assert _same_float(float(rec.gain[s]), want["gain"]), f"step {s}: gain"
    assert torch.equal(ws.in_set, want["in_set"]), f"step {s}: left set"
    if rec.cat_set is not None:
        assert torch.equal(rec.cat_set[s], want["cat_set"].to(torch.int8)), f"step {s}"
    assert torch.equal(ws.depth, want["depth"]), f"step {s}: depth"
    return want


@pytest.mark.parametrize("case", STEP_CASES)
def test_plain_step_equals_full_rescoring(case):
    """Every step of a whole tree over a case's histograms (as
    ``synthetic_update`` changes them): the same record, decision, left set
    and depths as full rescoring."""
    hists, fm, cm, _, cfg = step_cases()[case]
    pool = torch.from_numpy(hists)
    fmask = torch.from_numpy(fm)
    cmask = None if cm is None else torch.from_numpy(cm)
    ws = SplitWorkspace(pool.shape[1], fmask, cmask, cfg, "cpu")
    ws.begin_tree()
    ws.hists[0] = pool[0]
    oks, nan_steps, cross_leaf_ties = [], 0, 0
    for s in range(cfg.num_leaves - 1):
        want = check_step(ws, s, fmask, cmask)
        oks.append(want["ok"])
        gains = ws.leaf_gain[:s + 1]
        nan_steps += bool(gains.isnan().any())
        best = gains[want["leaf"]]
        cross_leaf_ties += int((gains == best).sum()) > 1
        synthetic_update(ws, pool, s)
    if case == "nan_gain":  # a NaN gain wins the argmax, and NaN > 0 is false
        assert nan_steps > 0 and not any(oks)
    else:
        assert any(oks)
    if case == "inert":
        assert not all(oks)
    if case in ("ties", "numeric", "mixed_cat"):
        assert cross_leaf_ties > 0
    if case == "max_depth":
        assert int(ws.depth.max()) <= cfg.max_depth and not all(oks)


class _CheckedWorkspace(SplitWorkspace):
    """A workspace whose every step is held to full rescoring."""

    def step(self, s):
        check_step(self, s, self.fmask, self.cmask)


@pytest.mark.parametrize("max_depth,min_gain", [(-1, 0.0), (3, 0.0), (-1, 0.5)])
def test_grown_trees_equal_full_rescoring(max_depth, min_gain):
    """Whole trees grown from rows (routing and kernel A's plain version
    between the steps), categorical features included, a depth cap, and a
    min_gain_to_split that leaves inert steps."""
    rng = np.random.default_rng(3)
    n, d, B = 4000, 7, 40
    binned = rng.integers(0, B - 1, size=(n, d)).astype(np.int8)
    binned[:, 1] = binned[:, 4]                          # ties across features
    g = _preround(torch.from_numpy(0.5 - (binned[:, 0] > 20) + 0.1 * rng.normal(size=n))
                  .to(torch.float32)[:, None], 4096)[:, 0]
    h = _preround(torch.from_numpy(0.25 + 0.0 * rng.normal(size=n)).to(torch.float32)[:, None],
                  4096)[:, 0]
    cmask = torch.tensor([0, 1, 0, 0, 1, 0, 0], dtype=torch.float32)
    fmask = torch.ones(d)
    cfg = TreeConfig(n_bins=B, num_leaves=15, max_depth=max_depth, min_gain_to_split=min_gain,
                     min_data_in_leaf=5.0)
    ws = _CheckedWorkspace(d, fmask, cmask, cfg, "cpu")
    for _ in range(2):  # a second tree reuses the workspace
        tree, _ = grow_tree(torch.from_numpy(binned), g, h, torch.ones(n), fmask, cfg,
                            cat_mask=cmask, workspace=ws)
    assert (tree.parent >= 0).any()
    if min_gain > 0:
        assert (tree.parent < 0).any()


def test_workspace_checks():
    cfg = TreeConfig(n_bins=16, num_leaves=4)
    ws = SplitWorkspace(3, torch.ones(3), None, cfg, "cpu")
    with pytest.raises(ValueError, match="workspace made for"):
        grow_tree(torch.zeros((10, 4), dtype=torch.int8), torch.zeros(10), torch.ones(10),
                  torch.ones(10), torch.ones(4), cfg, workspace=ws)
    with pytest.raises(TypeError, match="feature_mask"):
        SplitWorkspace(3, torch.ones(4), None, cfg, "cpu")
