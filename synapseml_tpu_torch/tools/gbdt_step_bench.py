"""Time kernels D, E, A's row list, P and G of a tree, and its fits' growth.

    python synapseml_tpu_torch/tools/gbdt_step_bench.py [--tree DIR] [--seed 0]
        [--only split,bin,growth,leaves,sparse] [--rows-cache FILE.npz]
    python synapseml_tpu_torch/tools/gbdt_step_bench.py --ab DIR DIR ... [--rounds 2]

Measures the ``synapseml_tpu_torch`` found in ``--tree`` (default: the tree
holding this file), so the same command times an older tree unpacked beside
this one; run it as a script, not with ``python -m``. ``--ab`` runs one
process per tree and round, in the given order and reversed every other
round (``--rounds 2`` over parent and change: parent, change, change,
parent). ``--only`` picks the benches (default: all but ``sparse``). One
JSON line per measurement, with the card's name and power limit. Needs a
CUDA device.

- ``split``: E, at the split steps of the three fits of ``chip_smoke.py``
  (L=31; HIGGS d=28 B=64; Adult d=14 B=256, 8 categorical; Covertype d=12
  B=256, 2 categorical), on histograms on the pre-rounded grid: ``table``,
  the full-table entry ``split_search`` over every leaf; ``step``, the
  decision half of growth step 15 as the tree's grower takes it -- in a
  tree with ``SplitWorkspace``, its step entry (one launch, rescoring two
  leaves), in an older tree, ``split_search`` over the active leaves and the
  torch ops that chose the split and wrote the record. Device time from a
  ``torch.profiler`` trace of 200 calls (all the call's kernels), and time a
  call from the host (CUDA events over 500 back-to-back calls).
- ``bin``: D, at the HIGGS and Adult fits' training rows (4,194,304 x 28 f32
  to int8, 63 bins; 4,194,304 x 14 to int16, 255 bins, 8 categorical): CUDA
  events over 20 launches, beside its bound (each f32 read once, each bin
  written once, at 3.35 TB/s) and the f32 ``torch.searchsorted`` over the
  packed table on rows already transposed.
- ``growth``: a warm ``train`` of each ``tools/schema_data.py::FITS`` fit
  (HIGGS, Adult, Covertype, MSLR; as ``tools/profile_fit.py`` fits them) and
  of HIGGS at 16,384 rows, traced by ``torch.profiler``: A's row-list
  device ms and launches, P's device ms, the epilogue's device ms (0 in a
  tree without it), kernel launches a split step, device busy s (also
  without the host -> device copies, ``busy_without_htod_s``, and without
  any copy or fill, ``kernel_busy_s``) and the fit's wall s.
- ``leaves``: device time a launch (a trace of 20) of A's row-list entry
  and of P over a leaf of 40, 1,024, 8,192, 16,384, 131,072 and 2,097,152 rows
  drawn at random from 4,194,304 HIGGS-width rows (28 int8 bins, 64 bins),
  split on feature 3 at bin 31 (P's state restored before each launch), and
  of A's row list at MSLR's width (2,270,296 rows, 136 int16 bins, 255 bins,
  three feature tiles), and of P at those leaves and at the root (every row
  in order). A tuning variant (A's ``kDirectRows`` or ``kRowsPerBlock``,
  P's ``kMaxBlocksPerSm``) is a copy of the tree with that constant of
  ``csrc/`` edited, timed beside the tree with ``--ab``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
STEP = 15                     # the growth step timed (of 30)
LEAF_ROWS = (40, 1024, 8192, 16_384, 131_072, 2_097_152)  # leaves of the leaves bench
# (name, rows, d, B, bin type) of the leaves bench's rows: HIGGS's width, and
# MSLR's (three feature tiles of A)
LEAF_WIDTHS = (("higgs", 4_194_304, 28, 64, torch.int8),
               ("mslr", 2_270_296, 136, 255, torch.int16))
# name: (d, B, categorical features)
SPLIT_SHAPES = {"higgs": (28, 64, []), "adult": (14, 256, [1, 3, 5, 6, 7, 8, 9, 13]),
                "covertype": (12, 256, [10, 11])}
BENCHES = ("split", "bin", "growth", "leaves", "sparse")
# listed rows of the small leaves at which kernel G is timed
SPARSE_LEAVES = (1024, 40)


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call: its kernels' time in a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    from synapseml_tpu_torch.tools.profile_fit import _device_us

    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def grid_hists(rng, L, d, B, unit=2.0 ** -8):
    """(L, d, B, 3) f32 histograms on a summation-exact grid, a fifth empty."""
    G = rng.integers(-64, 65, size=(L, d, B)) * unit
    H = rng.integers(1, 65, size=(L, d, B)) * unit
    C = rng.integers(1, 60, size=(L, d, B)).astype(np.float64)
    live = rng.random((L, d, B)) >= 0.2
    return np.stack([G * live, H * live, C * live], -1).astype(np.float32)


def old_step(split_search, left_set, hists, fmask, cmask, cfg, rec, s):
    """The decision half of a growth step as the grower took it before the
    step entry: the search over the active leaves, then torch ops."""
    dev = hists.device
    B = hists.shape[2]
    parent, feat, bin_, gains, cat_sets, depth = rec
    leaf_gain, leaf_f, leaf_b = split_search(hists, fmask, cmask, s + 1, cfg)
    l = torch.argmax(leaf_gain)
    g_best = leaf_gain[l]
    ok = g_best > max(cfg.min_gain_to_split, 0.0)
    f_sel = leaf_f[l].to(torch.int64)
    b_sel = leaf_b[l].to(torch.int64)
    if cmask is None:
        in_set = torch.arange(B, device=dev) <= b_sel
        is_cat = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        is_cat = cmask[f_sel] > 0
        in_set = left_set(hists[l, f_sel], is_cat, b_sel, cfg)
    parent[s] = torch.where(ok, l, -1).to(torch.int32)
    feat[s] = f_sel.to(torch.int32)
    bin_[s] = torch.where(is_cat, -1, b_sel).to(torch.int32)
    gains[s] = torch.where(ok, g_best, 0.0).to(torch.float32)
    if cat_sets is not None:
        cat_sets[s] = (in_set & is_cat & ok).to(torch.int8)
    child_depth = torch.where(ok, depth[l] + 1, depth[l]).to(torch.int32)
    new_depth = depth.clone()
    new_depth[s + 1] = child_depth
    new_depth.index_copy_(0, l.reshape(1), child_depth.reshape(1))
    rec[5] = torch.where(ok, new_depth, depth)
    return in_set


def bench_split(card, seed, dev):
    from synapseml_tpu_torch.gbdt import grow
    from synapseml_tpu_torch.gbdt import split_search as ss

    rng = np.random.default_rng(seed)
    for name, (d, B, cats) in SPLIT_SHAPES.items():
        L = 31
        cfg = grow.TreeConfig(n_bins=B, num_leaves=L)
        hists = torch.from_numpy(grid_hists(rng, L, d, B)).to(dev)
        fmask = torch.ones(d, device=dev)
        cmask = None
        if cats:
            cmask = torch.zeros(d, device=dev)
            cmask[cats] = 1.0
        rows = {"table": lambda: ss.split_search(hists, fmask, cmask, L, cfg)}
        if hasattr(ss, "SplitWorkspace"):
            ws = ss.SplitWorkspace(d, fmask, cmask, cfg, dev)
            rec = ws.begin_tree()
            ws.hists.copy_(hists)
            for s in range(STEP):  # a tree to step 15; leaf 14's parent is split
                ws.step(s)
            rec.parent[STEP - 1] = 0
            rows["step"] = lambda: ws.step(STEP)
            leaves = 2
            entry = "SplitWorkspace.step"
        else:
            rec = [torch.full((L - 1,), -1, dtype=torch.int32, device=dev),
                   torch.zeros(L - 1, dtype=torch.int32, device=dev),
                   torch.zeros(L - 1, dtype=torch.int32, device=dev),
                   torch.zeros(L - 1, dtype=torch.float32, device=dev),
                   None if cmask is None else torch.zeros((L - 1, B), dtype=torch.int8,
                                                          device=dev),
                   torch.zeros(L, dtype=torch.int32, device=dev)]
            rows["step"] = lambda: old_step(ss.split_search, grow.left_set, hists, fmask,
                                            cmask, cfg, rec, STEP)
            leaves = L
            entry = "split_search + torch decision ops"
        for kind, fn in rows.items():
            n_bytes = (L if kind == "table" else leaves) * d * B * 12
            print(json.dumps({
                "kernel": "E", "shape": name, "L": L, "d": d, "B": B, "categorical": len(cats),
                "entry": "split_search" if kind == "table" else entry, "kind": kind,
                "device_ms": device_ms(fn, 200), "call_ms": time_ms(fn, 500),
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "card": card}), flush=True)


def bench_bin(card, seed, dev):
    from synapseml_tpu_torch.gbdt import binning
    from synapseml_tpu_torch.gbdt import device_predict as dp
    from synapseml_tpu_torch.tools import schema_data as sd

    n = 4_194_304
    x_h = np.random.default_rng(seed).standard_normal((n, 28), dtype=np.float32)
    x_a = sd.adult_rows(seed, n)[0]
    for name, x, mapper in (
            ("higgs_fit", x_h, binning.BinMapper(max_bin=63)),
            ("adult_fit", x_a, binning.BinMapper(max_bin=255,
                                                 categorical_features=sd.ADULT_CATEGORICAL))):
        mapper.fit(x)
        xd = torch.from_numpy(x).to(dev)
        table, lens, flags = mapper.device_table(dev)
        out_dt = binning.torch_bin_dtype(mapper.n_bins)
        run = lambda: dp.device_bin_cat(xd, table, lens, flags, mapper.missing_bin, out_dt)
        got = run()
        ms = time_ms(run, 20)
        xt = xd.t().contiguous()
        lib_ms = time_ms(lambda: torch.searchsorted(table, xt, side="left"), 20)
        n_bytes = x.shape[0] * x.shape[1] * (4 + got.element_size())
        print(json.dumps({
            "kernel": "D", "shape": name, "n": x.shape[0], "d": x.shape[1],
            "out": str(got.dtype), "ms": ms, "library_ms": lib_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "card": card}), flush=True)
        del xd, xt, got
        torch.cuda.empty_cache()


def _traced_fit(train, params, x, y, kw):
    """(wall s, [(kernel, device us, launches)]) of one traced fit."""
    from synapseml_tpu_torch.tools.profile_fit import _traced

    _, wall, kernels = _traced(lambda: train(params, x, y, **kw))
    return wall, kernels


def bench_growth(card, seed):
    from synapseml_tpu_torch.gbdt import histogram as hist
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.gbdt.partition import PARTITION_TRACE
    from synapseml_tpu_torch.tools import profile_fit as pf
    from synapseml_tpu_torch.tools.schema_data import FITS

    names = {"a_rows": hist.HIST_ROWS_TRACE, "p": PARTITION_TRACE,
             "epilogue": getattr(hist, "SIBLING_TRACE", None)}
    for fit, schema, rows in (("higgs", "higgs", None), ("adult", "adult", None),
                              ("covertype", "covertype", None), ("mslr", "mslr", None),
                              ("higgs_16384", "higgs", 16_384)):
        n_train, n_made, est = FITS[schema]
        params = {k: v for k, v in est.items() if k != "categorical_slot_indexes"}
        params.update(pf._OBJECTIVE[schema])
        kw = {}
        if schema == "mslr":
            x, y, s_tr, _ = pf._mslr(seed)
            n_train, kw = int(s_tr.sum()), dict(group=s_tr)
        else:
            x, y = pf._ROWS[schema](seed, n_made)
        n_train = rows or n_train
        x, y = np.ascontiguousarray(x[:n_train]), y[:n_train]
        n_warm = min(65536, n_train)
        warm = {k: pf._head_groups(v, n_warm) for k, v in kw.items()}
        train(dict(params, num_iterations=1), x[:n_warm], y[:n_warm], **warm)  # load kernels
        torch.cuda.synchronize()
        steps = (params["num_iterations"] * params.get("num_class", 1)
                 * (params["num_leaves"] - 1))
        wall, kernels = _traced_fit(train, params, x, y, kw)
        busy = sum(us for _, us, _ in kernels) / 1e6
        # the rows' pageable host -> device copy swings by tens of ms a fit
        copies = sum(us for k, us, _ in kernels if k.startswith(("Memcpy", "Memset"))) / 1e6
        htod = sum(us for k, us, _ in kernels if "Memcpy HtoD" in k) / 1e6
        rec = {"bench": "growth", "fit": fit, "rows": len(y), "split_steps": steps,
               "wall_s": wall, "device_busy_s": busy, "busy_without_htod_s": busy - htod,
               "kernel_busy_s": busy - copies,
               "launches_per_split_step": sum(c for _, _, c in kernels) / steps}
        for key, parts in names.items():
            hits = [(us, c) for k, us, c in kernels
                    if parts is not None and all(p in k for p in parts)]
            rec[f"{key}_ms"] = sum(us for us, _ in hits) / 1e3
            rec[f"{key}_launches"] = sum(c for _, c in hits)
        print(json.dumps({**rec, "card": card}), flush=True)
        del x, y
        torch.cuda.empty_cache()


def _kernel_ms(fn, parts, reps: int = 20) -> float:
    """Device ms a launch of the kernels whose traced name holds ``parts``,
    in a trace of ``reps`` calls of ``fn`` after one warm-up."""
    ms, launches, _ = _call_ms(fn, parts, reps)
    return ms / launches if launches else 0.0


def bench_leaves(card, seed, dev):
    from synapseml_tpu_torch.gbdt import histogram as hist
    from synapseml_tpu_torch.gbdt import partition as pmod

    new = hasattr(hist, "SIBLING_KERNEL")  # the row list over (3,) spans and two buffers
    gen = torch.Generator(device=dev).manual_seed(seed)
    for width, n, d, B, dt in LEAF_WIDTHS:
        binned = torch.randint(0, B, (n, d), generator=gen, device=dev).to(dt)
        g = torch.randint(-64, 64, (n,), generator=gen, device=dev).float() / 64
        h = torch.full((n,), 0.25, device=dev)
        w = torch.ones(n, device=dev)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        ids = torch.stack([perm, perm]) if new else perm  # P's two buffers, or its one
        for k in LEAF_ROWS:
            span = torch.tensor([n - k, k] + ([0] if new else []), dtype=torch.int32,
                                device=dev)
            run = lambda: hist.histogram_rows(binned, g, h, w, B, ids, span)
            print(json.dumps({"bench": "leaves", "kernel": "A_rows", "width": width,
                              "rows": k, "device_ms": _kernel_ms(run, hist.HIST_ROWS_TRACE),
                              "card": card}), flush=True)
        if width != "higgs":
            continue
        f, split_bin = 3, 31
        choice = torch.tensor([1, f], device=dev)
        ok = torch.ones(1, dtype=torch.bool, device=dev)
        in_set = torch.arange(B, device=dev) <= split_bin
        node = torch.zeros(n, dtype=torch.int32, device=dev)
        for k in (n,) + LEAF_ROWS:  # n: the root, every row in order
            part = pmod.RowPartition(n, 31, dev)
            part.begin_tree()
            order = part.ids[0] if new else part.order
            if k < n:
                order.copy_(perm)
                part.seg[0, 1], part.seg[1, 0], part.seg[1, 1] = n - k, n - k, k
            leaf_choice = choice if k < n else torch.tensor([0, f], device=dev)
            step = 1 if k < n else 0
            saved = (order.clone(), part._state.clone())

            def split():
                order.copy_(saved[0])
                part._state.copy_(saved[1])
                part.split(step, binned, node, leaf_choice, ok, in_set)

            print(json.dumps({"bench": "leaves", "kernel": "P", "width": width,
                              "rows": k, "root": k == n,
                              "device_ms": _kernel_ms(split, pmod.PARTITION_TRACE),
                              "card": card}), flush=True)
            del part, order, saved
        del binned, g, h, w, perm, ids, node
        torch.cuda.empty_cache()


def sparse_splits(sb, booster, seed: int, leaves=SPARSE_LEAVES) -> dict:
    """Kernel G's splits over a SparseBinned and a booster fitted on it:
    {name: (side (n,) int32, (half, slot, forced), the rows of the leaf
    whose histogram the call's ``parent`` keeps in slot 0: (n,) bool, or
    None)}. ``root_both`` and ``root_child``: the first tree's root split,
    both sides and the smaller side with the sibling from the kept root;
    ``deep_both`` and ``deep``: its deepest split (the last among the
    deepest), its earlier steps replayed over ``sparse_column``, both sides
    (a leaf whose histograms were not kept) and the smaller side with the
    kept leaf; ``rows_<k>`` for each of ``leaves``: a leaf of 2k rows drawn
    at random, k of them right and k left, the right side (k member rows,
    the smaller by the reference's rule) with the kept leaf. Numeric splits
    only (hashed text has none other)."""
    from synapseml_tpu_torch.gbdt.sparse import sparse_column

    dev, n = sb.device, sb.n
    parent, feature, bin_ = (np.asarray(a[0, 0]) for a in (booster.parent, booster.feature,
                                                          booster.bin))
    go_right = lambda s: sparse_column(sb, int(feature[s])) > int(bin_[s])
    split = lambda member, s: torch.where(member, go_right(s).to(torch.int32), 2).to(
        torch.int32)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    depth, depths = [0] * (len(parent) + 1), []
    for s, p in enumerate(parent):
        p = int(p)
        depths.append(depth[p] if p >= 0 else -1)
        if p >= 0:
            depth[p] = depth[s + 1] = depth[p] + 1
    deep = max(range(len(parent)), key=lambda s: (depths[s], s))
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(deep):
        if int(parent[s]) >= 0:
            node = torch.where((node == int(parent[s])) & go_right(s), s + 1, node)
    leaf = node == int(parent[deep])
    out = {"root_both": (split(every, 0), (0, 0, -1), None),
           "root_child": (split(every, 0), (1, 0, -1), every),
           "deep_both": (split(leaf, deep), (0, 0, -1), None),
           "deep": (split(leaf, deep), (1, 0, -1), leaf)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k in leaves:
        pick = torch.randperm(n, generator=gen, device=dev)[:2 * k]
        side = torch.full((n,), 2, dtype=torch.int32, device=dev)
        side[pick[:k]], side[pick[k:]] = 1, 0
        out[f"rows_{k}"] = (side, (1, 0, -1), side <= 1)
    return out


def _hashed_rows(seed: int, cache):
    """Phase 2g's training reviews and labels; from ``cache`` (an .npz this
    bench wrote) when it exists, else made and, given ``cache``, kept."""
    import os

    from synapseml_tpu_torch.gbdt.sparse import CSRMatrix
    from synapseml_tpu_torch.tools.schema_data import FITS, hashed_text_rows

    if cache and Path(cache).exists():
        z = np.load(cache)
        return CSRMatrix(z["indptr"], z["indices"], z["values"], tuple(z["shape"])), z["y"]
    n_train, n_made, _ = FITS["hashed_text"]
    x, y = hashed_text_rows(seed, n_made)
    x, y = x[:n_train], y[:n_train]
    if cache:  # the values are word counts: exact in f32
        tmp = f"{cache}.{os.getpid()}.npz"
        np.savez(tmp, indptr=x.indptr, indices=x.indices, values=x.values.astype(np.float32),
                 shape=np.asarray(x.shape), y=y)
        os.replace(tmp, cache)
    return x, y


def _call_ms(fn, parts, reps: int = 20):
    """(device ms, device kernels, {kernel: device ms}) of one call of
    ``fn``: the kernels whose traced name holds ``parts``, in a trace of
    ``reps`` calls after one warm-up."""
    from synapseml_tpu_torch.tools.profile_fit import _device_us

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if all(p in e.key for p in parts)
            and e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(_device_us(e) for e in hits) / 1e3 / reps,
            sum(e.count for e in hits) / reps,
            {e.key.split("::")[-1][:30]: _device_us(e) / 1e3 / reps for e in hits})


def bench_sparse(card, seed, dev, cache):
    from synapseml_tpu_torch.gbdt.boost import _preround, _sigmoid, train
    from synapseml_tpu_torch.gbdt.sparse import (SPARSE_HIST_TRACE, build_sparse_binned,
                                                 sparse_hist)
    from synapseml_tpu_torch.tools import profile_fit as pf
    from synapseml_tpu_torch.tools.schema_data import FITS

    x, y = _hashed_rows(seed, cache)
    params = dict(FITS["hashed_text"][2], **pf._OBJECTIVE["hashed_text"])
    train(dict(params, num_iterations=1), x[:65536], y[:65536])  # load the kernels
    torch.cuda.synchronize()
    booster, wall, kernels = pf._traced(lambda: train(params, x, y))
    calls = params["num_iterations"] * params["num_leaves"]
    g = [(k, us, c) for k, us, c in kernels if all(p in k for p in SPARSE_HIST_TRACE)]
    print(json.dumps({"bench": "sparse", "shape": "fit", "rows": len(y), "wall_s": wall,
                      "device_busy_s": sum(us for _, us, _ in kernels) / 1e6,
                      "g_device_ms_a_fit": sum(us for _, us, _ in g) / 1e3,
                      "g_device_kernels_a_call": sum(c for _, _, c in g) / calls,
                      "g_kernel_ms_a_fit": {k.split("::")[-1][:30]: us / 1e3
                                            for k, us, _ in g},
                      "card": card}), flush=True)
    sb = build_sparse_binned(x, booster.mapper, dev)
    p = _sigmoid(booster._raw_of_csr(x, dev)[:, 0].float())
    yd = torch.from_numpy(y).to(dev, torch.float32)
    nb = 1 << (sb.n - 1).bit_length()
    gh = _preround(torch.stack([p - yd, p * (1 - p)], 1), nb)
    panel = torch.stack([gh[:, 0], gh[:, 1], torch.ones_like(p), torch.zeros_like(p)],
                        1).contiguous()
    shape = (2, sb.d, sb.n_bins, 3)
    both = torch.tensor([0, 0, -1], dtype=torch.int32, device=dev)
    for name, (side, ctrl_v, kept_leaf) in sparse_splits(sb, booster, seed).items():
        par = None
        if kept_leaf is not None:
            par = torch.empty(shape, device=dev)
            sparse_hist(sb, panel, torch.where(kept_leaf, 0, 2).to(torch.int32), par,
                        torch.empty(2, 3, device=dev), both)
        out, tot = torch.empty(shape, device=dev), torch.empty(2, 3, device=dev)
        ctrl = torch.tensor(ctrl_v, dtype=torch.int32, device=dev)
        run = lambda: sparse_hist(sb, panel, side, out, tot, ctrl, par)
        ms, per_call, by_kernel = _call_ms(run, SPARSE_HIST_TRACE)
        state = sb.plan.state
        path = ("stream", "walk")[int(state[1])] if state.numel() > 1 else "stream"
        print(json.dumps({"bench": "sparse", "shape": name, "ctrl": list(ctrl_v),
                          "members": int(((side == 0) | (side == 1)).sum()), "path": path,
                          "device_ms": ms, "device_kernels_a_call": per_call,
                          "kernel_ms": by_kernel, "events_ms": time_ms(run, 20),
                          "card": card}), flush=True)
        del par, out
    del sb, panel
    torch.cuda.empty_cache()


def run_ab(args) -> int:
    rc = 0
    for r in range(args.rounds):
        for tree in (args.ab if r % 2 == 0 else args.ab[::-1]):
            cmd = [sys.executable, __file__, "--tree", tree, "--seed", str(args.seed),
                   "--only", args.only]
            if args.rows_cache:
                cmd += ["--rows-cache", args.rows_cache]
            res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=1800)
            rc = rc or res.returncode
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({"round": r, "tree": tree, **json.loads(line)}),
                          flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the synapseml_tpu_torch package to measure")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", nargs="+", metavar="DIR", help="trees to time alternately")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="split,bin,growth,leaves",
                    help=f"comma-separated benches: {', '.join(BENCHES)}")
    ap.add_argument("--rows-cache", default=None, metavar="FILE.npz",
                    help="sparse: keep the hashed reviews here for the next process")
    args = ap.parse_args()
    benches = args.only.split(",")
    if set(benches) - set(BENCHES):
        ap.error(f"--only {args.only}: the benches are {', '.join(BENCHES)}")
    if not torch.cuda.is_available():
        print("gbdt_step_bench: needs a CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return run_ab(args)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import synapseml_tpu_torch as pkg
    from synapseml_tpu_torch.runtime.device import card_info

    if tree not in Path(pkg.__file__).resolve().parents:
        print(f"gbdt_step_bench: imported {pkg.__file__}, not the package in {tree}",
              file=sys.stderr)
        return 2
    card = card_info()
    dev = torch.device("cuda")
    if "split" in benches:
        bench_split(card, args.seed, dev)
    if "bin" in benches:
        bench_bin(card, args.seed, dev)
    if "leaves" in benches:
        bench_leaves(card, args.seed, dev)
    if "growth" in benches:
        bench_growth(card, args.seed)
    if "sparse" in benches:
        bench_sparse(card, args.seed, dev, args.rows_cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
