"""Time GBDT tree scoring (kernel B) on the card, beside its bound.

    python synapseml_tpu_torch/tools/score_bench.py [--tree DIR] [--shapes fit10,higgs500]
        [--reps 20] [--seed 0] [--check]
    python synapseml_tpu_torch/tools/score_bench.py --ab DIR DIR ... [--rounds 4] [...]

Times the tree-scoring kernel of the ``synapseml_tpu_torch`` found in
``--tree`` (default: the tree holding this file) through its launch handle,
with every argument prepared on the card beforehand, so the same command
measures an older tree unpacked beside this one (a tree whose
``device_predict`` has no ``pack_trees`` is taken for the replay kernel's
argument list). Run it as a script, not with ``python -m``, which would import
the package of the current directory first; the script refuses to measure a
package from outside ``--tree``. ``--check`` also holds the kernel's scores
(and leaf ids, where the tree has that entry) bit-equal to the plain version
on the first 16,384 rows. One JSON line per shape, with the card's name and
power limit. ``--ab`` runs one process per tree and round, in the given order
and reversed every other round. Needs a CUDA device.

Shapes: ``fit10`` is the fitted model of ``chip_smoke.py`` (10 trees of 31
leaves, int8 bins of a 63-bin mapper), ``higgs500`` LightGBM's Higgs
experiment (``docs/Experiments.rst``: 500 trees, ``num_leaves=255``,
``max_bin=255``, so int16 bins), ``higgs500-cat`` the same with 4 of the 28
features categorical; all at 1,048,576 rows of 28 features. Trees are random
(:func:`random_trees`) and rows uniform over the bins.

Bound (:func:`tree_bound`): the larger of the bytes (bins read once, packed
trees, leaf values and scales once, scores or leaf ids written once) at
3.35 TB/s and the visits (one decision per node on each row's path:
:func:`path_visits`) at the INT32 rate, 132 SMs x 64 lanes x the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``).
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
N_SMS = 132
INT32_LANES_PER_SM = 64
N_ROWS = 1_048_576
N_FEATURES = 28
CHECK_ROWS = 16_384

# name: (trees, classes, leaves, bins per feature incl. the missing bin, categorical features)
SHAPES = {
    "fit10": (10, 1, 31, 64, 0),
    "higgs500": (500, 1, 255, 256, 0),
    "higgs500-cat": (500, 1, 255, 256, 4),
}


def random_trees(rng: np.random.Generator, T: int, C: int, leaves: int, d: int,
                 n_bins: int, n_cat: int = 0, dead_rate: float = 1 / 64) -> dict:
    """Random replay-list trees (numpy, the reference's layout): each split's
    parent uniform among the leaves that exist, its feature uniform, its bin
    uniform below the feature's last data bin; about ``dead_rate`` of the
    splits never happen (parent -1). The first ``n_cat`` features are
    categorical: their splits carry bin -1 and a random category set over
    ``n_bins`` bins. Leaf values standard normal, scale 0.1 a tree."""
    Q, S = T * C, leaves - 1
    parent = np.full((Q, S), -1, np.int32)
    feature = rng.integers(0, d, size=(Q, S)).astype(np.int32)
    bins = rng.integers(0, max(n_bins - 1, 1), size=(Q, S)).astype(np.int32)
    live_ids = np.zeros((Q, leaves), np.int64)    # the leaves that exist, in order
    n_live = np.ones(Q, np.int64)
    q = np.arange(Q)
    for s in range(S):
        pick = live_ids[q, (rng.random(Q) * n_live).astype(np.int64)]
        happens = rng.random(Q) >= dead_rate
        parent[happens, s] = pick[happens]
        live_ids[q[happens], n_live[happens]] = s + 1
        n_live += happens
    cat_set = None
    if n_cat:
        bins[feature < n_cat] = -1
        cat_set = (rng.random((Q, S, n_bins)) < 0.5).astype(np.int8)
        cat_set[feature >= n_cat] = 0
        cat_set = cat_set.reshape(T, C, S, n_bins)
    return {"parent": parent.reshape(T, C, S), "feature": feature.reshape(T, C, S),
            "bins": bins.reshape(T, C, S),
            "leaf_value": rng.standard_normal((T, C, leaves)).astype(np.float32),
            "scale": np.full(T, 0.1), "cat_set": cat_set}


def path_visits(leaves: torch.Tensor, depth: torch.Tensor) -> int:
    """Sum over rows and trees of the depth of the leaf each row reaches:
    ``leaves`` (T, C, n) leaf ids, ``depth`` (T, C, S+1) leaf depths."""
    T, C, _ = leaves.shape
    return int(sum(int(depth[t, c][leaves[t, c].long()].sum())
                   for t in range(T) for c in range(C)))


def tree_bytes(n: int, d: int, bin_bytes: int, packed, leaf: bool) -> int:
    """Bytes one call must move: bins once, the packed trees once, and either
    the leaf values and scales read and the (n, C) scores written, or the
    (T, C, n) int32 leaf ids written."""
    T, C, S = packed.shape
    moved = n * d * bin_bytes + packed.nodes.numel() * 4
    return moved + (T * C * n * 4 if leaf else T * C * (S + 1) * 4 + T * 4 + n * C * 4)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def tree_bound(n_bytes: float, visits: float, int32_per_s: float):
    """(least time in ms, what bounds it): bytes at the memory rate against
    one INT32 decision per visit."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = visits / int32_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
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


def run_ab(args) -> int:
    """Time the trees of ``--ab`` alternately, one process per tree and round."""
    rc = 0
    for r in range(args.rounds):
        for tree in (args.ab if r % 2 == 0 else args.ab[::-1]):
            cmd = [sys.executable, __file__, "--tree", tree, "--shapes", args.shapes,
                   "--reps", str(args.reps), "--seed", str(args.seed)]
            res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=1800)
            rc = rc or res.returncode
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({"round": r, **json.loads(line)}), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the synapseml_tpu_torch package to measure")
    ap.add_argument("--shapes", default="fit10,higgs500")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="hold the kernel bit-equal to the plain version on a subset")
    ap.add_argument("--ab", nargs="+", metavar="DIR", help="trees to time alternately")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("score_bench: needs a CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return run_ab(args)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from synapseml_tpu_torch.gbdt import device_predict as dp
    from synapseml_tpu_torch.runtime.device import card_info

    if tree not in Path(dp.__file__).resolve().parents:
        print(f"score_bench: imported {dp.__file__}, not the package in {tree}",
              file=sys.stderr)
        return 2
    card = card_info()
    print(f"card: {card}", flush=True)
    int32_per_s = N_SMS * INT32_LANES_PER_SM * max_sm_clock_hz()
    packs = hasattr(dp, "pack_trees")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    bad = 0
    for name in (s for s in args.shapes.split(",") if s):
        T, C, leaves, n_bins, n_cat = SHAPES[name]
        if n_cat and not packs:
            print(f"score_bench: {name} needs categorical splits, which {tree} lacks",
                  file=sys.stderr)
            continue
        rng = np.random.default_rng(args.seed)
        trees = random_trees(rng, T, C, leaves, N_FEATURES, n_bins, n_cat)
        dtype = torch.int8 if n_bins <= 127 else torch.int16
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        binned = torch.randint(0, n_bins, (N_ROWS, N_FEATURES), generator=gen,
                               device=dev).to(dtype)
        S = leaves - 1
        lv = torch.from_numpy(trees["leaf_value"]).to(dev)
        sc = torch.from_numpy(trees["scale"].astype(np.float32)).to(dev)

        par, fea, thr = (torch.from_numpy(trees[k]).to(dev).int().contiguous()
                         for k in ("parent", "feature", "bins"))
        out = torch.empty(N_ROWS, C, dtype=torch.float32, device=dev)
        head = (binned.data_ptr(), binned.element_size(), N_ROWS, N_FEATURES)
        row = {"shape": name, "tree": str(tree), "n": N_ROWS, "d": N_FEATURES, "T": T,
               "C": C, "S": S, "bins": str(dtype), "card": card,
               "int32_per_s": int32_per_s}
        if packs:
            packed = dp.pack_trees(trees["parent"], trees["feature"], trees["bins"],
                                   trees["cat_set"], device=dev)
            fmt = (packed.nodes.data_ptr(), packed.units, int(packed.narrow))
            score = lambda: dp.SCORE_KERNEL(*head, *fmt, lv.data_ptr(), sc.data_ptr(), T, C,
                                            S, packed.cat_bins, out.data_ptr(), stream)
            leaf_out = torch.empty(T, C, N_ROWS, dtype=torch.int32, device=dev)
            leaf = lambda: dp.LEAF_KERNEL(*head, *fmt, T, C, S, packed.cat_bins,
                                          leaf_out.data_ptr(), stream)
        else:
            score = lambda: dp.SCORE_KERNEL(*head, par.data_ptr(), fea.data_ptr(),
                                            thr.data_ptr(), lv.data_ptr(), sc.data_ptr(),
                                            T, C, S, out.data_ptr(), stream)
            leaf = None
        row["ms"] = time_ms(score, args.reps)
        if leaf is not None:
            row["leaf_ms"] = time_ms(leaf, max(args.reps // 4, 1))
            visits = path_visits(leaf_out, packed.depth)
            b = tree_bound(tree_bytes(N_ROWS, N_FEATURES, binned.element_size(), packed,
                                      False), visits, int32_per_s)
            lb = tree_bound(tree_bytes(N_ROWS, N_FEATURES, binned.element_size(), packed,
                                       True), visits, int32_per_s)
            row.update(visits=visits, bound_ms=b[0], bound_by=b[1], leaf_bound_ms=lb[0],
                       leaf_bound_by=lb[1])
        if args.check:
            sub = binned[:CHECK_ROWS]
            cats = {"cat_set": trees["cat_set"]} if n_cat else {}
            plain = dp.raw_scores_plain(sub, par, fea, thr, lv, sc, **cats)
            row["scores_equal"] = bool(torch.equal(out[:CHECK_ROWS], plain))
            ok = row["scores_equal"]
            if leaf is not None:
                lplain = dp.leaf_indices_plain(sub, par, fea, thr, **cats)
                row["leaves_equal"] = bool(torch.equal(leaf_out[:, :, :CHECK_ROWS], lplain))
                ok = ok and row["leaves_equal"]
            bad += not ok
        print(json.dumps(row), flush=True)
        del binned, out
        torch.cuda.empty_cache()
    if bad:
        print(f"score_bench: {bad} shapes differ from the plain version", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
