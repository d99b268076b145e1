"""Where the time of one GBDT fit goes, on the GPU.

    python -m synapseml_tpu_torch.tools.profile_fit
        [--schema higgs|adult|covertype|mslr|hashed_text]
        [--boosting gbdt|goss|dart|rf] [--bagging FRACTION] [--eval] [--seed 0]
        [--rows N] [--ab full_pass [--rounds 2]]

Fits ``train`` on the training rows of one of ``chip_smoke.py``'s fits
(``tools/schema_data.py`` ``FITS``: HIGGS width, 28 f32 features, 63 bins;
the Adult schema, 8 of 14 columns categorical, 255 bins; the Covertype
schema, 7 classes, 255 bins; MSLR-WEB30K's schema, lambdarank over 18,919
queries, 136 features, 255 bins, its validation queries as the eval set
with ``--eval``; hashed text at Amazon Review Polarity's schema, a CSR
matrix of 2^18 hashed slots grown by the sparse grower; 31 leaves and 10
iterations each) and prints
one JSON object: the wall time of the whole fit, of its two binning steps
(``BinMapper.fit`` or ``fit_csr`` on the host, ``transform_torch`` or
``build_sparse_binned`` on the card), the device
time and launch count of every kernel name in a ``torch.profiler`` trace of
a second fit, the device's busy and idle share of that fit, its kernel
launches (in all, and per split step: iterations x classes x (leaves - 1)
steps), its device -> host and host -> device copies, and the card's name
and power limit. Needs a CUDA device.

The training controls of ``chip_smoke.py``'s phase 2d: ``--boosting``
(dart with its ``skip_drop=0, drop_rate=0.3``), ``--bagging`` (that
fraction, every iteration) and ``--eval`` (the held-out rows as an eval
set, AUC or multi_logloss with ``early_stopping_round=3``). Without them
the fit is plain gbdt, as before. With ``--eval`` on a fit whose metric runs
on the host (lambdarank's NDCG), the object also holds each iteration's
wall time of that metric in the first timed fit, and the wall time of the
same fit without its eval set, so that the eval's share of the fit shows.

``--rows N`` fits the first N training rows (lambdarank: whole queries).
``--ab full_pass`` compares the shipped growth (dense: a row partition,
kernel P and kernel A's row-list entry; sparse: kernel G's half pass) with
the full pass (``kernel_cases.grow_full_pass`` and
``grow_sparse_full_pass``): after the warm-up fit it traces fits in turns
full pass, shipped, shipped, full pass (``--rounds`` times) and prints,
for each path and traced fit, its wall time, device busy time and idle
share, kernel launches a split step, device -> host copies, the ms of host
-> device copies, and the device ms and launches of kernel A's two
entries, kernel P and kernel G. The two paths' trees must be identical
(else it exits 1).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from .schema_data import (ADULT_CATEGORICAL, COVTYPE_CATEGORICAL, COVTYPE_CLASSES, FITS,
                          MSLR_TRAIN, MSLR_VALID, SAMPLED_MODES, adult_rows, covertype_rows,
                          hashed_text_rows, higgs_width_rows, mslr_rows)

# train()'s parameters for each fit (the estimator's categorical_slot_indexes
# is train's categorical_feature)
_OBJECTIVE = {"higgs": dict(objective="binary"),
              "adult": dict(objective="binary", categorical_feature=ADULT_CATEGORICAL),
              "covertype": dict(objective="multiclass", num_class=COVTYPE_CLASSES,
                                categorical_feature=COVTYPE_CATEGORICAL),
              "mslr": dict(objective="lambdarank"),
              "hashed_text": dict(objective="binary")}
_ROWS = {"higgs": higgs_width_rows, "adult": lambda seed, n: adult_rows(seed, n)[:2],
         "covertype": lambda seed, n: covertype_rows(seed, n)[:2],
         "hashed_text": hashed_text_rows}


def _mslr(seed: int):
    """MSLR-WEB30K Fold1's training and validation documents, concatenated,
    with their query sizes."""
    x_tr, y_tr, s_tr = mslr_rows(seed, *MSLR_TRAIN)
    x_va, y_va, s_va = mslr_rows(seed, *MSLR_VALID, part=1)
    return np.concatenate([x_tr, x_va]), np.concatenate([y_tr, y_va]), s_tr, s_va


def _head_groups(sizes: np.ndarray, n: int) -> np.ndarray:
    """The sizes of the first queries, the last one cut so they sum to ``n``."""
    k = int(np.searchsorted(np.cumsum(sizes), n))
    head = sizes[:k + 1].copy()
    head[-1] -= int(head.sum()) - n
    return head


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _timed_metric_ndcg(make, times: list):
    """``boost.metric_ndcg`` whose metrics append their wall time to ``times``."""
    def factory(k):
        fn = make(k)

        def timed(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            times.append(time.perf_counter() - t0)
            return out
        return timed
    return factory


def _traced(fn):
    """(wall s, [(kernel name, device us, launches)]) of ``fn()`` under
    ``torch.profiler``, device kernels only."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # some builds attribute device time to the CPU-side launch events
        kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                   if _device_us(e) > 0]
    return out, wall, kernels


def _ab_full_pass(train, params, x, y, kw, steps, rounds) -> dict:
    """The ``--ab full_pass`` record (see the module's doc)."""
    from ..gbdt.histogram import HIST_ROWS_TRACE, HIST_TRACE
    from ..gbdt.partition import PARTITION_TRACE
    from ..gbdt.sparse import SPARSE_HIST_TRACE
    from .kernel_cases import full_pass

    names = {"a_full": HIST_TRACE, "a_rows": HIST_ROWS_TRACE, "p": PARTITION_TRACE,
             "g": SPARSE_HIST_TRACE}
    runs, trees = {"full_pass": [], "shipped": []}, {}
    for _ in range(rounds):
        for path in ("full_pass", "shipped", "shipped", "full_pass"):
            with full_pass() if path == "full_pass" else contextlib.nullcontext():
                booster, wall, kernels = _traced(lambda: train(params, x, y, **kw))
            busy = sum(us for _, us, _ in kernels) / 1e6
            rec = {"fit_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
                   "launches_per_split_step": sum(c for _, _, c in kernels) / steps,
                   "device_to_host_copies": sum(c for k, _, c in kernels if "Memcpy DtoH" in k),
                   "host_to_device_copy_ms": sum(us for k, us, _ in kernels
                                                 if "Memcpy HtoD" in k) / 1e3}
            for key, parts in names.items():
                hits = [(us, c) for k, us, c in kernels if all(p in k for p in parts)]
                rec[f"{key}_ms"] = sum(us for us, _ in hits) / 1e3
                rec[f"{key}_launches"] = sum(c for _, c in hits)
            rec["a_ms"] = rec["a_full_ms"] + rec["a_rows_ms"]
            runs[path].append(rec)
            trees[path] = booster
    same = all(np.array_equal(getattr(trees["full_pass"], f), getattr(trees["shipped"], f))
               for f in ("parent", "feature", "bin", "leaf_value", "leaf_hess"))
    return {"identical_trees": same, "runs": runs}


def _controls(args, params: dict) -> dict:
    """``train`` parameters of the switches (none: the plain fit)."""
    out = {}
    if args.boosting != "gbdt":
        mode = {k: v for k, v in SAMPLED_MODES[args.boosting].items() if k != "boosting_type"}
        out.update(mode if args.boosting in ("goss", "dart") else {}, boosting=args.boosting)
    if args.bagging is not None:
        out.update(bagging_fraction=args.bagging, bagging_freq=1)
    if args.eval:
        out.update(metric="auc" if params["objective"] == "binary" else "multi_logloss",
                   early_stopping_round=3)
        if params["objective"] == "lambdarank":
            del out["metric"]  # lambdarank watches ndcg@ndcg_at
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--schema", choices=sorted(FITS), default="higgs")
    ap.add_argument("--boosting", choices=["gbdt", "goss", "dart", "rf"], default="gbdt")
    ap.add_argument("--bagging", type=float, default=None,
                    help="bagging_fraction, with bagging_freq=1 (rf needs it)")
    ap.add_argument("--eval", action="store_true",
                    help="the held-out rows as an eval set, with early stopping")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12, help="kernel names to list")
    ap.add_argument("--rows", type=int, default=None, help="fit the first N training rows")
    ap.add_argument("--ab", choices=["full_pass"], default=None,
                    help="trace the shipped growth against the full pass, in turns")
    ap.add_argument("--rounds", type=int, default=2, help="--ab: rounds of 4 traced fits")
    args = ap.parse_args()
    if args.ab and args.eval:
        ap.error("--ab traces fits without an eval set")
    if not torch.cuda.is_available():
        print("profile_fit: needs a CUDA device", file=sys.stderr)
        return 2

    from ..gbdt import boost
    from ..gbdt.binning import BinMapper
    from ..gbdt.boost import train
    from ..gbdt.sparse import build_sparse_binned, is_sparse_input
    from ..runtime.device import card_info

    n_train, n_made, est_params = FITS[args.schema]
    params = {k: v for k, v in est_params.items() if k != "categorical_slot_indexes"}
    params.update(_OBJECTIVE[args.schema])
    params.update(_controls(args, params))
    groups, small = {}, {}  # lambdarank: the query sizes of the rows
    if args.schema == "mslr":
        x, y, s_tr, s_va = _mslr(args.seed)
        groups = dict(group=s_tr, eval_group=[s_va] if args.eval else None)
        small = dict(group=_head_groups(s_tr, 65536),
                     eval_group=[_head_groups(s_tr, 4096)] if args.eval else None)
    else:
        x, y = _ROWS[args.schema](args.seed, n_made)
    eval_set = [(x[n_train:], y[n_train:])] if args.eval else None
    if args.rows is not None:
        n_train = min(args.rows, n_train)
        if args.schema == "mslr":  # whole queries
            s_tr = s_tr[:int(np.searchsorted(np.cumsum(s_tr), n_train, side="right"))]
            n_train = int(s_tr.sum())
            groups["group"] = s_tr
    sparse = is_sparse_input(x)
    x, y = (x[:n_train] if sparse else np.ascontiguousarray(x[:n_train])), y[:n_train]
    classes = params.get("num_class", 1)
    dev = torch.device("cuda")

    small_eval = [(x[:4096], y[:4096])] if args.eval else None
    if n_train < 65536:
        small = dict(groups)
    train(dict(params, num_iterations=1), x[:65536], y[:65536],
          eval_set=small_eval, **small)  # load the kernels
    torch.cuda.synchronize()
    if args.ab:
        steps = params["num_iterations"] * classes * (params["num_leaves"] - 1)
        rec = _ab_full_pass(train, params, x, y, groups, steps, args.rounds)
        print(json.dumps({"card": card_info(), "schema": args.schema, "rows": n_train,
                          **params, "split_steps": steps, **rec}))
        return 0 if rec["identical_trees"] else 1

    t0 = time.perf_counter()
    mapper = BinMapper(max_bin=params.get("max_bin", 255),
                       categorical_features=params.get("categorical_feature"))
    mapper = mapper.fit_csr(x) if sparse else mapper.fit(x)
    bin_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if sparse:
        build_sparse_binned(x, mapper, dev)
    else:
        mapper.transform_torch(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    bin_transform_s = time.perf_counter() - t0

    host_metric = args.eval and params["objective"] == "lambdarank"
    metric_s, untimed = [], boost.metric_ndcg
    if host_metric:
        boost.metric_ndcg = _timed_metric_ndcg(untimed, metric_s)
    t0 = time.perf_counter()
    booster = train(params, x, y, eval_set=eval_set, **groups)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eval_cost = {}
    if host_metric:
        boost.metric_ndcg = untimed
        bare = {k: v for k, v in params.items() if k not in ("early_stopping_round", "metric")}
        t0 = time.perf_counter()
        train(bare, x, y, group=s_tr)
        torch.cuda.synchronize()
        eval_cost = {"host_metric_s": metric_s, "host_metric_s_total": sum(metric_s),
                     "fit_without_eval_s": time.perf_counter() - t0}

    _, traced_s, kernels = _traced(lambda: train(params, x, y, eval_set=eval_set, **groups))
    busy_us = sum(us for _, us, _ in kernels)
    launches = sum(c for _, _, c in kernels)
    copies = {direction: sum(c for k, _, c in kernels if f"Memcpy {direction}" in k)
              for direction in ("DtoH", "HtoD")}
    kernels.sort(key=lambda k: -k[1])
    iters = booster.num_trees
    # early stopping trains to the end of the 32-iteration chunk it stops in;
    # the host metric (lambdarank's NDCG) stops where it decides
    trained = (params["num_iterations"] if not args.eval
               else len(booster.evals_result) if params["objective"] == "lambdarank"
               else min(params["num_iterations"], -(-iters // 32) * 32))
    steps = trained * classes * (params["num_leaves"] - 1)
    print(json.dumps({
        "card": card_info(), "schema": args.schema, "rows": n_train,
        "eval_rows": len(eval_set[0][1]) if eval_set else 0, **params,
        "iterations_trained": trained, "iterations_kept": iters,
        "best_iteration": booster.best_iteration,
        "sampled_row_share": (None if booster.sampled_rows is None
                              else (booster.sampled_rows / n_train).tolist()),
        "fit_s": fit_s, "bin_fit_s": bin_fit_s, "bin_transform_s": bin_transform_s,
        **eval_cost, "traced_fit_s": traced_s, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / traced_s,
        "device_launches": launches, "split_steps": steps,
        "launches_per_split_step": launches / steps,
        "device_to_host_copies": copies["DtoH"], "host_to_device_copies": copies["HtoD"],
        "kernels": [{"name": k[:80], "device_ms": us / 1e3, "count": c}
                    for k, us, c in kernels[:args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
