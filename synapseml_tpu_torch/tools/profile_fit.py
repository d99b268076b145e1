"""Where the time of one GBDT fit goes, on the GPU.

    python -m synapseml_tpu_torch.tools.profile_fit [--schema higgs|adult|covertype]
        [--boosting gbdt|goss|dart|rf] [--bagging FRACTION] [--eval] [--seed 0]

Fits ``train`` on the training rows of one of ``chip_smoke.py``'s three fits
(``tools/schema_data.py`` ``FITS``: HIGGS width, 28 f32 features, 63 bins;
the Adult schema, 8 of 14 columns categorical, 255 bins; the Covertype
schema, 7 classes, 255 bins; 31 leaves and 10 iterations each) and prints
one JSON object: the wall time of the whole fit, of its two binning steps
(``BinMapper.fit`` on the host, ``transform_torch`` on the card), the device
time and launch count of every kernel name in a ``torch.profiler`` trace of
a second fit, the device's busy and idle share of that fit, its kernel
launches (in all, and per split step: iterations x classes x (leaves - 1)
steps), its device -> host and host -> device copies, and the card's name
and power limit. Needs a CUDA device.

The training controls of ``chip_smoke.py``'s phase 2d: ``--boosting``
(dart with its ``skip_drop=0, drop_rate=0.3``), ``--bagging`` (that
fraction, every iteration) and ``--eval`` (the held-out rows as an eval
set, AUC or multi_logloss with ``early_stopping_round=3``). Without them
the fit is plain gbdt, as before.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .schema_data import (ADULT_CATEGORICAL, COVTYPE_CATEGORICAL, COVTYPE_CLASSES, FITS,
                          SAMPLED_MODES, adult_rows, covertype_rows, higgs_width_rows)

# train()'s parameters for each fit (the estimator's categorical_slot_indexes
# is train's categorical_feature)
_OBJECTIVE = {"higgs": dict(objective="binary"),
              "adult": dict(objective="binary", categorical_feature=ADULT_CATEGORICAL),
              "covertype": dict(objective="multiclass", num_class=COVTYPE_CLASSES,
                                categorical_feature=COVTYPE_CATEGORICAL)}
_ROWS = {"higgs": higgs_width_rows, "adult": lambda seed, n: adult_rows(seed, n)[:2],
         "covertype": lambda seed, n: covertype_rows(seed, n)[:2]}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_fit: needs a CUDA device", file=sys.stderr)
        return 2

    from ..gbdt.binning import BinMapper
    from ..gbdt.boost import train
    from ..runtime.device import card_info

    n_train, n_made, est_params = FITS[args.schema]
    params = {k: v for k, v in est_params.items() if k != "categorical_slot_indexes"}
    params.update(_OBJECTIVE[args.schema])
    params.update(_controls(args, params))
    x, y = _ROWS[args.schema](args.seed, n_made)
    eval_set = [(x[n_train:], y[n_train:])] if args.eval else None
    x, y = np.ascontiguousarray(x[:n_train]), y[:n_train]
    classes = params.get("num_class", 1)
    dev = torch.device("cuda")

    small_eval = [(x[:4096], y[:4096])] if args.eval else None
    train(dict(params, num_iterations=1), x[:65536], y[:65536],
          eval_set=small_eval)  # load the kernels
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    mapper = BinMapper(max_bin=params["max_bin"],
                       categorical_features=params.get("categorical_feature")).fit(x)
    bin_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapper.transform_torch(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    bin_transform_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    booster = train(params, x, y, eval_set=eval_set)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train(params, x, y, eval_set=eval_set)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # some builds attribute device time to the CPU-side launch events
        kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                   if _device_us(e) > 0]
    busy_us = sum(us for _, us, _ in kernels)
    launches = sum(c for _, _, c in kernels)
    copies = {direction: sum(c for k, _, c in kernels if f"Memcpy {direction}" in k)
              for direction in ("DtoH", "HtoD")}
    kernels.sort(key=lambda k: -k[1])
    iters = booster.num_trees
    # early stopping trains to the end of the 32-iteration chunk it stops in
    trained = (min(params["num_iterations"], -(-iters // 32) * 32) if args.eval
               else params["num_iterations"])
    steps = trained * classes * (params["num_leaves"] - 1)
    print(json.dumps({
        "card": card_info(), "schema": args.schema, "rows": n_train,
        "eval_rows": len(eval_set[0][1]) if eval_set else 0, **params,
        "iterations_trained": trained, "iterations_kept": iters,
        "best_iteration": booster.best_iteration,
        "sampled_row_share": (None if booster.sampled_rows is None
                              else (booster.sampled_rows / n_train).tolist()),
        "fit_s": fit_s, "bin_fit_s": bin_fit_s, "bin_transform_s": bin_transform_s,
        "traced_fit_s": traced_s, "device_busy_s": busy_us / 1e6,
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
