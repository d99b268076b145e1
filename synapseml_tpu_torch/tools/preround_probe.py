"""How much the pre-rounding grid costs the held-out metric, on the GPU.

    python -m synapseml_tpu_torch.tools.preround_probe [--seed 0]

``boost._preround`` (the reference's rule) rounds gradients to a grid of
``ulp(2^ceil(log2(max|g| * n_bound)))`` with ``n_bound`` the next power of
two over the rows, so every histogram sum is exact in any order. The grid
coarsens with the row count. This fits ``chip_smoke.py``'s Adult-schema
cell (binary, 4,194,304 rows) and Covertype-schema cell (7 classes,
464,810 rows) as they are, and again with the grid of a smaller ``n_bound``
(2^16, 2^14; the sums stay exact for those rows only up to that bound, so
this is a probe, not a training mode), and prints one JSON line: the
held-out AUC / accuracy of each fit, the label's own (the probabilities or
logits the rows were drawn from), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _auc(y, score) -> float:
    _, inv, counts = np.unique(score, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("preround_probe: needs a CUDA device", file=sys.stderr)
        return 2

    from ..gbdt import boost
    from ..runtime.device import card_info
    from .schema_data import (ADULT_CATEGORICAL, COVTYPE_CATEGORICAL, COVTYPE_CLASSES,
                              adult_rows, adult_unseen_codes, covertype_rows)

    exact = boost._preround
    common = dict(num_iterations=10, num_leaves=31, max_bin=255)
    out = {"card": card_info()}

    def fit(params, x, y, n_bound):
        boost._preround = exact if n_bound is None else (
            lambda v, _n: exact(v, n_bound))
        try:
            return boost.train(params, x, y)
        finally:
            boost._preround = exact

    n_tr, n_te = 4_194_304, 1_048_576
    x, y, p = adult_rows(args.seed, n_tr + n_te)
    x_te = adult_unseen_codes(x[n_tr:], args.seed + 1, 0.005)
    params = dict(common, objective="binary", categorical_feature=ADULT_CATEGORICAL)
    out["adult"] = {"rows": n_tr, "label_auc": _auc(y[n_tr:], p[n_tr:])}
    for key, nb in (("auc", None), ("auc_grid_2^16", 1 << 16)):
        out["adult"][key] = _auc(y[n_tr:], fit(params, x[:n_tr], y[:n_tr], nb).predict(x_te))
    del x, y, p, x_te

    n_all, n_tr = 581_012, 464_810
    x, y, logits = covertype_rows(args.seed, n_all)
    params = dict(common, objective="multiclass", num_class=COVTYPE_CLASSES,
                  categorical_feature=COVTYPE_CATEGORICAL)
    y_te = y[n_tr:]
    out["covertype"] = {"rows": n_tr,
                        "label_accuracy": float((logits[n_tr:].argmax(1) == y_te).mean()),
                        "majority": float(np.bincount(y_te.astype(np.int64)).max()
                                          / len(y_te))}
    for key, nb in (("accuracy", None), ("accuracy_grid_2^14", 1 << 14)):
        pred = fit(params, x[:n_tr], y[:n_tr], nb).predict(x[n_tr:]).argmax(1)
        out["covertype"][key] = float((pred == y_te).mean())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
