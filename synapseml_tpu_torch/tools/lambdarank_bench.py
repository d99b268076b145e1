"""Time kernel F (the LambdaRank gradient) of this tree against an older tree's
kernel F, alternately in one process, at MSLR-WEB30K's training shape.

    python synapseml_tpu_torch/tools/lambdarank_bench.py [--parent DIR] [--rounds 4]
        [--seed 0] [--reps 20]

Builds this tree's ``csrc/lambdarank.cu`` and, with ``--parent``, the one in
``DIR/synapseml_tpu_torch/csrc`` (the first design's C interface: no block
order, a (n, 4) f32 scratch), both with ``nvcc`` into this tree's build
directory, and calls both through ``ctypes`` on the same tensors. Rows: the
training queries of ``schema_data.mslr_rows(seed, *MSLR_TRAIN)`` (18,919
queries, 2,270,296 documents, G = 1,251), truncation 30; margins all tied
(iteration 0) and drawn from the seed (normal, on a 2^-10 grid, so some
documents tie). Each shape is first checked bit-equal: this tree's kernel
against the plain version, and the parent's against this tree's. Then
``--rounds`` rounds in turns (parent, change, change, parent, ...), each the
mean of ``--reps`` launches between CUDA events. One JSON line per
measurement and a summary, each with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from synapseml_tpu_torch.gbdt.lambdarank import (QueryGroups, cell_count,  # noqa: E402
                                                 lambda_grads, lambda_grads_plain, pair_count)
from synapseml_tpu_torch.kernels.build import build  # noqa: E402
from synapseml_tpu_torch.runtime.device import card_info  # noqa: E402
from synapseml_tpu_torch.tools.schema_data import MSLR_TRAIN, mslr_rows  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# smt_lambdarank of the first design (ranks by counting; offsets, no blocks table)
FIRST_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P]
FIRST_SMEM_DOCS = 2048


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


def first_design(parent: Path):
    """A call ``f(score, label, weight, groups, offsets) -> (g, h)`` of the
    parent's kernel F (``offsets``: the (Q+1,) int32 row offsets on the card)."""
    lib = ctypes.CDLL(str(build(["lambdarank"], csrc=parent / "synapseml_tpu_torch" / "csrc")
                          ["lambdarank"]))
    fn = lib.smt_lambdarank
    fn.argtypes, fn.restype = FIRST_ARGTYPES, ctypes.c_int

    def call(score, label, weight, groups, offsets, sigma=1.0):
        n, dev = groups.n, score.device
        g = torch.empty(n, dtype=torch.float32, device=dev)
        h = torch.empty(n, dtype=torch.float32, device=dev)
        scratch = (torch.empty(n, 4, dtype=torch.float32, device=dev)
                   if groups.G > FIRST_SMEM_DOCS else None)
        err = fn(score.data_ptr(), label.data_ptr(), groups.gain.data_ptr(), weight.data_ptr(),
                 offsets.data_ptr(), groups.max_dcg.data_ptr(), groups.disc.data_ptr(),
                 len(groups.sizes), groups.G, groups.truncation, float(np.float32(sigma)),
                 float(np.float32(sigma * sigma)),
                 None if scratch is None else scratch.data_ptr(), g.data_ptr(), h.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's smt_lambdarank: CUDA error {err}")
        return g, h

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="tree holding the kernel F to compare with")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--truncation", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lambdarank_bench: needs a CUDA device", file=sys.stderr)
        return 2
    card, dev = card_info(), torch.device("cuda")
    _, y_np, sizes = mslr_rows(args.seed, *MSLR_TRAIN)
    n = len(y_np)
    groups = QueryGroups(sizes, y_np, args.truncation, dev)
    y = torch.from_numpy(y_np.astype(np.float32)).to(dev)
    w = torch.ones(n, device=dev)
    rng = np.random.default_rng(args.seed)
    margins = {"iteration0": np.zeros(n, np.float32),
               "seeded": (np.round(rng.normal(size=n) * 1024) / 1024).astype(np.float32)}
    trees = {"change": lambda s: lambda_grads(s, y, w, groups)}
    if args.parent is not None:
        first = first_design(args.parent.resolve())
        offsets = torch.from_numpy(groups.offsets_np.astype(np.int32)).to(dev)
        trees = {"parent": lambda s: first(s, y, w, groups, offsets), **trees}
    cells, visits_first = cell_count(sizes, args.truncation)
    times = {}
    for shape, s_np in margins.items():
        s = torch.from_numpy(s_np).to(dev)
        got = trees["change"](s)
        want = lambda_grads_plain(s, y, w, groups)
        same_plain = all(torch.equal(a, b) for a, b in zip(got, want))
        same_parent = (all(torch.equal(a, b) for a, b in zip(got, trees["parent"](s)))
                       if "parent" in trees else None)
        print(json.dumps({"shape": shape, "n": n, "Q": len(sizes), "G": groups.G,
                          "truncation": args.truncation,
                          "pairs": pair_count(sizes, y_np, args.truncation, s_np),
                          "cells": cells, "visits_first_design": visits_first,
                          "bit_equal_plain": same_plain, "bit_equal_parent": same_parent,
                          "card": card}), flush=True)
        if not same_plain or same_parent is False:
            return 1
        for r in range(args.rounds):
            names = list(trees) if r % 2 == 0 else list(trees)[::-1]
            for name in names:
                ms = time_ms(lambda: trees[name](s), args.reps)
                times.setdefault((shape, name), []).append(ms)
                print(json.dumps({"round": r, "shape": shape, "tree": name, "ms": ms,
                                  "card": card}), flush=True)
    for (shape, name), ms in times.items():
        print(json.dumps({"summary": shape, "tree": name, "mean_ms": float(np.mean(ms)),
                          "min_ms": min(ms), "max_ms": max(ms), "rounds": len(ms),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
