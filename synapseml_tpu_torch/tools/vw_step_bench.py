"""Time kernel V: a 64-batch pass and the 1M-review fit's learning phase.

    python synapseml_tpu_torch/tools/vw_step_bench.py [--tree DIR] [--seed 0]
        [--only pass,fit] [--cache FILE.npz] [--ctas 8,16] [--long-list 16,32]
        [--phases]
    python synapseml_tpu_torch/tools/vw_step_bench.py --ab DIR DIR ... [--rounds 2]

Measures the ``synapseml_tpu_torch`` found in ``--tree`` (default: the tree
holding this file), so the same command times an older tree unpacked beside
this one; run it as a script, not with ``python -m``. ``--ab`` runs one
process per tree and round, in the given order and reversed every other
round (``--rounds 2`` over parent and change: parent, change, change,
parent). One JSON line per measurement, with the card's name and power
limit. Needs a CUDA device.

The reviews are ``chip_smoke.py`` phase 2j's: the first 1,048,576 of
``schema_data.hashed_text_rows(seed, 1,310,720)`` (2^18 slots), padded as
``pad_examples`` pads them, labels +-1. Making them takes about 35 s;
``--cache FILE.npz`` keeps them for the next process.

- ``pass``: kernel V over the first 64 batches of 256 reviews (phase 2j
  (b)'s batches), logistic, the sparse regime and l1 + l2 (1e-3, 1e-2):
  CUDA events around 5 passes after a warm-up, launched whole (one launch
  a pass, ``step_batches``, in a tree that has it) and batch by batch (one
  launch a batch, ``batch_step``); device us a batch from a
  ``torch.profiler`` trace of one pass (every kernel whose name holds
  ``vw_``); the host's us to submit a pass; whether the whole pass's state
  equals the batch-by-batch pass's, bit for bit.
- ``fit``: ``train_linear`` over the 1,048,576 reviews (2^18 slots, batch
  256, 2 passes, logistic) after a warm-up fit of 4,096 reviews: the
  learning phase's wall s (and its parts, in a tree whose fit records
  them), kernel V's launches, and a digest of the state (the same in every
  tree: each is bit-equal to the plain step).

``--ctas`` and ``--long-list`` time each combination of the cluster's
blocks (``learner.V_CLUSTER_CTAS``) and the plan's long-list threshold
(``StepPlan(long_list=)``) in the ``pass`` bench, in a tree that has them.
``--phases`` adds to each ``pass`` line the whole pass's split by phase:
the tree's ``csrc/vw_step.cu`` built with ``VW_CLOCKS`` set to 1 counts
block 0's ``clock64()`` cycles a phase (rows and the first barrier; slots,
the bias and the second barrier; the dense update and the third barrier),
and each phase's share of the cycles times the traced device us a batch
gives its device us a batch.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_TRAIN, N_MADE, NUM_BITS = 1_048_576, 1_310_720, 18
B, PASS_BATCHES, PASSES = 256, 64, 2
REGIMES = {"sparse": (0.0, 0.0), "l1_l2": (1e-3, 1e-2)}


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


def traced_us(fn) -> tuple:
    """(device us, events) of the kernels named ``vw_*`` in a trace of ``fn()``."""
    from synapseml_tpu_torch.tools.profile_fit import _device_us

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # the tracer starts behind the host: launch once it runs
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "vw_" in e.key]
    return sum(_device_us(e) for e in evts), sum(e.count for e in evts)


def reviews(seed: int, cache) -> tuple:
    """(idx (n, K) int32, val (n, K) f32, y +-1 f32) of the training reviews."""
    if cache and Path(cache).exists():
        z = np.load(cache)
        return z["idx"], z["val"], z["y"]
    from synapseml_tpu_torch.tools.schema_data import hashed_text_rows

    csr, y01 = hashed_text_rows(seed, N_MADE, NUM_BITS)
    ptr = np.asarray(csr.indptr[:N_TRAIN + 1], np.int64)
    lens = np.diff(ptr)
    K = max(int(lens.max()), 1)
    idx = np.zeros((N_TRAIN, K), np.int32)
    val = np.zeros((N_TRAIN, K), np.float32)
    rows = np.repeat(np.arange(N_TRAIN), lens)
    pos = np.arange(ptr[-1]) - np.repeat(ptr[:-1], lens)
    mask = np.uint32((1 << NUM_BITS) - 1)
    ind = np.asarray(csr.indices[:ptr[-1]]).astype(np.uint32)
    idx[rows, pos] = (ind & mask).astype(np.int32)
    val[rows, pos] = csr.values[:ptr[-1]]
    y = np.where(np.asarray(y01[:N_TRAIN]) > 0, 1.0, -1.0).astype(np.float32)
    if cache:
        np.savez(cache, idx=idx, val=val, y=y)
    return idx, val, y


PHASES = ("rows_and_barrier", "slots_bias_and_barrier", "dense_and_barrier")


def clocked_library(L):
    """Kernel V's library built from this tree's source with VW_CLOCKS=1."""
    from synapseml_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, build

    d = BUILD_DIR / "vw_clocks"
    d.mkdir(parents=True, exist_ok=True)
    (d / "vw_step.cu").write_text("#define VW_CLOCKS 1\n" + (CSRC_DIR / "vw_step.cu").read_text())
    lib = ctypes.CDLL(str(build(["vw_step"], csrc=d)["vw_step"]))
    lib.smt_vw_step.argtypes, lib.smt_vw_step.restype = L.VW_KERNEL.argtypes, ctypes.c_int
    return lib


def phase_split(L, lib, fn, nb: int, device_us: float) -> dict:
    """Cycles a batch of each phase over 5 calls of ``fn`` (a pass of ``nb``
    batches) through the clocked library, and each phase's share of
    ``device_us`` (the traced device us a batch)."""
    L.VW_KERNEL._load()
    kept, L.VW_KERNEL._fn = L.VW_KERNEL._fn, lib.smt_vw_step
    out = (ctypes.c_ulonglong * 3)()
    try:
        fn()
        torch.cuda.synchronize()
        lib.smt_vw_clocks(out)
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        if lib.smt_vw_clocks(out):
            raise RuntimeError("smt_vw_clocks failed")
    finally:
        L.VW_KERNEL._fn = kept
    cycles = [c / (5 * nb) for c in out]
    total = sum(cycles)
    return {"cycles_a_batch": dict(zip(PHASES, cycles)),
            "device_us_a_batch": {k: device_us * c / total for k, c in zip(PHASES, cycles)}}


def bench_pass(card, idx, val, y, ctas_list, long_lists, phases: bool) -> None:
    from synapseml_tpu_torch.vw import learner as L

    dev = torch.device("cuda")
    dim, nb = 1 << NUM_BITS, PASS_BATCHES
    n = nb * B
    K = max(int((idx[:n] != 0).any(axis=0).nonzero()[0].max()) + 1, 1)
    K = max(K, int((val[:n] != 0).any(axis=0).nonzero()[0].max()) + 1)
    bi = torch.from_numpy(np.ascontiguousarray(idx[:n, :K])).to(dev).view(nb, B, K)
    bv = torch.from_numpy(np.ascontiguousarray(val[:n, :K])).to(dev).view(nb, B, K)
    by = torch.from_numpy(y[:n]).to(dev).view(nb, B)
    bw = torch.ones(nb, B, device=dev)
    whole_ok = hasattr(L, "step_batches")
    # an older tree numbers a fit's steps for the dense regime's marks
    numbered = "epoch" in inspect.signature(L.batch_step).parameters
    lib = clocked_library(L) if phases and whole_ok else None
    variants = [(c, ll) for c in ctas_list for ll in long_lists] if whole_ok else [(None, None)]
    fresh = lambda: L.StepState(np.zeros(dim, np.float32), np.full(dim, 1e-6, np.float32),
                                0.0, 1e-6, np.zeros(dim, np.float32), device=dev)
    for ctas, long_list in variants:
        if ctas is not None:
            L.V_CLUSTER_CTAS = ctas
        plan = (L.StepPlan(bi, bv, dim) if long_list is None
                else L.StepPlan(bi, bv, dim, long_list))
        for regime, (l1, l2) in REGIMES.items():
            hp = L.StepHyper.make("logistic", 0.5, l1, l2, 0.5)
            scratch = L._Scratch(B, dim, dev)
            epoch = [0]

            def batches(st):
                for j in range(nb):
                    kw = {"epoch": epoch[0] + j} if numbered else {}
                    L.batch_step(st, bi[j], bv[j], by[j], bw[j], hp, plan, j, scratch=scratch,
                                 **kw)
                epoch[0] += nb

            def whole(st):
                L.step_batches(st, bi, bv, by, bw, hp, plan, 0, nb, scratch=scratch)

            rec = {"bench": "pass", "batches": nb, "batch": B, "K": K, "slots": dim,
                   "loss": "logistic", "regime": regime, "ctas": ctas, "long_list": long_list,
                   "card": card}
            for how, fn in (("whole", whole), ("by_batch", batches)):
                if how == "whole" and not whole_ok:
                    continue
                st = fresh()
                ms = time_ms(lambda: fn(st), 5)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(st)
                host_us = (time.perf_counter() - t0) * 1e6
                torch.cuda.synchronize()
                dev_us, events = traced_us(lambda: fn(st))
                rec[how] = {"ms_a_pass": ms, "us_a_batch": ms * 1e3 / nb,
                            "device_us_a_batch": dev_us / nb, "device_events": events,
                            "host_us_to_submit": host_us}
                if how == "whole" and lib is not None:
                    rec[how]["phases"] = phase_split(L, lib, lambda: whole(st), nb, dev_us / nb)
            if whole_ok:
                a, b = fresh(), fresh()
                whole(a)
                batches(b)
                rec["whole_equals_batches"] = bool(torch.equal(a.buf, b.buf)
                                                   and torch.equal(a.s, b.s))
            print(json.dumps(rec), flush=True)


def bench_fit(card, idx, val, y) -> None:
    from synapseml_tpu_torch.vw import learner as L

    kw = dict(num_bits=NUM_BITS, batch_size=B, num_passes=PASSES, loss="logistic")
    L.train_linear(idx[:4096], val[:4096], y[:4096], **kw)
    torch.cuda.synchronize()
    rec: dict = {}
    launches = L.VW_KERNEL.launches
    t0 = time.perf_counter()
    st = L.train_linear(idx, val, y, stats=rec, **kw)
    learn_s = time.perf_counter() - t0
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(np.asarray(x, np.float32)).tobytes()
                                     for x in st)).hexdigest()[:16]
    print(json.dumps({"bench": "fit", "rows": len(y), "K": idx.shape[1], "slots": 1 << NUM_BITS,
                      "batch": B, "passes": PASSES, "learn_s": learn_s,
                      "launches": L.VW_KERNEL.launches - launches,
                      "batches_a_pass": rec["batches_a_pass"],
                      "learn_seconds": rec.get("seconds"), "state_sha256": digest,
                      "card": card}), flush=True)


def run_ab(args) -> int:
    rc = 0
    for r in range(args.rounds):
        for tree in (args.ab if r % 2 == 0 else args.ab[::-1]):
            cmd = [sys.executable, __file__, "--tree", tree, "--seed", str(args.seed),
                   "--only", args.only, "--ctas", args.ctas, "--long-list", args.long_list]
            if args.phases:
                cmd.append("--phases")
            if args.cache:
                cmd += ["--cache", args.cache]
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
    ap.add_argument("--only", default="pass,fit", help="comma-separated benches: pass, fit")
    ap.add_argument("--cache", default=None, metavar="FILE.npz",
                    help="keep the padded reviews here for the next process")
    ap.add_argument("--ctas", default="", help="cluster sizes to time (default: the tree's)")
    ap.add_argument("--long-list", default="", help="long-list thresholds to time "
                                                    "(default: the tree's)")
    ap.add_argument("--phases", action="store_true",
                    help="split the whole pass by phase (a tree with VW_CLOCKS)")
    args = ap.parse_args()
    benches = args.only.split(",")
    if set(benches) - {"pass", "fit"}:
        ap.error(f"--only {args.only}: the benches are pass, fit")
    if not torch.cuda.is_available():
        print("vw_step_bench: needs a CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return run_ab(args)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import synapseml_tpu_torch as pkg
    from synapseml_tpu_torch.runtime.device import card_info

    if tree not in Path(pkg.__file__).resolve().parents:
        print(f"vw_step_bench: imported {pkg.__file__}, not the package in {tree}",
              file=sys.stderr)
        return 2
    card = card_info()
    idx, val, y = reviews(args.seed, args.cache)
    parse = lambda text: [int(x) for x in text.split(",") if x] or [None]
    if "pass" in benches:
        bench_pass(card, idx, val, y, parse(args.ctas), parse(args.long_list), args.phases)
    if "fit" in benches:
        bench_fit(card, idx, val, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
