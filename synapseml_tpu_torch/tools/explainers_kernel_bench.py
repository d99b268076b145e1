"""Time kernel L (the explainers' lasso) at LIME's shapes.

    python synapseml_tpu_torch/tools/explainers_kernel_bench.py [--ks 32,200,256] [--seed 0]
    python synapseml_tpu_torch/tools/explainers_kernel_bench.py --ab PARENT_TREE [--rounds 2]

Measures this tree's ``explainers/regression.py::lasso_cd`` with CUDA
events on 512 fits (256 instances x 2 targets, LIME's 1,000 samples, alpha
0.01, 100 sweeps; ``kernel_cases.lasso_case``), one JSON line a k, each
with the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``), the kernel's bound (max_iter * k * 2k
flops a fit at the f32 rate, or the Gram matrices, Xty, sq and beta moved
once), whether the Gram matrix sits in shared memory
(``lasso_smem_k()``) and its error against the plain version. Needs a
CUDA device.

``--ab PARENT_TREE`` builds the parent tree's ``csrc/lasso_cd.cu``
(``kernels/build.py::build(csrc=...)``) beside this tree's and times both
in this one process, in the order parent, change, change, parent for each
of ``--rounds`` rounds: the parent through its own ``smt_lasso_cd`` (the
same C interface), the change through this tree's wrapper. Each must stay
within ``LASSO_TOL`` of the plain version and of the other, with the same
zero coefficients but at a tie of |rho| with lam (``kernel_cases.lasso_ties``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[2]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from synapseml_tpu_torch.explainers import regression as reg  # noqa: E402
from synapseml_tpu_torch.kernels.build import build  # noqa: E402
from synapseml_tpu_torch.tools.kernel_cases import lasso_case, lasso_ties  # noqa: E402

M, INSTANCES, TARGETS, ALPHA, ITERS = 1000, 256, 2, 0.01, 100
F32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()


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


class Parent:
    """The parent tree's kernel L, built from its source and called through
    its ``smt_lasso_cd``."""

    def __init__(self, tree: Path):
        lib = ctypes.CDLL(str(build(["lasso_cd"], csrc=tree / "synapseml_tpu_torch" /
                                    "csrc")["lasso_cd"]))
        self.fn = lib.smt_lasso_cd
        self.fn.argtypes = reg.LASSO_KERNEL.argtypes
        self.fn.restype = ctypes.c_int

    def lasso_cd(self, gram, xty, sq, lam, max_iter):
        n, t, k = xty.shape
        beta = torch.empty_like(xty)
        err = self.fn(gram.data_ptr(), xty.data_ptr(), sq.data_ptr(), beta.data_ptr(), n * t, t,
                      k, int(max_iter), float(np.float32(lam)),
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel L: CUDA error {err}")
        return beta


def _check(got, want, ties, what: str) -> float:
    """max |got - want|, which must be within LASSO_TOL, with the same zero
    coefficients but at ``ties`` (``kernel_cases.lasso_ties``)."""
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    flips = (got == 0) != (want == 0)
    if not err <= reg.LASSO_TOL * scale or not bool(ties[flips].all()):
        raise SystemExit(f"kernel L {what}: {err} from the other (limit {reg.LASSO_TOL * scale}) "
                         f"or zero coefficients differ away from a tie")
    return err


def bench(k: int, parent, rounds: int, seed: int, dev, card_text: str) -> dict:
    X, Y, w = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
               for a in lasso_case(seed + k, INSTANCES, M, k, TARGETS))
    *_, Xr, Yr = reg.rescaled(X, Y, w)
    gram, xty, sq = reg.lasso_system(Xr, Yr)
    lam = ALPHA * M
    change = lambda: reg.lasso_cd(gram, xty, sq, lam, ITERS)
    got = change()
    t0 = time.perf_counter()
    plain = reg.lasso_cd_plain(gram, xty, sq, lam, ITERS)
    torch.cuda.synchronize()
    ties = lasso_ties(gram, xty, plain, lam)
    fits = INSTANCES * TARGETS
    n_bytes = 4 * (gram.numel() + sq.numel() + 2 * xty.numel())
    flops = fits * ITERS * k * 2 * k
    bound = max(n_bytes / HBM_BYTES_S, flops / F32_FLOPS) * 1e3
    rec = {"bench": "lasso", "k": k, "fits": fits, "m": M, "sweeps": ITERS,
           "gram_in_smem": k <= reg.lasso_smem_k(), "smem_k": reg.lasso_smem_k(),
           "plain_ms": (time.perf_counter() - t0) * 1e3,
           "max_err_vs_plain": _check(got, plain, ties, f"k={k} against its plain version"),
           "zero_flips_at_ties": int(((got == 0) != (plain == 0)).sum()),
           "bound_ms": bound, "bound_by": "bytes" if n_bytes / HBM_BYTES_S > flops / F32_FLOPS
           else "operations"}
    reps = 5 if k <= 200 else 2
    if parent is not None:
        old = lambda: parent.lasso_cd(gram, xty, sq, lam, ITERS)
        rec["parent_max_err_vs_plain"] = _check(old(), plain, ties,
                                                f"k={k}, parent, against plain")
        rec["max_err_vs_parent"] = _check(got, old(), ties, f"k={k} against the parent")
        p, c = [], []
        for _ in range(rounds):
            p.append(time_ms(old, reps))
            c.append(time_ms(change, reps))
            c.append(time_ms(change, reps))
            p.append(time_ms(old, reps))
        rec["parent_ms_each"], rec["ms_each"] = p, c
        rec["parent_ms"], rec["ms"] = sum(p) / len(p), sum(c) / len(c)
    else:
        rec["ms"] = time_ms(change, reps)
    rec["card"] = card_text
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, default=None, help="the parent tree to time beside")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ks", default="32,200,256")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("explainers_kernel_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card_text = card()
    t0 = time.perf_counter()
    build(["lasso_cd"])
    parent = Parent(args.ab) if args.ab is not None else None
    print(f"built in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    dev = torch.device("cuda")
    for k in (int(v) for v in args.ks.split(",")):
        bench(k, parent, args.rounds, args.seed, dev, card_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
