"""Where kernel F's time goes: variants of ``csrc/lambdarank.cu`` with one
phase taken out, and one that counts clock cycles a phase, timed in turns in
one process at MSLR-WEB30K's training shape.

    python synapseml_tpu_torch/tools/lambdarank_phases.py [--truncation 30] [--rounds 3]
        [--seed 0]

A variant is the source with one phase's loop emptied: ``no_fill`` (the
cells), ``no_sort`` (the keys stay in index order), ``no_walk`` (the top
documents' walks), ``no_column_sums``. Its output is wrong and only its time
counts: the kernel's time less a variant's is what that phase adds to the
launch. ``clocked`` reads ``clock64()`` on thread 0 at the phase barriers
(and on the first walker around its walk), summed over the blocks: cycles a
block spends in the sort (with the loads of its keys), the setup (the top
documents and the first chunk's columns), the fills, and the rest. Rows,
margins and timing as ``lambdarank_bench.py``; JSON lines with the card's
name and power limit. Needs a CUDA device. The edits are anchored on lines
of the source; ``tests/test_torch_lambdarank_schedule.py`` checks that every
anchor is still there.
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

from synapseml_tpu_torch.gbdt.lambdarank import LAMBDARANK_KERNEL, QueryGroups  # noqa: E402
from synapseml_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, build  # noqa: E402

_CLOCK = """__device__ unsigned long long g_phase[8];
namespace {
__shared__ long long s_clk;
__device__ __forceinline__ void tick(int i) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    atomicAdd(&g_phase[i], (unsigned long long)(t - s_clk));
    s_clk = t;
  }
}
"""
FILL = "    for (int id = tid; id < n_top + T * ncol; id += kThreads) {\n"
SORTED = "  bitonic_sort(keys, P);\n"
WALK = "    } else if (walker >= 0) {  // a top document: the chunk's walk, in j order\n"
SUMS = "    if (tid < ncol) {  // a column: its sums over the top documents, in index order\n"
KEYS_DEAD = "  __syncthreads();  // the keys are dead: their region takes the tables or the records\n"
LOOP = "  int w0 = 0;  // the walk so far covers the documents before w0\n  __syncthreads();\n"
FILLED = "    __syncthreads();\n    // the sums read every cell and keep the counted ones"
STARTED = "  if (m <= 0) return;\n"
ENDED = "    run_query<false>(smem, q, start, m, a);\n"
# name: [(anchor, replacement)]
VARIANTS = {
    "full": [],
    "no_fill": [(FILL, FILL.replace("id < n_top + T * ncol", "id < 0"))],
    "no_sort": [(SORTED, "")],
    "no_walk": [(WALK, WALK.replace("walker >= 0", "false"))],
    "no_column_sums": [(SUMS, SUMS.replace("tid < ncol", "false"))],
    "clocked": [
        ("namespace {\n", _CLOCK),
        (STARTED, STARTED + "  const long long t_begin = clock64();\n"
                            "  if (threadIdx.x == 0) s_clk = t_begin;\n"),
        (KEYS_DEAD, KEYS_DEAD + "  tick(0);\n"),
        (LOOP, LOOP + "  tick(1);\n"),
        (FILLED, "    __syncthreads();\n    tick(2);\n    const long long t_walk = clock64();\n"
                 "    // the sums read every cell and keep the counted ones"),
        ("    w0 = w1;\n", "    if (walker == 0) atomicAdd(&g_phase[4], "
                           "(unsigned long long)(clock64() - t_walk));\n    w0 = w1;\n"),
        (ENDED, ENDED + "  __syncthreads();\n  tick(3);\n  if (threadIdx.x == 0) {\n"
                        "    atomicAdd(&g_phase[5], 1ull);\n"
                        "    atomicAdd(&g_phase[6], (unsigned long long)(clock64() - t_begin));\n"
                        "  }\n"),
        ('extern "C" const char* smt_error_string',
         'extern "C" int smt_phases(unsigned long long* out, int reset) {\n'
         '  if (reset) {\n    const unsigned long long z[8] = {0};\n'
         '    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  }\n'
         '  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n\n'
         'extern "C" const char* smt_error_string'),
    ],
}
PHASES = ("sort", "setup", "fill", "sums_and_walk", "walk_of_walker_0", "blocks", "block")


def variant_source(name: str, source: str) -> str:
    for anchor, new in VARIANTS[name]:
        if anchor not in source:
            raise ValueError(f"variant {name}: anchor not in the source: {anchor!r}")
        source = source.replace(anchor, new, 1)
    return source


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--truncation", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lambdarank_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from synapseml_tpu_torch.runtime.device import card_info
    from synapseml_tpu_torch.tools.lambdarank_bench import time_ms
    from synapseml_tpu_torch.tools.schema_data import MSLR_TRAIN, mslr_rows

    card, dev = card_info(), torch.device("cuda")
    source = (CSRC_DIR / "lambdarank.cu").read_text()
    libs = {}
    for name in VARIANTS:
        d = BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "lambdarank.cu").write_text(variant_source(name, source))
        libs[name] = d
    for name, d in libs.items():
        libs[name] = ctypes.CDLL(str(build(["lambdarank"], csrc=d)["lambdarank"]))
    fns = {}
    for name, lib in libs.items():
        fns[name] = lib.smt_lambdarank
        fns[name].argtypes, fns[name].restype = LAMBDARANK_KERNEL.argtypes, ctypes.c_int
    _, y_np, sizes = mslr_rows(args.seed, *MSLR_TRAIN)
    n = len(y_np)
    groups = QueryGroups(sizes, y_np, args.truncation, dev)
    y = torch.from_numpy(y_np.astype(np.float32)).to(dev)
    w = torch.ones(n, device=dev)
    g, h = torch.empty(n, device=dev), torch.empty(n, device=dev)
    rng = np.random.default_rng(args.seed)
    margins = {"iteration0": np.zeros(n, np.float32),
               "seeded": (np.round(rng.normal(size=n) * 1024) / 1024).astype(np.float32)}
    for shape, s_np in margins.items():
        s = torch.from_numpy(s_np).to(dev)

        def call(fn):
            err = fn(s.data_ptr(), y.data_ptr(), groups.gain.data_ptr(), w.data_ptr(),
                     groups.blocks.data_ptr(), groups.max_dcg.data_ptr(), groups.disc.data_ptr(),
                     n, len(sizes), groups.G, groups.truncation, 1.0, 1.0, None, g.data_ptr(),
                     h.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"smt_lambdarank: CUDA error {err}")

        times = {}
        for r in range(args.rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times.setdefault(name, []).append(time_ms(lambda: call(fns[name]), args.reps))
        phases = (ctypes.c_ulonglong * 8)()
        libs["clocked"].smt_phases(phases, 1)
        call(fns["clocked"])
        torch.cuda.synchronize()
        libs["clocked"].smt_phases(phases, 0)
        blocks = phases[5]
        print(json.dumps({
            "shape": shape, "truncation": args.truncation, "card": card,
            "ms": {k: float(np.mean(v)) for k, v in times.items()},
            "cycles_a_block": {k: phases[i] / blocks for i, k in enumerate(PHASES)
                               if k != "blocks"},
            "blocks": blocks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
