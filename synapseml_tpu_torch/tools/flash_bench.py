"""Time flash attention on the card, beside SDPA, its plain version and its bounds.

    python synapseml_tpu_torch/tools/flash_bench.py [--tree DIR] [--shapes d16,f32-gqa]
        [--seeds 0,1] [--passes 1] [--reps 10] [--plain]
    python synapseml_tpu_torch/tools/flash_bench.py --ab DIR DIR ... [--rounds 10] [...]

Times the public entry point ``flash_attention`` of the ``synapseml_tpu_torch``
found in ``--tree`` (default: the tree holding this file), so the same command
measures an older tree unpacked beside this one; run it as a script, not with
``python -m``, which would import the package of the current directory first
(the script refuses to measure a package from outside ``--tree``). Every result
is checked against the tree's plain f32 version (bf16 within 5e-2, f32 within
2e-5); bf16 results also get the most per-row error ``|out - ref|_2 /
|ref|_2`` over the rows (``row_rel_err``). One JSON line per shape, seed and
pass, with the card's name and power limit. ``--reps 0`` checks errors only.
``--ab`` compares trees: each round runs one process per tree, in the given
order and reversed every other round, and prints its lines with the round
number. Needs a CUDA device.

Bounds: bytes (q, k, v read and o written once) at 3.35 TB/s against
4*D flops per unmasked (query, key) pair at 989 TFLOP/s in bf16, or at
165 TFLOP/s in f32 (the TF32 rate over three, the least time in which the
tensor cores form f32-accurate products). ``ex2_floor_ms`` is one MUFU ex2 per
unmasked score at 16 a clock on each of 132 SMs at 1.83 GHz: a floor of the
softmax computed that way, not a bound of the function.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_TC_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
F32_3XTF32_FLOPS = 495e12 / 3  # TF32 tensor-core rate, three products per f32 product
EX2_PER_S = 132 * 16 * 1.83e9  # MUFU ex2 rate: 132 SMs x 16 a clock x boost clock

# name: (B, S, H, H_kv, D, dtype), all causal
SHAPES = {
    "headline": (1, 32768, 8, 8, 64, torch.bfloat16),
    "gqa": (8, 8192, 8, 2, 64, torch.bfloat16),
    "d128": (1, 32768, 8, 8, 128, torch.bfloat16),
    "d32": (2, 8192, 8, 2, 32, torch.bfloat16),
    "d16": (2, 8192, 8, 2, 16, torch.bfloat16),
    "f32-gqa": (8, 8192, 8, 2, 64, torch.float32),
    "f32-d128": (1, 8192, 8, 8, 128, torch.float32),
}


def causal_pairs(s_q: int, s_k: int) -> int:
    """(query, key) pairs the end-aligned causal mask keeps."""
    return s_q * (s_q + 1) // 2 + (s_k - s_q) * s_q


def flash_bounds(B, S, H, H_kv, D, dtype):
    """(bound_ms, bound_by, ex2_floor_ms, flops) of one causal call."""
    esz = 2 if dtype == torch.bfloat16 else 4
    pairs = B * H * causal_pairs(S, S)
    flops = 4 * D * pairs
    t_bytes = esz * B * S * D * (2 * H + 2 * H_kv) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_3XTF32_FLOPS) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound[0], bound[1], pairs / EX2_PER_S * 1e3, flops


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


def sdpa_ms(q, k, v, reps):
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps)


def row_rel_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float(((out - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def run_ab(args) -> int:
    """Time the trees of ``--ab`` alternately, one process per tree and round."""
    rc = 0
    for r in range(args.rounds):
        for tree in (args.ab if r % 2 == 0 else args.ab[::-1]):
            cmd = [sys.executable, __file__, "--tree", tree, "--shapes", args.shapes,
                   "--seeds", args.seeds, "--passes", str(args.passes), "--reps",
                   str(args.reps)] + (["--plain"] if args.plain else [])
            res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=900)
            rc = rc or res.returncode
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({"round": r, **json.loads(line)}), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the synapseml_tpu_torch package to measure")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--plain", action="store_true", help="also time the plain version")
    ap.add_argument("--ab", nargs="+", metavar="DIR", help="trees to time alternately")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bench: needs a CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return run_ab(args)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from synapseml_tpu_torch.parallel import flash
    from synapseml_tpu_torch.runtime.device import card_info

    if tree not in Path(flash.__file__).resolve().parents:
        print(f"flash_bench: imported {flash.__file__}, not the package in {tree}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    print(f"card: {card}", flush=True)

    bad = 0
    for name in (n for n in args.shapes.split(",") if n):
        B, S, H, H_kv, D, dtype = SHAPES[name]
        bound_ms, bound_by, ex2_ms, flops = flash_bounds(B, S, H, H_kv, D, dtype)
        for seed in (int(s) for s in args.seeds.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda").to(dtype)
                       for h in (H, H_kv, H_kv))
            out = flash.flash_attention(q, k, v, causal=True)
            ref = flash.dense_attention(q.float(), k.float(), v.float(), causal=True)
            err = float((out.float() - ref).abs().max())
            ok = err <= (5e-2 if dtype == torch.bfloat16 else 2e-5)
            row = {"shape": name, "B_S_H_Hkv_D": [B, S, H, H_kv, D], "dtype": str(dtype),
                   "seed": seed, "tree": str(tree), "max_abs_err": err, "err_ok": ok,
                   "bound_ms": bound_ms, "bound_by": bound_by, "ex2_floor_ms": ex2_ms,
                   "card": card}
            bad += not ok
            if dtype == torch.bfloat16:
                row["row_rel_err"] = row_rel_err(out, ref)
            del out, ref
            if args.reps > 0:
                row["library_ms"] = sdpa_ms(q, k, v, args.reps)
                if args.plain:
                    row["plain_ms"] = time_ms(
                        lambda: flash.dense_attention(q, k, v, causal=True), 2)
            for p in range(args.passes if args.reps > 0 else 1):
                if args.reps > 0:
                    ms = time_ms(lambda: flash.flash_attention(q, k, v, causal=True), args.reps)
                    row.update(ms=ms, tflops=flops / ms / 1e9)
                print(json.dumps({**row, "pass": p}), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    if bad:
        print(f"flash_bench: {bad} results outside their error limit", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
