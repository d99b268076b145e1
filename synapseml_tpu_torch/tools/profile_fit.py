"""Where the time of one GBDT fit goes, on the GPU.

    python -m synapseml_tpu_torch.tools.profile_fit [--rows 4194304] [--seed 0]

Fits ``train`` at the shape ``chip_smoke.py`` uses (28 f32 features, 63 bins,
31 leaves, 10 iterations) and prints one JSON object: the wall time of the
whole fit, of its two binning steps (``BinMapper.fit`` on the host,
``transform_torch`` on the card), the device time of every kernel name in a
``torch.profiler`` trace of a second fit, the device's busy and idle share
of that fit, and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

PARAMS = dict(objective="binary", num_iterations=10, num_leaves=31, max_bin=63)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12, help="kernel names to list")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_fit: needs a CUDA device", file=sys.stderr)
        return 2

    from ..gbdt.binning import BinMapper
    from ..gbdt.boost import train
    from ..runtime.device import card_info

    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((args.rows, 28), dtype=np.float32)
    y = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.standard_normal(args.rows, dtype=np.float32)
         > 0).astype(np.float64)
    dev = torch.device("cuda")

    train(dict(PARAMS, num_iterations=1), x[:65536], y[:65536])  # load the kernels
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    mapper = BinMapper(max_bin=PARAMS["max_bin"]).fit(x)
    bin_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapper.transform_torch(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    bin_transform_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    train(PARAMS, x, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train(PARAMS, x, y)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # some builds attribute device time to the CPU-side launch events
        kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                   if _device_us(e) > 0]
    busy_us = sum(us for _, us, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    print(json.dumps({
        "card": card_info(), "rows": args.rows, **PARAMS,
        "fit_s": fit_s, "bin_fit_s": bin_fit_s, "bin_transform_s": bin_transform_s,
        "traced_fit_s": traced_s, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / traced_s,
        "kernels": [{"name": k[:80], "device_ms": us / 1e3, "count": c}
                    for k, us, c in kernels[:args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
