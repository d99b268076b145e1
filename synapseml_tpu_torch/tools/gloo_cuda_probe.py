"""Ask gloo whether it takes CUDA tensors in an all-to-all and in send / recv.

    python synapseml_tpu_torch/tools/gloo_cuda_probe.py

Two processes on ``cuda:0`` join one gloo world (a file store in a temporary
directory) and try, on CUDA tensors, ``all_to_all_single`` and then a send /
recv pair (``batch_isend_irecv``), each checked against the values sent.
Prints one JSON line with each rank's answers; a rank that ends without an
answer (gloo may abort the process) is reported with its exit code. The
port's ``runtime/collectives.py`` stages what gloo refuses through host
memory. Needs a CUDA device.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import sys
import tempfile
import traceback

import torch

TIMEOUT_S = 20


def _ask(rank: int) -> dict:
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    t = torch.full((4, 8), float(rank), device=dev)
    out = {}
    try:
        got = torch.empty_like(t)
        dist.all_to_all_single(got, t)
        torch.cuda.synchronize()
        want = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)[:, None].expand(4, 8)
        out["all_to_all"] = "takes CUDA tensors" if torch.equal(got, want) else "wrong values"
    except RuntimeError as e:
        out["all_to_all"] = f"refused: {str(e)[:160]}"
    try:
        got = torch.empty_like(t)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                        dist.P2POp(dist.irecv, got, 1 - rank)])
        for w in works:
            w.wait()
        torch.cuda.synchronize()
        out["send_recv"] = ("takes CUDA tensors" if torch.equal(got, torch.full_like(
            t, float(1 - rank))) else "wrong values")
    except RuntimeError as e:
        out["send_recv"] = f"refused: {str(e)[:160]}"
    return out


def _rank(rank: int, store: str, outbox) -> None:
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        outbox.put((rank, _ask(rank)))
    except BaseException:  # the answer goes back to the parent
        outbox.put((rank, traceback.format_exc()[-400:]))


def main() -> int:
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    outbox = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="gloo_probe_")
    procs = [ctx.Process(target=_rank, args=(r, os.path.join(store_dir, "store"), outbox))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            try:
                rank, res = outbox.get(timeout=3 * TIMEOUT_S)
            except Exception:   # a rank ended without an answer
                break
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    for r, p in enumerate(procs):
        got.setdefault(r, f"no answer (exit code {p.exitcode})")
    print(json.dumps({"gloo_cuda_probe": got, "torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
