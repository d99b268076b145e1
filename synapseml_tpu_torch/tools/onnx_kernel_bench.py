"""Time kernels Q and R at the ONNX executor's main-path shapes.

    python synapseml_tpu_torch/tools/onnx_kernel_bench.py [--only q,conv,r] [--seed 0]
    python synapseml_tpu_torch/tools/onnx_kernel_bench.py --ab PARENT_TREE [--rounds 2]

Measures this tree's wrappers (``onnx/qgemm.py``, ``onnx/rnn.py``) with CUDA
events, one JSON line a shape, each with the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``). Needs a CUDA device.

- ``q``: Q's matmul entry at BERT-base's three projections (64 x 128 tokens;
  uint8 activations with a 0-d zero point on the card, an int8 weight with
  zero point 0, packed once as the executor packs it), also with the weight
  packed a call, and the int8 x int8 form without zero points beside
  ``torch._int_mm`` (the one form it takes), which must give the same bits.
- ``conv``: Q's conv entry at ResNet-50's 25 convolution shapes at batch 128
  (uint8 x with a zero point, int8 w, packed once), and the sum over a
  batch's 53 convolutions.
- ``r``: R at GNMT's width (S = 128, B = 64, H = 1,024) in the six
  configurations of ``chip_smoke.py``'s phase 4, which entry served each,
  and cuDNN's LSTM / GRU layer (``torch.nn.LSTM`` / ``torch.nn.GRU``, TF32
  off, the input projection included) beside R with the projection.
- ``rstep``: R's one-launch-a-step entry at ``chip_smoke.py``'s
  RNN_STEPWISE (S = 8, B = 64, H = 2,048: R past every block's shared
  memory), LSTM in f32 and bf16 and GRU with linear_before_reset=0 in f32,
  with cuDNN's layer beside the f32 ones (``torch.nn.GRU`` computes
  linear_before_reset=1, the nearest library call).

``--ab PARENT_TREE`` builds the parent tree's ``csrc/qgemm.cu`` and
``csrc/rnn_step.cu`` (``kernels/build.py::build(csrc=...)``) beside this
tree's, and times both in this one process at every shape, in the order
parent, change, change, parent for each of ``--rounds`` rounds: the parent
through its own C interface (the first design's ``QArgs``, which took B as
it lies; its R entry ``smt_rnn_steps``), the change through this tree's
wrappers. Q's outputs of the two must be equal bit for bit; each R's
within the plain step's tolerances (1e-5 f32, 2e-2 of a row's norm bf16).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[2]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from synapseml_tpu_torch.kernels.build import build  # noqa: E402
from synapseml_tpu_torch.onnx import qgemm, rnn  # noqa: E402
from synapseml_tpu_torch.tools.kernel_cases import (BERT_BASE_PROJECTIONS,  # noqa: E402
                                                    RESNET50_CONVS, rnn_step_case)

BATCH_IMAGES = 128
RNN_GNMT = (128, 64, 1024)
RNN_STEPWISE = (8, 64, 2048)
R_SHAPES = (("lstm_cudnn_config_f32", "LSTM", 0, torch.float32, False),
            ("lstm_peepholes_f32", "LSTM", 0, torch.float32, True),
            ("lstm_peepholes_bf16", "LSTM", 0, torch.bfloat16, True),
            ("gru_lbr0_f32", "GRU", 0, torch.float32, True),
            ("gru_lbr0_bf16", "GRU", 0, torch.bfloat16, True),
            ("gru_lbr1_f32", "GRU", 1, torch.float32, True))
R_STEPWISE_SHAPES = (("lstm_wide_f32", "LSTM", 0, torch.float32, False),
                     ("lstm_wide_bf16", "LSTM", 0, torch.bfloat16, False),
                     ("gru_lbr0_wide_f32", "GRU", 0, torch.float32, True))
# the shapes timed beside cuDNN's layer
R_CUDNN = ("lstm_cudnn_config_f32", "gru_lbr1_f32", "lstm_wide_f32", "gru_lbr0_wide_f32")
# ResNet-50's convolutions a batch by shape (the zoo's graph: the stem, per
# stage one of each first-block conv and (blocks - 1) of each later one)
RESNET50_BLOCKS = (3, 4, 6, 3)


def conv_count(name: str) -> int:
    if name.startswith("stem"):
        return 1
    reps = RESNET50_BLOCKS[int(name[1])]
    if "_later_" in name:
        return reps - 1
    return reps if "_expand_" in name else 1


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


# -- the parent's C interface (the first design's QArgs) --------------------------------------

class _QArgsFirst(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("a", "b", "out", "a_zp_vec", "b_zp_vec", "bias", "scale_vec", "y_zp_vec")] + \
               [(name, ctypes.c_longlong) for name in
                ("a_batch", "b_batch", "out_batch", "lda", "ldb_k", "ldb_n", "a_zp_sm",
                 "b_zp_sn", "scale_sm", "scale_sn", "yzp_sm", "yzp_sn")] + \
               [("scale", ctypes.c_float)] + \
               [(name, ctypes.c_int) for name in
                ("M", "N", "K", "batch", "a_signed", "b_signed", "out_mode", "a_zp", "b_zp",
                 "y_zp", "n_img", "C", "H", "W", "KH", "KW", "OH", "OW", "sh", "sw", "ph", "pw",
                 "dh", "dw", "groups", "cin_g", "cout_g", "device")]


class Parent:
    """The parent tree's kernels Q and R, built from its sources and called
    through its C interface."""

    def __init__(self, tree: Path):
        csrc = tree / "synapseml_tpu_torch" / "csrc"
        libs = build(["qgemm", "rnn_step"], csrc=csrc)
        self.q = ctypes.CDLL(str(libs["qgemm"]))
        self.r = ctypes.CDLL(str(libs["rnn_step"]))
        for fn in (self.q.smt_qmatmul, self.q.smt_qconv, self.r.smt_rnn_steps):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int

    @staticmethod
    def _call(fn, args) -> None:
        err = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel: CUDA error {err}")

    def qmatmul(self, a, b, za=None):
        """A (M, K) x B (K, N) int32, A's 0-d zero point, B's none."""
        M, K = a.shape
        N = b.shape[1]
        keep = [za.to(torch.int32)] if za is not None else []
        out = torch.empty((M, N), dtype=torch.int32, device=a.device)
        args = _QArgsFirst()
        args.a, args.b, args.out = a.data_ptr(), b.data_ptr(), out.data_ptr()
        args.a_batch, args.out_batch, args.lda, args.ldb_k, args.ldb_n = M * K, M * N, K, N, 1
        args.M, args.N, args.K, args.batch = M, N, K, 1
        args.a_signed, args.b_signed = int(a.dtype == torch.int8), int(b.dtype == torch.int8)
        if keep:
            args.a_zp_vec = keep[0].data_ptr()
        args.device = a.device.index or 0
        self._call(self.q.smt_qmatmul, args)
        return out

    def qconv(self, x, w, xz, strides, pads):
        n, C, H, W = x.shape
        cout, cin_g, KH, KW = w.shape
        OH = (H + sum(pads[0]) - KH) // strides[0] + 1
        OW = (W + sum(pads[1]) - KW) // strides[1] + 1
        zp = xz.to(torch.int32)
        out = torch.empty((n, cout, OH, OW), dtype=torch.int32, device=x.device)
        args = _QArgsFirst()
        args.a, args.b, args.out, args.a_zp_vec = (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                                   zp.data_ptr())
        args.M, args.N, args.K, args.batch = n * OH * OW, cout, cin_g * KH * KW, 1
        args.a_signed, args.b_signed = int(x.dtype == torch.int8), int(w.dtype == torch.int8)
        (args.n_img, args.C, args.H, args.W, args.KH, args.KW, args.OH, args.OW) = \
            (n, C, H, W, KH, KW, OH, OW)
        args.sh, args.sw, args.ph, args.pw, args.dh, args.dw = (strides[0], strides[1],
                                                                pads[0][0], pads[1][0], 1, 1)
        args.groups, args.cin_g, args.cout_g = 1, cin_g, cout
        args.device = x.device.index or 0
        self._call(self.q.smt_qconv, args)
        return out

    def rnn(self, kind, c, lbr):
        """The parent's one-launch-a-step entry on this tree's R arguments."""
        S, B, GH = c["gx"].shape
        H = c["r"].shape[-1]
        y = torch.empty((S, B, H), dtype=c["gx"].dtype, device=c["gx"].device)
        keep = []
        args = rnn._RArgs()
        args.gx, args.r, args.h0, args.y = (c["gx"].data_ptr(), c["r"].data_ptr(),
                                            c["h0"].data_ptr(), y.data_ptr())
        if kind == "LSTM":
            cc = c["c0"].clone()
            keep.append(cc)
            args.c = cc.data_ptr()
            if c["p"] is not None:
                args.p = c["p"].data_ptr()
        else:
            if c["rb"] is not None:
                args.rb = c["rb"].data_ptr()
            if not lbr:
                scratch = torch.empty((2, B, H), dtype=y.dtype, device=y.device)
                keep.append(scratch)
                args.z, args.rh = scratch[0].data_ptr(), scratch[1].data_ptr()
        args.S, args.B, args.H = S, B, H
        args.kind, args.lbr = (0 if kind == "LSTM" else 1), lbr
        args.bf16 = int(y.dtype == torch.bfloat16)
        args.act_f, args.act_g, args.act_h = 0, 1, 1
        args.device = y.device.index or 0
        self._call(self.r.smt_rnn_steps, args)
        return (y, cc) if kind == "LSTM" else (y,)


def _ab(parent_fn, change_fn, rounds: int, reps: int):
    """(parent ms, change ms): each the mean over rounds of parent, change,
    change, parent."""
    p, c = [], []
    for _ in range(rounds):
        p.append(time_ms(parent_fn, reps))
        c.append(time_ms(change_fn, reps))
        c.append(time_ms(change_fn, reps))
        p.append(time_ms(parent_fn, reps))
    return sum(p) / len(p), sum(c) / len(c)


def _emit(rec: dict, card_text: str) -> None:
    rec["card"] = card_text
    print(json.dumps(rec), flush=True)


def bench_q(parent, gen, dev, rounds, card_text):
    u8 = lambda *s: torch.randint(0, 256, s, generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.uint8)
    s8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8)
    za = torch.tensor(117, dtype=torch.uint8, device=dev)
    for name, (M, K, N) in BERT_BASE_PROJECTIONS.items():
        a, b, a8 = u8(M, K), s8(K, N), s8(M, K)
        packed = qgemm.pack_matmul_b(b)
        change = lambda: qgemm.qmatmul(a, b, za, packed=packed)
        rec = {"bench": "q_matmul", "shape": name, "M_K_N": [M, K, N]}
        if parent is not None:
            if not torch.equal(parent.qmatmul(a, b, za), change()):
                raise SystemExit(f"kernel Q {name}: parent and change differ")
            rec["parent_ms"], rec["ms"] = _ab(lambda: parent.qmatmul(a, b, za), change, rounds, 20)
            rec["parent_int8_ms"], rec["int8_ms"] = _ab(
                lambda: parent.qmatmul(a8, b), lambda: qgemm.qmatmul(a8, b, packed=packed),
                rounds, 20)
        else:
            rec["ms"] = time_ms(change, 20)
            rec["int8_ms"] = time_ms(lambda: qgemm.qmatmul(a8, b, packed=packed), 20)
        rec["ms_b_packed_a_call"] = time_ms(lambda: qgemm.qmatmul(a, b, za), 20)
        if not torch.equal(qgemm.qmatmul(a8, b, packed=packed), torch._int_mm(a8, b)):
            raise SystemExit(f"kernel Q {name}: int8 x int8 differs from torch._int_mm")
        rec["torch_int_mm_ms"] = time_ms(lambda: torch._int_mm(a8, b), 20)
        rec["tops"] = 2.0 * M * N * K / rec["ms"] / 1e9
        _emit(rec, card_text)
        del a, b, a8, packed


def bench_conv(parent, gen, dev, rounds, card_text):
    u8 = lambda *s: torch.randint(0, 256, s, generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.uint8)
    s8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev,
                                  dtype=torch.int32).to(torch.int8)
    xz = torch.tensor(131, dtype=torch.uint8, device=dev)
    total = {"ms": 0.0, "parent_ms": 0.0}
    for name, c in RESNET50_CONVS.items():
        x, w = u8(BATCH_IMAGES, *c["x"][1:]), s8(*c["w"])
        st = tuple(c["attrs"].get("strides", [1, 1]))
        p = c["attrs"].get("pads", [0, 0, 0, 0])
        pads = ((p[0], p[2]), (p[1], p[3]))
        packed = qgemm.pack_conv_w(w)
        change = lambda: qgemm.qconv(x, w, xz, None, st, pads, packed=packed)
        rec = {"bench": "q_conv", "shape": name, "x": list(x.shape), "w": list(w.shape),
               "strides": list(st), "convs_a_batch": conv_count(name)}
        if parent is not None:
            if not torch.equal(parent.qconv(x, w, xz, st, pads), change()):
                raise SystemExit(f"kernel Q {name}: parent and change differ")
            rec["parent_ms"], rec["ms"] = _ab(lambda: parent.qconv(x, w, xz, st, pads), change,
                                              rounds, 5)
            total["parent_ms"] += rec["parent_ms"] * rec["convs_a_batch"]
        else:
            rec["ms"] = time_ms(change, 5)
        rec["channels_last_ms"] = time_ms(lambda: qgemm.channels_last(x, 1, packed.cin_p, xz), 5)
        total["ms"] += rec["ms"] * rec["convs_a_batch"]
        _emit(rec, card_text)
        del x, w, packed
    _emit({"bench": "q_conv_resnet50_batch", "convs": 53, **total}, card_text)


def _rnn_err(got, want, dtype) -> float:
    errs = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            errs.append(float((g - w).abs().max()))
        else:
            g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
            errs.append(float(((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)).max()))
    return max(errs)


def bench_r(parent, gen, dev, rounds, card_text, seed, shapes=R_SHAPES, dims=RNN_GNMT):
    S, B, H = dims
    for name, kind, lbr, dtype, peep in shapes:
        c = rnn_step_case(kind, S, B, H, dtype, dev, seed=seed, peepholes=peep)
        if kind == "LSTM":
            change = lambda: rnn.lstm_steps(c["gx"], c["r"], c["h0"], c["c0"], c["p"])
            want = rnn.lstm_steps_plain(c["gx"], c["r"], c["h0"], c["c0"], c["p"])
            want = (want[0], want[2])   # Y and the cell state
        else:
            change = lambda: rnn.gru_steps(c["gx"], c["r"], c["h0"], c["rb"], lbr)
            want = rnn.gru_steps_plain(c["gx"], c["r"], c["h0"], c["rb"], lbr)[:1]
        before = (rnn.RNN_KERNEL.launches, rnn.RNN_STEP_KERNEL.launches)
        got = change()
        entry = "persistent" if rnn.RNN_KERNEL.launches > before[0] else "stepwise"
        rec = {"bench": "r", "shape": name, "kind": kind, "linear_before_reset": lbr,
               "dtype": str(dtype), "S_B_H": [S, B, H], "entry": entry,
               "max_err_vs_plain": _rnn_err((got[0], got[2]) if kind == "LSTM" else got[:1],
                                            want, dtype)}
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        if parent is not None:
            rec["parent_max_err_vs_plain"] = _rnn_err(parent.rnn(kind, c, lbr), want, dtype)
        for key in ("max_err_vs_plain", "parent_max_err_vs_plain"):
            if not rec.get(key, 0.0) <= tol:
                raise SystemExit(f"kernel R {name}: {key} {rec[key]} > {tol}")
        if parent is not None:
            rec["parent_ms"], rec["ms"] = _ab(lambda: parent.rnn(kind, c, lbr), change,
                                              rounds, 3)
        else:
            rec["ms"] = time_ms(change, 5)
        if name in R_CUDNN:
            layer = (torch.nn.LSTM if kind == "LSTM" else torch.nn.GRU)(H, H).to(dev)
            xin = torch.randn(S, B, H, generator=gen, device=dev)
            w_ih, b_ih = layer.weight_ih_l0.detach(), layer.bias_ih_l0.detach()
            with torch.no_grad():
                rec["cudnn_ms"] = time_ms(lambda: layer(xin), 5)

                def with_projection():
                    gx = torch.matmul(xin, w_ih.T) + b_ih
                    return (rnn.lstm_steps(gx, c["r"], c["h0"], c["c0"]) if kind == "LSTM"
                            else rnn.gru_steps(gx, c["r"], c["h0"], c["rb"], lbr))

                rec["ms_with_input_projection"] = time_ms(with_projection, 5)
            del layer, xin
        _emit(rec, card_text)
        del c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, default=None, help="the parent tree to time beside")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="q,conv,r,rstep")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("onnx_kernel_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_text = card()
    t0 = time.perf_counter()
    build(["qgemm", "rnn_step"])
    parent = Parent(args.ab) if args.ab is not None else None
    print(f"built in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    only = set(args.only.split(","))
    if "q" in only:
        bench_q(parent, gen, dev, args.rounds, card_text)
    if "conv" in only:
        bench_conv(parent, gen, dev, args.rounds, card_text)
    if "r" in only:
        bench_r(parent, gen, dev, args.rounds, card_text, args.seed)
    if "rstep" in only:
        bench_r(parent, gen, dev, args.rounds, card_text, args.seed, R_STEPWISE_SHAPES,
                RNN_STEPWISE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
