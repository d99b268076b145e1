"""Builder-backed ONNX model zoo (copy of ``synapseml_tpu/models/zoo.py``).

The reference's ``ModelDownloader`` fetches pretrained CNTK/ONNX graphs from an Azure
blob (``deep-learning/.../downloader/ModelDownloader.scala:26-263``). This environment
is zero-egress, so the zoo *generates* architecture-faithful ONNX graphs with seeded
random weights instead: identical graph topology, shapes, and op mix to the published
models — sufficient for throughput benchmarking, integration tests, and architecture
validation (weights are obviously not the pretrained ones; load real weights via
``weights`` overrides when available).

Models: ResNet-18/50 (v1.5 bottleneck), a BERT-base-style encoder, ViT-B/16.
All emit both a logits output and a penultimate feature output, so ``ImageFeaturizer``
can "cut" the head exactly like the reference's ``cutOutputLayers``
(``ImageFeaturizer.scala:40-197``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..onnx.builder import make_graph, make_model, node, value_info
from ..onnx.wire import ModelProto, serialize_model

__all__ = ["resnet", "bert_encoder", "vit", "MODEL_BUILDERS", "build_model_bytes"]


class _W:
    """Weight factory with deterministic He-style init."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.store: Dict[str, np.ndarray] = {}

    def conv(self, name: str, cout: int, cin: int, k: int) -> str:
        fan_in = cin * k * k
        self.store[name] = (
            self.rng.normal(0, np.sqrt(2.0 / fan_in), size=(cout, cin, k, k)).astype(np.float32)
        )
        return name

    def mat(self, name: str, rows: int, cols: int) -> str:
        self.store[name] = (
            self.rng.normal(0, np.sqrt(1.0 / rows), size=(rows, cols)).astype(np.float32)
        )
        return name

    def vec(self, name: str, n: int, value: Optional[float] = None) -> str:
        if value is None:
            self.store[name] = self.rng.normal(0, 0.02, size=n).astype(np.float32)
        else:
            self.store[name] = np.full(n, value, dtype=np.float32)
        return name

    def bn(self, prefix: str, c: int) -> Tuple[str, str, str, str]:
        return (
            self.vec(f"{prefix}_scale", c, 1.0),
            self.vec(f"{prefix}_bias", c, 0.0),
            self.vec(f"{prefix}_mean", c, 0.0),
            self.vec(f"{prefix}_var", c, 1.0),
        )


def _conv_bn_relu(nodes, w: _W, name, x, cout, cin, k, stride, pad, relu=True):
    wname = w.conv(f"{name}_w", cout, cin, k)
    nodes.append(node("Conv", [x, wname], [f"{name}_c"], kernel_shape=[k, k],
                      strides=[stride, stride], pads=[pad, pad, pad, pad]))
    s, b, m, v = w.bn(f"{name}_bn", cout)
    nodes.append(node("BatchNormalization", [f"{name}_c", s, b, m, v], [f"{name}_b"],
                      epsilon=1e-5))
    if relu:
        nodes.append(node("Relu", [f"{name}_b"], [f"{name}_r"]))
        return f"{name}_r", cout
    return f"{name}_b", cout


def resnet(depth: int = 50, num_classes: int = 1000, seed: int = 0) -> ModelProto:
    """ResNet v1.5 (stride-2 in the 3x3 of bottlenecks). Input ``data``: (N,3,224,224)
    float32 (normalized). Outputs: ``logits`` (N, num_classes) and ``features``
    (N, feat_dim) — the GAP layer, i.e. the reference's 'one layer cut' featurization."""
    cfgs = {
        18: ("basic", [2, 2, 2, 2]),
        34: ("basic", [3, 4, 6, 3]),
        50: ("bottleneck", [3, 4, 6, 3]),
        101: ("bottleneck", [3, 4, 23, 3]),
        152: ("bottleneck", [3, 8, 36, 3]),
    }
    block_kind, reps = cfgs[depth]
    w = _W(seed)
    nodes: List = []
    x, c = _conv_bn_relu(nodes, w, "stem", "data", 64, 3, 7, 2, 3)
    nodes.append(node("MaxPool", [x], ["stem_p"], kernel_shape=[3, 3], strides=[2, 2],
                      pads=[1, 1, 1, 1]))
    x, c = "stem_p", 64
    widths = [64, 128, 256, 512]
    expansion = 4 if block_kind == "bottleneck" else 1
    for stage_i, (width, rep) in enumerate(zip(widths, reps)):
        for block_i in range(rep):
            stride = 2 if (stage_i > 0 and block_i == 0) else 1
            name = f"s{stage_i}b{block_i}"
            cout = width * expansion
            if stride != 1 or c != cout:  # identity shortcut when shapes already match
                sc, _ = _conv_bn_relu(nodes, w, f"{name}_sc", x, cout, c, 1, stride, 0, relu=False)
            else:
                sc = x
            if block_kind == "bottleneck":
                h, _ = _conv_bn_relu(nodes, w, f"{name}_1", x, width, c, 1, 1, 0)
                h, _ = _conv_bn_relu(nodes, w, f"{name}_2", h, width, width, 3, stride, 1)
                h, _ = _conv_bn_relu(nodes, w, f"{name}_3", h, cout, width, 1, 1, 0, relu=False)
            else:
                h, _ = _conv_bn_relu(nodes, w, f"{name}_1", x, width, c, 3, stride, 1)
                h, _ = _conv_bn_relu(nodes, w, f"{name}_2", h, cout, width, 3, 1, 1, relu=False)
            nodes.append(node("Add", [h, sc], [f"{name}_add"]))
            nodes.append(node("Relu", [f"{name}_add"], [f"{name}_out"]))
            x, c = f"{name}_out", cout
    nodes.append(node("GlobalAveragePool", [x], ["gap"]))
    nodes.append(node("Flatten", ["gap"], ["features"], axis=1))
    fc = w.mat("fc_w", c, num_classes)
    fcb = w.vec("fc_b", num_classes, 0.0)
    nodes.append(node("Gemm", ["features", fc, fcb], ["logits"]))
    g = make_graph(
        nodes, f"resnet{depth}",
        [value_info("data", np.float32, ["N", 3, 224, 224])],
        [value_info("logits", np.float32, ["N", num_classes]),
         value_info("features", np.float32, ["N", c])],
        w.store,
    )
    return make_model(g, opset=17)


def _attention(nodes, w: _W, name, x, hidden, heads, seq_hint="S"):
    hd = hidden // heads
    scale = np.float32(1.0 / np.sqrt(hd))
    for proj in ("q", "k", "v"):
        wn = w.mat(f"{name}_{proj}w", hidden, hidden)
        bn_ = w.vec(f"{name}_{proj}b", hidden)
        nodes.append(node("MatMul", [x, wn], [f"{name}_{proj}0"]))
        nodes.append(node("Add", [f"{name}_{proj}0", bn_], [f"{name}_{proj}"]))
    # reshape (N,S,H) -> (N,S,heads,hd) -> (N,heads,S,hd)
    shp = f"{name}_split_shape"
    w.store[shp] = np.array([0, 0, heads, hd], dtype=np.int64)
    for proj in ("q", "k", "v"):
        nodes.append(node("Reshape", [f"{name}_{proj}", shp], [f"{name}_{proj}r"]))
        nodes.append(node("Transpose", [f"{name}_{proj}r"], [f"{name}_{proj}t"],
                          perm=[0, 2, 1, 3]))
    nodes.append(node("Transpose", [f"{name}_kt"], [f"{name}_ktt"], perm=[0, 1, 3, 2]))
    nodes.append(node("MatMul", [f"{name}_qt", f"{name}_ktt"], [f"{name}_scores0"]))
    sc = f"{name}_scale"
    w.store[sc] = np.asarray(scale)
    nodes.append(node("Mul", [f"{name}_scores0", sc], [f"{name}_scores"]))
    nodes.append(node("Softmax", [f"{name}_scores"], [f"{name}_probs"], axis=-1))
    nodes.append(node("MatMul", [f"{name}_probs", f"{name}_vt"], [f"{name}_ctx0"]))
    nodes.append(node("Transpose", [f"{name}_ctx0"], [f"{name}_ctx1"], perm=[0, 2, 1, 3]))
    merge = f"{name}_merge_shape"
    w.store[merge] = np.array([0, 0, hidden], dtype=np.int64)
    nodes.append(node("Reshape", [f"{name}_ctx1", merge], [f"{name}_ctx"]))
    ow = w.mat(f"{name}_ow", hidden, hidden)
    ob = w.vec(f"{name}_ob", hidden)
    nodes.append(node("MatMul", [f"{name}_ctx", ow], [f"{name}_o0"]))
    nodes.append(node("Add", [f"{name}_o0", ob], [f"{name}_attn"]))
    return f"{name}_attn"


def _layer_norm(nodes, w: _W, name, x, hidden):
    g = w.vec(f"{name}_g", hidden, 1.0)
    b = w.vec(f"{name}_b", hidden, 0.0)
    nodes.append(node("LayerNormalization", [x, g, b], [name], axis=-1, epsilon=1e-12))
    return name


def _encoder_layer(nodes, w: _W, name, x, hidden, heads, ffn):
    attn = _attention(nodes, w, f"{name}_att", x, hidden, heads)
    nodes.append(node("Add", [x, attn], [f"{name}_res1"]))
    h = _layer_norm(nodes, w, f"{name}_ln1", f"{name}_res1", hidden)
    w1 = w.mat(f"{name}_ffn1w", hidden, ffn)
    b1 = w.vec(f"{name}_ffn1b", ffn)
    w2 = w.mat(f"{name}_ffn2w", ffn, hidden)
    b2 = w.vec(f"{name}_ffn2b", hidden)
    nodes.append(node("MatMul", [h, w1], [f"{name}_f0"]))
    nodes.append(node("Add", [f"{name}_f0", b1], [f"{name}_f1"]))
    nodes.append(node("Gelu", [f"{name}_f1"], [f"{name}_f2"]))
    nodes.append(node("MatMul", [f"{name}_f2", w2], [f"{name}_f3"]))
    nodes.append(node("Add", [f"{name}_f3", b2], [f"{name}_f4"]))
    nodes.append(node("Add", [h, f"{name}_f4"], [f"{name}_res2"]))
    return _layer_norm(nodes, w, f"{name}_ln2", f"{name}_res2", hidden)


def bert_encoder(layers: int = 12, hidden: int = 768, heads: int = 12,
                 vocab: int = 30522, max_seq: int = 512, num_classes: int = 2,
                 seed: int = 0) -> ModelProto:
    """BERT-base-style encoder for sequence classification. Inputs: ``input_ids``
    (N,S) int64, ``attention_mask`` unused in this seeded variant (full attention).
    Outputs: ``logits`` (N,num_classes), ``pooled`` (N,hidden), ``sequence``
    (N,S,hidden). Opset-20 Gelu."""
    w = _W(seed)
    nodes: List = []
    emb = w.mat("tok_emb", vocab, hidden)
    pos = w.mat("pos_emb", max_seq, hidden)
    nodes.append(node("Gather", [emb, "input_ids"], ["tok"], axis=0))
    nodes.append(node("Shape", ["input_ids"], ["ids_shape"]))
    w.store["one_i"] = np.array([1], dtype=np.int64)
    w.store["two_i"] = np.array([2], dtype=np.int64)
    w.store["zero_i"] = np.array([0], dtype=np.int64)
    nodes.append(node("Slice", ["ids_shape", "one_i", "two_i", "zero_i"], ["seq_len"]))
    nodes.append(node("Slice", [pos, "zero_i", "seq_len", "zero_i"], ["pos_slice"]))
    nodes.append(node("Add", ["tok", "pos_slice"], ["emb_sum"]))
    x = _layer_norm(nodes, w, "emb_ln", "emb_sum", hidden)
    for i in range(layers):
        x = _encoder_layer(nodes, w, f"l{i}", x, hidden, heads, hidden * 4)
    # pooled = tanh(W * x[:,0])
    w.store["cls_idx"] = np.array(0, dtype=np.int64)
    nodes.append(node("Gather", [x, "cls_idx"], ["cls"], axis=1))
    pw = w.mat("pool_w", hidden, hidden)
    pb = w.vec("pool_b", hidden)
    nodes.append(node("MatMul", ["cls", pw], ["pool0"]))
    nodes.append(node("Add", ["pool0", pb], ["pool1"]))
    nodes.append(node("Tanh", ["pool1"], ["pooled"]))
    cw = w.mat("clf_w", hidden, num_classes)
    cb = w.vec("clf_b", num_classes, 0.0)
    nodes.append(node("MatMul", ["pooled", cw], ["logits0"]))
    nodes.append(node("Add", ["logits0", cb], ["logits"]))
    g = make_graph(
        nodes, f"bert_l{layers}_h{hidden}",
        [value_info("input_ids", np.int64, ["N", "S"])],
        [value_info("logits", np.float32, ["N", num_classes]),
         value_info("pooled", np.float32, ["N", hidden]),
         value_info("sequence", np.float32, ["N", "S", hidden])],
        w.store,
    )
    # expose final hidden states under the declared name
    g.node.append(node("Identity", [x], ["sequence"]))
    return make_model(g, opset=20)


def vit(patch: int = 16, image_size: int = 224, layers: int = 12, hidden: int = 768,
        heads: int = 12, num_classes: int = 1000, seed: int = 0) -> ModelProto:
    """ViT-B/16-style. Input ``data`` (N,3,H,W) float32; outputs ``logits``,
    ``features`` (CLS token after final LN)."""
    w = _W(seed)
    nodes: List = []
    n_patches = (image_size // patch) ** 2
    pe = w.conv("patch_w", hidden, 3, patch)
    nodes.append(node("Conv", ["data", pe], ["patches"], kernel_shape=[patch, patch],
                      strides=[patch, patch]))
    w.store["flat_shape"] = np.array([0, hidden, -1], dtype=np.int64)
    nodes.append(node("Reshape", ["patches", "flat_shape"], ["pflat"]))
    nodes.append(node("Transpose", ["pflat"], ["ptok"], perm=[0, 2, 1]))
    cls = w.vec("cls_tok", hidden)
    w.store["cls_tok"] = w.store["cls_tok"].reshape(1, 1, hidden)
    nodes.append(node("Shape", ["ptok"], ["pt_shape"]))
    w.store["zero_i"] = np.array([0], dtype=np.int64)
    w.store["one_i"] = np.array([1], dtype=np.int64)
    nodes.append(node("Slice", ["pt_shape", "zero_i", "one_i", "zero_i"], ["batch_dim"]))
    w.store["one_v"] = np.array([1], dtype=np.int64)
    w.store["hid_v"] = np.array([hidden], dtype=np.int64)
    nodes.append(node("Concat", ["batch_dim", "one_v", "hid_v"], ["cls_shape"], axis=0))
    nodes.append(node("Expand", ["cls_tok", "cls_shape"], ["cls_b"]))
    nodes.append(node("Concat", ["cls_b", "ptok"], ["tokens"], axis=1))
    pos = w.mat("pos_emb", n_patches + 1, hidden)
    nodes.append(node("Add", ["tokens", pos], ["emb"]))
    x = "emb"
    for i in range(layers):
        x = _encoder_layer(nodes, w, f"l{i}", x, hidden, heads, hidden * 4)
    w.store["cls_idx"] = np.array(0, dtype=np.int64)
    nodes.append(node("Gather", [x, "cls_idx"], ["features"], axis=1))
    cw = w.mat("clf_w", hidden, num_classes)
    cb = w.vec("clf_b", num_classes, 0.0)
    nodes.append(node("MatMul", ["features", cw], ["l0"]))
    nodes.append(node("Add", ["l0", cb], ["logits"]))
    g = make_graph(
        nodes, f"vit_b{patch}",
        [value_info("data", np.float32, ["N", 3, image_size, image_size])],
        [value_info("logits", np.float32, ["N", num_classes]),
         value_info("features", np.float32, ["N", hidden])],
        w.store,
    )
    return make_model(g, opset=20)


MODEL_BUILDERS = {
    "ResNet18": lambda **kw: resnet(18, **kw),
    "ResNet50": lambda **kw: resnet(50, **kw),
    "ResNet101": lambda **kw: resnet(101, **kw),
    "BERTBase": lambda **kw: bert_encoder(**kw),
    "BERTTiny": lambda **kw: bert_encoder(layers=2, hidden=128, heads=2, vocab=1000, **kw),
    "ViTB16": lambda **kw: vit(**kw),
}


def build_model_bytes(name: str, **kw) -> bytes:
    try:
        builder = MODEL_BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown zoo model {name!r}; available: {sorted(MODEL_BUILDERS)}") from None
    return serialize_model(builder(**kw))
