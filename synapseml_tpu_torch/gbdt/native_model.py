"""LightGBM native text-model interop (a copy of
``synapseml_tpu/gbdt/native_model.py`` over the port's ``BinMapper`` and
``GBDTBooster``).

Reference: ``saveNativeModel``/``setModelString``
(``lightgbm/.../LightGBMBooster.scala:454``, ``LightGBMModelMethods.scala``) —
the reference round-trips boosters through LightGBM's text model format. Here
the format is implemented directly, which buys two-way interop:

- :func:`booster_to_native` exports a trained :class:`GBDTBooster` as
  LightGBM text a stock LightGBM install can load and predict with;
- :func:`booster_from_native` imports a real LightGBM text model into a
  :class:`GBDTBooster`, so existing LightGBM models get this framework's
  device-resident prediction/serving path.

Structure mapping: this engine's trees are replay lists (split ``s`` turns
leaf-slot ``parent[s]`` into slots ``(parent[s], s+1)``); LightGBM's are
pointer trees (``left_child``/``right_child``, negative = ~leaf). The two are
interconvertible for any binary tree by replaying splits parent-first. Split
semantics match exactly: numerical ``value <= threshold`` goes left, NaN
follows the right branch (``missing_type=NaN``, ``default_left=False``).
Import builds a synthetic :class:`BinMapper` whose per-feature edges are the
model's own thresholds — ``value <= t`` ⇔ ``bin(value) <= bin(t)`` holds
exactly, so the binned replay path (device predict included) reproduces the
pointer-tree decisions bit-for-bit.

Categorical splits round-trip too: export writes LightGBM's bitset
encoding — ``decision_type`` bit 0 set, the split's ``threshold`` is an
index into ``cat_boundaries``/``cat_threshold`` uint32 words whose bits are
the LEFT-going category values — and import decodes it back into this
engine's per-split ``cat_set`` membership rows.

``default_left``: a numeric split that routes missing LEFT is encoded
as a per-split SET over the feature's bin ids — ``{bins <= threshold} ∪
{missing bin}`` — reusing the categorical ``cat_set`` machinery (``bin ==
-1`` + membership row), with the float threshold kept so export writes the
split back as ``threshold`` + the ``default_left`` decision bit. Every
predict path (host, device, TreeSHAP) already dispatches per-split on
``bin < 0``, so real-world LightGBM models trained on data with missing
values load and predict bit-for-bit.

``zero_as_missing`` models (missing_type=Zero) import exactly too:
features carrying such splits get a dedicated ZERO-BAND bin — synthetic
edges at ``(nextafter(-1e-35), +1e-35]`` reproduce LightGBM's
``|v| <= kZeroThreshold`` test in bin space — and the band (plus NaN,
which the native predictor converts to 0.0 first) routes by the split's
``default_left`` bit via the same set encoding. One caveat: RE-exporting a
zero_as_missing import writes the NaN-missing ``default_left`` form, so
the re-exported text predicts zeros by threshold under stock LightGBM;
this engine's own predictions stay exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .binning import BinMapper

__all__ = ["booster_to_native", "booster_from_native"]

# LightGBM decision_type bit field: bit0 categorical, bit1 default_left,
# bits 2-3 missing_type (0 none, 1 zero, 2 NaN)
_DT_CATEGORICAL = 1
_DT_DEFAULT_LEFT = 2
_DT_MISSING_ZERO = 1 << 2
_DT_MISSING_NAN = 2 << 2
_DT_MISSING_MASK = 3 << 2


def _fmt(v: float) -> str:
    return repr(float(v))


# ---------------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------------

def _replay_to_pointer(parent, feature, threshold, gain, leaf_value,
                       leaf_hess, bins=None, cat_set=None, cat_values=None):
    """One replay-list tree -> LightGBM pointer arrays (leaves re-indexed
    densely in slot order).

    ``bins``/``cat_set``/``cat_values``: when the tree has categorical
    splits (``bins[s] == -1``), each becomes a bitset threshold — the
    split's ``threshold`` is its index into ``cat_boundaries`` and the
    uint32 ``cat_threshold`` words carry the LEFT-going category VALUES
    (``cat_set`` is over bin ids; ``cat_values[feature]`` maps them back to
    raw categories, which must be non-negative integers as LightGBM
    requires)."""
    steps = [s for s in range(parent.shape[0]) if parent[s] >= 0]
    if not steps:  # stump: single leaf
        return dict(num_leaves=1, split_feature=[], split_gain=[],
                    threshold=[], decision_type=[], left_child=[],
                    right_child=[], leaf_value=[float(leaf_value[0])],
                    leaf_weight=[float(leaf_hess[0])],
                    num_cat=0, cat_boundaries=[0], cat_threshold=[])
    # internal node ids = positions in `steps`; slots -> current tree attach
    # point: (internal id, 'l'|'r') whose child pointer tracks the slot
    internal_of_step = {s: i for i, s in enumerate(steps)}
    left = [0] * len(steps)
    right = [0] * len(steps)
    link: Dict[int, tuple] = {}  # slot -> (internal id, side)
    for i, s in enumerate(steps):
        p = int(parent[s])
        if p in link:
            j, side = link[p]
            if side == "l":
                left[j] = i
            else:
                right[j] = i
        link[p] = (i, "l")
        link[s + 1] = (i, "r")
    # remaining links are leaves; dense leaf ids in slot order
    slots = sorted(link)
    leaf_id = {slot: n for n, slot in enumerate(slots)}
    for slot, (j, side) in link.items():
        enc = ~leaf_id[slot]  # LightGBM: negative child = ~leaf index
        if side == "l":
            left[j] = enc
        else:
            right[j] = enc
    thresholds: List[float] = []
    decision_types: List[int] = []
    cat_boundaries = [0]
    cat_threshold: List[int] = []
    for s in steps:
        if bins is not None and int(bins[s]) < 0 and \
                np.isfinite(threshold[s]):
            # numeric set-split (an imported missing-direction split):
            # write back as threshold + the direction bit read from the
            # set's MISSING-bin membership (the last bin), so default-right
            # zero_as_missing imports don't flip their NaN routing
            thresholds.append(float(threshold[s]))
            left_bit = _DT_DEFAULT_LEFT if cat_set[s][-1] else 0
            decision_types.append(_DT_MISSING_NAN | left_bit)
            continue
        if bins is not None and int(bins[s]) < 0:  # categorical split
            f = int(feature[s])
            vals = cat_values.get(f)
            if vals is None:
                raise ValueError(f"split on feature {f} is categorical but "
                                 "the mapper has no category values for it")
            vals = np.asarray(vals)
            if not np.array_equal(vals, np.round(vals)) or vals.min() < 0:
                raise ValueError(
                    f"categorical feature {f} has non-integer or negative "
                    "category values; LightGBM bitsets need codes >= 0 "
                    "(use to_json for arbitrary categories)")
            if cat_set[s][-1]:
                # only the MISSING bin (last) is observable at predict time
                # among the beyond-code bins — the grower's rank-prefix can
                # park it on the left side, which LightGBM bitsets cannot
                # express: NaN/unseen will route right in the exported model
                # (LightGBM's own not-in-bitset behavior). Zero-mass bins in
                # (len(vals), missing) are unreachable and need no warning.
                import warnings

                warnings.warn(
                    f"categorical split on feature {f}: missing/unseen "
                    "values routed left in training but LightGBM bitsets "
                    "route them right; exported model differs on such rows",
                    stacklevel=3)
            left_vals = vals[np.flatnonzero(
                cat_set[s][: len(vals)])].astype(np.int64)
            n_words = (int(vals.max()) // 32) + 1 if len(vals) else 1
            words = [0] * n_words
            for v in left_vals:
                words[v // 32] |= 1 << (v % 32)
            thresholds.append(float(len(cat_boundaries) - 1))
            decision_types.append(_DT_CATEGORICAL | _DT_MISSING_NAN)
            cat_threshold.extend(words)
            cat_boundaries.append(len(cat_threshold))
        else:
            thresholds.append(float(threshold[s]))
            decision_types.append(_DT_MISSING_NAN)
    return dict(
        num_leaves=len(slots),
        split_feature=[int(feature[s]) for s in steps],
        split_gain=[float(gain[s]) for s in steps],
        threshold=thresholds,
        decision_type=decision_types,
        left_child=left, right_child=right,
        leaf_value=[float(leaf_value[slot]) for slot in slots],
        leaf_weight=[float(leaf_hess[slot]) for slot in slots],
        num_cat=len(cat_boundaries) - 1,
        cat_boundaries=cat_boundaries, cat_threshold=cat_threshold,
    )


def booster_to_native(booster) -> str:
    """Serialize a :class:`GBDTBooster` as a LightGBM text model."""
    T, C = booster.parent.shape[:2]
    d = booster.mapper.n_features or (int(booster.feature.max()) + 1
                                      if booster.feature.size else 1)
    names = booster.feature_names or [f"Column_{j}" for j in range(d)]
    obj = {"binary": "binary sigmoid:1",
           "multiclass": "multiclass num_class:%d" % booster.num_class,
           "softmax": "multiclass num_class:%d" % booster.num_class,
           "regression": "regression",
           }.get(booster.objective, booster.objective)
    rf = booster.boosting == "rf"
    lines = [
        "tree",
        "version=v3",
        f"num_class={booster.num_class}",
        f"num_tree_per_iteration={booster.num_class}",
        "label_index=0",
        f"max_feature_idx={d - 1}",
        f"objective={obj}",
        "feature_names=" + " ".join(names),
        "feature_infos=" + " ".join(["[-inf:inf]"] * d),
    ]
    if rf:
        lines.append("average_output")
    lines.append("")

    for t in range(booster.num_trees):
        for c in range(C):
            tree = _replay_to_pointer(
                booster.parent[t, c], booster.feature[t, c],
                booster.threshold[t, c], booster.gain[t, c],
                booster.leaf_value[t, c], booster.leaf_hess[t, c],
                bins=(booster.bin[t, c]
                      if booster.cat_set is not None else None),
                cat_set=(booster.cat_set[t, c]
                         if booster.cat_set is not None else None),
                cat_values=booster.mapper.cat_values)
            # fold shrinkage/dart scale into leaf values; fold base_score in
            # (first tree per class normally; EVERY tree under rf averaging)
            sc = float(booster.tree_scale[t])
            add = float(booster.base_score[c]) if (t == 0 or rf) else 0.0
            vals = [v * sc + add for v in tree["leaf_value"]]
            lines += [
                f"Tree={t * C + c}",
                f"num_leaves={tree['num_leaves']}",
                f"num_cat={tree['num_cat']}",
                "split_feature=" + " ".join(map(str, tree["split_feature"])),
                "split_gain=" + " ".join(map(_fmt, tree["split_gain"])),
                "threshold=" + " ".join(map(_fmt, tree["threshold"])),
                "decision_type=" + " ".join(map(str, tree["decision_type"])),
                "left_child=" + " ".join(map(str, tree["left_child"])),
                "right_child=" + " ".join(map(str, tree["right_child"])),
                "leaf_value=" + " ".join(map(_fmt, vals)),
                "leaf_weight=" + " ".join(map(_fmt, tree["leaf_weight"])),
            ]
            if tree["num_cat"]:
                lines += [
                    "cat_boundaries=" + " ".join(
                        map(str, tree["cat_boundaries"])),
                    "cat_threshold=" + " ".join(
                        map(str, tree["cat_threshold"])),
                ]
            lines += ["shrinkage=1", ""]
    lines += ["end of trees", ""]
    return "\n".join(lines)


# ---------------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------------

def _parse_kv(block: List[str]) -> Dict[str, str]:
    out = {}
    for line in block:
        if "=" in line:
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
        elif line.strip():
            out[line.strip()] = ""
    return out


def _pointer_to_replay(num_leaves, split_feature, threshold, split_gain,
                       left_child, right_child, leaf_value, leaf_weight,
                       max_leaves):
    """Pointer tree -> replay arrays sized to ``max_leaves`` slots.

    Also returns ``node_of_step`` (the pointer-tree internal node each
    replay step came from) so callers can look up per-node side tables —
    the categorical bitset decode needs it."""
    L1 = max_leaves - 1
    parent = np.full(L1, -1, np.int32)
    feat = np.zeros(L1, np.int32)
    thr = np.zeros(L1, np.float64)
    gain = np.zeros(L1, np.float32)
    lv = np.zeros(max_leaves, np.float32)
    lh = np.zeros(max_leaves, np.float32)
    node_of_step = np.full(L1, -1, np.int32)
    if num_leaves == 1:
        lv[0] = leaf_value[0]
        lh[0] = leaf_weight[0] if leaf_weight is not None else 0.0
        return parent, feat, thr, gain, lv, lh, node_of_step
    # replay order: walk internal nodes parent-first (BFS from root node 0);
    # slot bookkeeping inverts the export mapping
    slot_of_node = {0: 0}  # internal node -> slot it currently splits
    order: List[int] = []
    queue = [0]
    while queue:
        nd = queue.pop(0)
        order.append(nd)
        s = len(order) - 1  # replay step index
        p_slot = slot_of_node[nd]
        parent[s] = p_slot
        feat[s] = split_feature[nd]
        thr[s] = threshold[nd]
        gain[s] = split_gain[nd] if split_gain is not None else 0.0
        node_of_step[s] = nd
        for child, child_slot in ((left_child[nd], p_slot),
                                  (right_child[nd], s + 1)):
            if child >= 0:
                slot_of_node[child] = child_slot
                queue.append(child)
            else:
                leaf = ~child if child < 0 else child
                lv[child_slot] = leaf_value[leaf]
                if leaf_weight is not None:
                    lh[child_slot] = leaf_weight[leaf]
    return parent, feat, thr, gain, lv, lh, node_of_step


def booster_from_native(model_str: str):
    """Parse a LightGBM text model into a :class:`GBDTBooster`."""
    from .boost import GBDTBooster

    text = model_str.replace("\r\n", "\n")
    if not text.lstrip().startswith("tree"):
        raise ValueError("not a LightGBM text model (missing 'tree' header)")
    body = text.split("end of trees")[0]
    chunks = body.split("Tree=")
    header = _parse_kv(chunks[0].splitlines())
    num_class = int(header.get("num_class", 1))
    per_iter = int(header.get("num_tree_per_iteration", num_class))
    d = int(header["max_feature_idx"]) + 1
    obj_field = header.get("objective", "regression").split()
    objective = {"binary": "binary", "multiclass": "multiclass",
                 "multiclassova": "multiclass",
                 "regression_l1": "l1"}.get(obj_field[0], obj_field[0])
    average_output = "average_output" in header
    feature_names = (header.get("feature_names") or "").split() or None

    trees = []
    for chunk in chunks[1:]:
        kv = _parse_kv(chunk.splitlines())
        nl = int(kv["num_leaves"])
        ints = lambda key: [int(x) for x in kv.get(key, "").split()]
        flts = lambda key: ([float(x) for x in kv.get(key, "").split()]
                            or None)
        dts = ints("decision_type")
        trees.append(dict(
            num_leaves=nl, split_feature=ints("split_feature"),
            threshold=flts("threshold") or [],
            split_gain=flts("split_gain"),
            left_child=ints("left_child"), right_child=ints("right_child"),
            leaf_value=flts("leaf_value") or [0.0],
            leaf_weight=flts("leaf_weight"),
            decision_type=dts,
            cat_boundaries=ints("cat_boundaries") or [0],
            cat_threshold=ints("cat_threshold")))
    if not trees:
        raise ValueError("model has no trees")
    if len(trees) % per_iter:
        raise ValueError(f"{len(trees)} trees not divisible by "
                         f"num_tree_per_iteration={per_iter}")

    def _is_cat_split(tr, node: int) -> bool:
        dts = tr["decision_type"]
        return bool(dts and node < len(dts) and dts[node] & _DT_CATEGORICAL)

    def _bitset_values(tr, cat_idx: int) -> List[int]:
        lo = tr["cat_boundaries"][cat_idx]
        hi = tr["cat_boundaries"][cat_idx + 1]
        vals = []
        for wi, w in enumerate(tr["cat_threshold"][lo:hi]):
            b = 0
            while w:
                if w & 1:
                    vals.append(wi * 32 + b)
                w >>= 1
                b += 1
        return vals

    # synthetic BinMapper: per-feature edges = the model's own thresholds,
    # so 'value <= t' == 'bin(value) <= bin(t)' exactly; categorical
    # features get their category codes from the union of the model's own
    # bitsets (unseen values -> missing bin -> right branch, the LightGBM
    # not-in-bitset behavior)
    thr_by_feat: List[set] = [set() for _ in range(d)]
    cat_vals_by_feat: Dict[int, set] = {}
    zero_feats: set = set()  # features with any missing_type=Zero split
    for tr in trees:
        for node, (f, t) in enumerate(zip(tr["split_feature"],
                                          tr["threshold"])):
            if _is_cat_split(tr, node):
                cat_vals_by_feat.setdefault(f, set()).update(
                    _bitset_values(tr, int(t)))
            else:
                thr_by_feat[f].add(float(t))
                dts = tr["decision_type"]
                if node < len(dts) and \
                        (dts[node] & _DT_MISSING_MASK) == _DT_MISSING_ZERO:
                    zero_feats.add(f)
    # zero_as_missing features get a dedicated ZERO-BAND bin: edges at
    # (nextafter(-kZeroThreshold, -inf), +kZeroThreshold] reproduce
    # LightGBM's |v| <= 1e-35 zero test exactly in bin space, so the
    # band can be routed per split like the missing bin
    _KZERO = 1e-35
    for f in zero_feats:
        thr_by_feat[f].add(float(np.nextafter(-_KZERO, -np.inf)))
        thr_by_feat[f].add(_KZERO)
    max_cat = max((len(v) for v in cat_vals_by_feat.values()), default=0)
    mapper = BinMapper(
        max_bin=max(2, max((len(s) + 1) for s in thr_by_feat), max_cat),
        categorical_features=sorted(cat_vals_by_feat))
    mapper.upper_edges = [
        (np.array([np.inf]) if j in cat_vals_by_feat else
         np.concatenate([np.sort(np.array(sorted(s), np.float64)), [np.inf]]))
        for j, s in enumerate(thr_by_feat)]
    mapper.cat_values = {
        f: np.array(sorted(v), np.float64)
        for f, v in cat_vals_by_feat.items()}
    mapper.n_features = d

    T = len(trees) // per_iter
    C = per_iter
    max_leaves = max(tr["num_leaves"] for tr in trees)
    max_leaves = max(max_leaves, 2)
    shape1 = (T, C, max_leaves - 1)
    parent = np.full(shape1, -1, np.int32)
    feature = np.zeros(shape1, np.int32)
    threshold = np.zeros(shape1, np.float64)
    bin_ = np.zeros(shape1, np.int32)
    gain = np.zeros(shape1, np.float32)
    leaf_value = np.zeros((T, C, max_leaves), np.float32)
    leaf_hess = np.zeros((T, C, max_leaves), np.float32)
    B = mapper.n_bins

    def _needs_set_split(dt: int, thr: float) -> bool:
        """True when the split routes some bin against its threshold order
        and therefore needs the bin-set encoding."""
        if dt & _DT_CATEGORICAL:
            return False  # LightGBM cat splits route NaN/unseen right
        mt = dt & _DT_MISSING_MASK
        if mt == _DT_MISSING_ZERO:
            return True  # the zero band routes by default_left, not by t
        if mt == _DT_MISSING_NAN:
            return bool(dt & _DT_DEFAULT_LEFT)
        # missing_type=None: NaN converts to 0.0 before the compare
        return 0.0 <= thr

    any_set_split = any(
        _needs_set_split(dt, thr)
        for tr in trees
        for dt, thr in zip(tr["decision_type"], tr["threshold"]))
    cat_set = (np.zeros(shape1 + (B,), np.int8)
               if cat_vals_by_feat or any_set_split else None)
    for idx, tr in enumerate(trees):
        t, c = divmod(idx, C)
        (parent[t, c], feature[t, c], threshold[t, c], gain[t, c],
         leaf_value[t, c], leaf_hess[t, c], node_of_step) = \
            _pointer_to_replay(
                tr["num_leaves"], tr["split_feature"], tr["threshold"],
                tr["split_gain"], tr["left_child"], tr["right_child"],
                tr["leaf_value"], tr["leaf_weight"], max_leaves)
        for s in range(max_leaves - 1):
            nd = int(node_of_step[s])
            if nd < 0:
                continue
            f = int(feature[t, c, s])
            dt = (tr["decision_type"][nd]
                  if nd < len(tr["decision_type"]) else _DT_MISSING_NAN)
            if _is_cat_split(tr, nd):
                # LightGBM categorical splits route NaN/unseen RIGHT
                # regardless of default_left (not-in-bitset rule)
                vals = mapper.cat_values[f]
                left = _bitset_values(tr, int(tr["threshold"][nd]))
                codes = np.searchsorted(vals, np.asarray(left, np.float64))
                cat_set[t, c, s, codes] = 1
                bin_[t, c, s] = -1
                threshold[t, c, s] = np.nan
                continue
            # bin = position of the threshold in the feature's edges
            b = int(np.searchsorted(mapper.upper_edges[f],
                                    threshold[t, c, s]))
            if not _needs_set_split(dt, threshold[t, c, s]):
                bin_[t, c, s] = b
                continue
            # set encoding over the feature's bins; threshold kept for
            # re-export (NaN-missing default_left form; a re-exported
            # zero_as_missing model keeps OUR predictions exact, but its
            # zeros route by threshold under stock LightGBM)
            cat_set[t, c, s, : b + 1] = 1
            if (dt & _DT_MISSING_MASK) == _DT_MISSING_ZERO:
                # EVERY bin inside [-kZero, +kZero] (and NaN, which the
                # native predictor converts to 0.0) routes by default_left
                # regardless of the threshold order. A model threshold can
                # fall inside the band (LightGBM emits -kZero as a bin
                # upper bound under zero_as_missing), fragmenting it into
                # several bins — mark the whole [first, last] band range.
                go_left = bool(dt & _DT_DEFAULT_LEFT)
                edges = mapper.upper_edges[f]
                zb_lo = int(np.searchsorted(edges, -_KZERO))
                zb_hi = int(np.searchsorted(edges, _KZERO))
                cat_set[t, c, s, zb_lo: zb_hi + 1] = 1 if go_left else 0
                cat_set[t, c, s, mapper.missing_bin] = 1 if go_left else 0
            else:
                # NaN-missing (default_left) or None (NaN -> 0.0 <= t)
                cat_set[t, c, s, mapper.missing_bin] = 1
            bin_[t, c, s] = -1
    return GBDTBooster(
        mapper=mapper, objective=objective, num_class=num_class,
        base_score=np.zeros(num_class),
        parent=parent, feature=feature, threshold=threshold, bin_=bin_,
        gain=gain, leaf_value=leaf_value, leaf_hess=leaf_hess,
        tree_scale=np.ones(T, np.float64),
        boosting="rf" if average_output else "gbdt",
        feature_names=feature_names,
        cat_set=cat_set,
    )
