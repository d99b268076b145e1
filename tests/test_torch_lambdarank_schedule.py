"""Kernel F's schedule (``csrc/lambdarank.cu``), modelled on the CPU in numpy
f32, one rounded operation at a time, against the plain version at 0 ulps.

The kernel cannot run here, so this is the test that its design keeps the
plain version's bits: ranks from a sort of (score descending, index) keys
with -0.0 tied to +0.0 and NaN last; with T = min(truncation, m) <= TOP_MAX,
each counted pair evaluated once, from its top side, into a T x T table of
the top documents (rank order) and (T x J) tables of chunks of J columns,
the documents below T in index order; each of those summing its column
over the top documents in index order, each top document walking the
columns and, merged between them, the T x T table's entries of the other
top documents, in j order; with T > TOP_MAX, the two-sided second loop.
The chunk width J is the kernel's CHUNK_COLS and a range of others.
"""

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.gbdt import lambdarank as lr
from synapseml_tpu_torch.gbdt.lambdarank import (CHUNK_COLS, SMEM_DOCS, TOP_MAX, QueryGroups,
                                                 cell_count, lambda_grads_plain)
from synapseml_tpu_torch.tools.kernel_cases import RANK_CASES, rank_case, rank_nan_case

F = np.float32
SOURCE = Path(lr.__file__).resolve().parent.parent / "csrc" / "lambdarank.cu"


def exp_f32(x):
    """The kernel's exp_f32 in numpy f32."""
    with np.errstate(invalid="ignore"):
        xc = np.clip(x, F(-20.0), F(88.0))
        k = np.rint(xc * F(lr._LOG2E))
        r = (xc - k * F(lr._LN2_HI)) - k * F(lr._LN2_LO)
        p = np.full_like(r, F(lr._EXP_COEF[0]))
        for c in lr._EXP_COEF[1:]:
            p = p * r + F(c)
        scale = ((k.astype(np.int32) + 127) << 23).view(np.float32)
    return np.where(x > F(88.0), F(np.inf), p * scale)


def pair_terms(s_win, s_lose, gain_a, gain_b, disc_a, disc_b, md, sig, sig2):
    """(lam, hp) of pairs, rho from the winner's side, as pair_terms."""
    rho = F(1.0) / (F(1.0) + exp_f32(sig * (s_win - s_lose)))
    delta = (np.abs(gain_a - gain_b) * np.abs(disc_a - disc_b)) / md
    return (sig * rho) * delta, ((sig2 * rho) * (F(1.0) - rho)) * delta


def sort_ranks(s):
    """(order, rank) from sort_key: the score as a descending ordered
    integer (-0.0 as +0.0, NaN after -inf), then the index."""
    u = s.view(np.uint32).copy()
    u[s == 0] = 0
    d = np.where(u & 0x80000000, u, ~(u | 0x80000000)).astype(np.uint32)
    d[np.isnan(s)] = 0xFFFFFFFF
    order = np.lexsort((np.arange(len(s)), d))
    rank = np.empty(len(s), np.int64)
    rank[order] = np.arange(len(s))
    return order, rank


def model_query(s, lab, gain, disc, md, truncation, sig, sig2, cols, tally=None):
    """(ga, gb, ha, hb) of one query in the kernel's order. ``tally`` (m, m),
    if given, counts each pair term evaluated, at [winner, loser]."""
    m = len(s)
    T = min(max(truncation, 0), m)
    order, rank = sort_ranks(s)
    d = disc[rank]
    zeros = lambda k: np.zeros(k, F)
    ga, gb, ha, hb = zeros(m), zeros(m), zeros(m), zeros(m)

    def add(acc, mask, val):
        return np.where(mask, acc + val, acc)

    if T > TOP_MAX:  # the second loop: each i walks every j, both sides
        top = rank < truncation
        for j in range(m):
            win, lose = lab > lab[j], lab[j] > lab
            cnt = (win | lose) & (top | top[j])
            lam, hp = pair_terms(np.where(win, s, s[j]), np.where(win, s[j], s), gain,
                                 gain[j], d, d[j], md, sig, sig2)
            if tally is not None:
                tally[np.flatnonzero(cnt & win), j] += 1
                tally[j, np.flatnonzero(cnt & lose)] += 1
            ga, ha = add(ga, cnt & win, lam), add(ha, cnt & win, hp)
            gb, hb = add(gb, cnt & lose, lam), add(hb, cnt & lose, hp)
        return ga, gb, ha, hb
    top_doc = order[:T]                       # by rank
    by_index = np.argsort(top_doc)            # the top ranks in index order
    ts, tl, tg, td = s[top_doc], lab[top_doc], gain[top_doc], disc[:T]
    lam_t, hp_t = np.full((T, T), np.nan, F), np.full((T, T), np.nan, F)
    x, y = np.triu_indices(T, 1)
    xw = tl[x] > tl[y]
    cnt = xw | (tl[y] > tl[x])
    x, y, xw = x[cnt], y[cnt], xw[cnt]
    lam, hp = pair_terms(np.where(xw, ts[x], ts[y]), np.where(xw, ts[y], ts[x]), tg[x], tg[y],
                         td[x], td[y], md, sig, sig2)
    if tally is not None:
        np.add.at(tally, (np.where(xw, top_doc[x], top_doc[y]),
                          np.where(xw, top_doc[y], top_doc[x])), 1)
    lam_t[x, y], lam_t[y, x], hp_t[x, y], hp_t[y, x] = lam, lam, hp, hp
    wa, wb, wha, whb = zeros(T), zeros(T), zeros(T), zeros(T)
    top_index = top_doc[by_index]             # the top documents in index order
    nxt = 0

    def walk_top(acc):  # the walkers' terms of the next top document
        rr = by_index[nxt]
        win, lose = tl > tl[rr], tl[rr] > tl
        wa, wb, wha, whb = acc
        return (add(wa, win, lam_t[:, rr]), add(wb, lose, lam_t[:, rr]),
                add(wha, win, hp_t[:, rr]), add(whb, lose, hp_t[:, rr]))

    below_docs = np.flatnonzero(rank >= T)    # the columns, in index order
    for k0 in range(0, len(below_docs), cols):
        js = below_docs[k0:k0 + cols]
        lam_c, hp_c = np.full((T, len(js)), np.nan, F), np.full((T, len(js)), np.nan, F)
        r, c = np.nonzero(np.ones((T, len(js)), bool))
        j = js[c]
        tw = tl[r] > lab[j]
        cnt = tw | (lab[j] > tl[r])
        r, c, j, tw = r[cnt], c[cnt], j[cnt], tw[cnt]
        lam, hp = pair_terms(np.where(tw, ts[r], s[j]), np.where(tw, s[j], ts[r]), tg[r],
                             gain[j], td[r], d[j], md, sig, sig2)
        if tally is not None:
            np.add.at(tally, (np.where(tw, top_doc[r], j), np.where(tw, j, top_doc[r])), 1)
        lam_c[r, c], hp_c[r, c] = lam, hp
        # each column: its sums over the top documents in index order
        lj = lab[js]
        ca, cb, cha, chb = (zeros(len(js)) for _ in range(4))
        for k in range(T):
            rr = by_index[k]
            win, lose = lj > tl[rr], tl[rr] > lj
            ca, cha = add(ca, win, lam_c[rr]), add(cha, win, hp_c[rr])
            cb, chb = add(cb, lose, lam_c[rr]), add(chb, lose, hp_c[rr])
        ga[js], gb[js], ha[js], hb[js] = ca, cb, cha, chb
        # each top document walks the columns, and the top documents between
        # them, in j order
        for c in range(len(js)):
            while nxt < T and top_index[nxt] < js[c]:
                wa, wb, wha, whb = walk_top((wa, wb, wha, whb))
                nxt += 1
            win, lose = tl > lab[js[c]], lab[js[c]] > tl
            wa, wha = add(wa, win, lam_c[:, c]), add(wha, win, hp_c[:, c])
            wb, whb = add(wb, lose, lam_c[:, c]), add(whb, lose, hp_c[:, c])
    while nxt < T:
        wa, wb, wha, whb = walk_top((wa, wb, wha, whb))
        nxt += 1
    ga[top_doc], gb[top_doc], ha[top_doc], hb[top_doc] = wa, wb, wha, whb
    return ga, gb, ha, hb


def model(score, label, weight, sizes, truncation, sigma, cols=CHUNK_COLS, tally=None):
    """(g * w, max(h, 1e-12) * w) of every row, query by query."""
    groups = QueryGroups(sizes, label, truncation)
    gain, disc, max_dcg = groups.gain.numpy(), groups.disc.numpy(), groups.max_dcg.numpy()
    sig, sig2 = F(sigma), F(sigma * sigma)
    g, h = np.zeros(len(score), F), np.zeros(len(score), F)
    with np.errstate(invalid="ignore", over="ignore"):
        for q, (a, b) in enumerate(zip(groups.offsets_np[:-1], groups.offsets_np[1:])):
            if b == a:
                continue
            t = None if tally is None else tally.setdefault(q, np.zeros((b - a, b - a), int))
            ga, gb, ha, hb = model_query(score[a:b], label[a:b], gain[a:b], disc, max_dcg[q],
                                         truncation, sig, sig2, cols, t)
            g[a:b] = -ga + gb
            h[a:b] = np.maximum(ha + hb, F(1e-12))
    return g * weight, h * weight


def cut(case, score, y, w, sizes):
    """``large_query`` cut to its first eleven queries (the 20,000-document
    query is the eleventh)."""
    if case != "large_query":
        return score, y, w, sizes
    sizes = sizes[:11]
    n = int(sizes.sum())
    return score[:n], y[:n], w[:n], sizes


@lru_cache(maxsize=None)
def case_and_plain(case):
    score, y, w, sizes, truncation, sigma = rank_case(case)
    score, y, w, sizes = cut(case, score, y, w, sizes)
    g, h = lambda_grads_plain(*(torch.from_numpy(a) for a in (score, y, w)),
                              QueryGroups(sizes, y, truncation), sigma)
    return (score, y, w, sizes, truncation, sigma), (g.numpy(), h.numpy())


def assert_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("case", RANK_CASES)
def test_schedule_bit_equal_to_plain(case):
    args, want = case_and_plain(case)
    assert_bits(model(*args), want)


@pytest.mark.parametrize("cols", [1, 2, 7, 31, 64, 200])
@pytest.mark.parametrize("case", ["ties", "truncation_below_size", "truncation_past_largest"])
def test_schedule_chunk_widths(case, cols):
    args, want = case_and_plain(case)
    assert_bits(model(*args, cols=cols), want)


def test_second_loop_and_main_loop_both_run():
    """"truncation_past_largest" holds queries on both sides of TOP_MAX; the
    smem_boundary and large_query cases queries on both sides of SMEM_DOCS."""
    for case, limit in (("truncation_past_largest", TOP_MAX), ("smem_boundary", SMEM_DOCS),
                        ("large_query", SMEM_DOCS)):
        _, _, _, sizes, truncation, _ = rank_case(case)
        t = np.minimum(truncation, sizes)
        side = t if limit == TOP_MAX else sizes
        assert (side > limit).any() and (side <= limit).any(), case
    assert {2048, 2049} <= set(rank_case("smem_boundary")[3].tolist())


@pytest.mark.parametrize("case", ["ties", "truncation_1", "truncation_below_size",
                                  "truncation_past_largest", "all_tied"])
def test_each_counted_pair_evaluated_once_from_its_top_side(case):
    """Main-loop queries evaluate every counted pair exactly once and visit
    no pair of two documents ranked >= T; second-loop queries evaluate it
    from both sides."""
    score, y, w, sizes, truncation, sigma = rank_case(case)
    tally = {}
    model(score, y, w, sizes, truncation, sigma, tally=tally)
    for q, (a, b) in enumerate(zip(np.cumsum(sizes) - sizes, np.cumsum(sizes))):
        m, lab = b - a, y[a:b]
        rank = sort_ranks(score[a:b])[1]
        counted = (lab[:, None] > lab[None, :]) & ((rank[:, None] < truncation)
                                                   | (rank[None, :] < truncation))
        want = counted * (2 if min(truncation, m) > TOP_MAX else 1)
        np.testing.assert_array_equal(tally[q], want)


def test_nan_scores_rank_last_as_argsort_of_the_query():
    """NaN after every other score, in index order: the plain version's
    order where each query is its own chunk (``cap=1``). Every row agrees
    bit for bit or is NaN in both."""
    score, y, w, sizes, truncation = rank_nan_case()
    groups = QueryGroups(sizes, y, truncation)
    want = lambda_grads_plain(*(torch.from_numpy(a) for a in (score, y, w)), groups, cap=1)
    got = model(score, y, w, sizes, truncation, 1.0)
    for a, b in zip(got, want):
        b = b.numpy()
        assert np.isnan(a).any() and (np.isnan(a) == np.isnan(b)).all()
        ok = ~np.isnan(b)
        np.testing.assert_array_equal(a[ok].view(np.int32), b[ok].view(np.int32))
    for q, (a, b) in enumerate(zip(np.cumsum(sizes) - sizes, np.cumsum(sizes))):
        s = torch.from_numpy(score[a:b])
        np.testing.assert_array_equal(sort_ranks(score[a:b])[0],
                                      torch.argsort(-s, stable=True).numpy())


def test_signed_zero_ranks_tie():
    s = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, np.inf, -np.inf, np.nan, 0.0], F)
    order, _ = sort_ranks(s)
    np.testing.assert_array_equal(order, [6, 2, 0, 1, 3, 4, 9, 5, 7, 8])
    np.testing.assert_array_equal(order, torch.argsort(-torch.from_numpy(s), stable=True))


def test_constants_match_the_source():
    text = SOURCE.read_text()
    for name, value in (("kSmemDocs", SMEM_DOCS), ("kTopMax", TOP_MAX), ("kCols", CHUNK_COLS)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found and int(found.group(1)) == value, name


def test_phase_tool_anchors_are_in_the_source():
    """tools/lambdarank_phases.py edits the kernel's source at anchored lines."""
    from synapseml_tpu_torch.tools.lambdarank_phases import VARIANTS, variant_source

    text = SOURCE.read_text()
    for name in VARIANTS:
        assert variant_source(name, text) != text or name == "full"


def test_cell_count():
    sizes = np.array([0, 1, 5, 30, 31, 40, 2049])
    for truncation in (0, 1, 30, 35, 100):
        want = 0
        for m in sizes:
            t = min(truncation, m)
            want += m * m if t > TOP_MAX else sum(1 for i in range(m) for j in range(i + 1, m)
                                                  if i < t)
        assert cell_count(sizes, truncation) == (want, int((sizes ** 2).sum()))
