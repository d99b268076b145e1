"""Rows at the schemas of public tabular datasets, made from a seed.

The datasets' files are not in the repository, so ``chip_smoke.py`` drives
its three fits (:data:`FITS`, which ``tools/profile_fit.py`` profiles too)
on rows generated at their schemas:

- :func:`higgs_width_rows`: HIGGS's width (28 f32 features), standard normal,
  with the label ``x0 + 0.4*x5 + 0.2*N(0,1) > 0``;
- :func:`adult_rows`: UCI Adult Census (``BASELINE.json`` config #2), 14
  columns in the dataset's order, 6 numeric and 8 categorical with Adult's
  cardinalities, NaN where the files hold '?' (workclass, occupation,
  native-country); the label depends on a set of occupation codes and on
  education-num and capital-gain; :func:`adult_columns` gives them as a
  table's columns, the categorical ones as strings;
- :func:`covertype_rows`: UCI Covertype, the 10 numeric columns and the 44
  one-hot columns carried as the two categorical columns they encode
  (Wilderness_Area, 4 codes; Soil_Type, 40 codes), 7 classes whose
  frequencies follow the dataset's, the class set by elevation, soil and
  wilderness;
- :func:`mslr_rows`: MSLR-WEB30K (Qin & Liu 2013, "Introducing LETOR 4.0
  datasets", and the MSLR-WEB30K release), 136 numeric features, rows
  contiguous by query, relevance 0-4 (see its docstring);
- :func:`movielens_rows`: MovieLens-10M (Harper & Konstan 2015, "The
  MovieLens Datasets: History and Context"; the ``ml-10M100K`` release):
  69,878 users, 10,677 movies, 10,000,054 distinct (user, movie) ratings in
  half stars 0.5-5 at the release's shares, epoch-second times over
  1995-2009 (see its docstring);
- :func:`access_rows`: CyberML's access logs (SynapseML's
  ``cyber/anomaly/collaborative_filtering.py`` schema: tenant, user,
  resource, likelihood) for tenants of departments that share resources;
- :func:`embedding_rows`: dense embedding columns (pooled CNN features such
  as ResNet-50's 2,048, the input of SynapseML's KNN notebooks) with labels;
- :func:`hashed_text_rows`: Amazon Review Polarity (Zhang, Zhao & LeCun
  2015, "Character-level Convolutional Networks for Text Classification":
  3,600,000 training and 400,000 test reviews, a binary label) as the VW
  featurizer gives it to LightGBM: each review a bag of Zipf-distributed
  tokens hashed into ``2**num_bits`` slots, each slot's value its count.

Distributions are rough matches of the published summaries; the schemas
(column count, types, cardinalities, class count) are exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["ADULT_COLUMNS", "ADULT_CARDINALITY", "ADULT_CATEGORICAL", "ADULT_SETS",
           "ADULT_INCOME", "adult_rows", "adult_columns", "adult_unseen_codes", "COVTYPE_COLUMNS", "COVTYPE_CATEGORICAL",
           "COVTYPE_CLASSES", "covertype_rows", "HIGGS_WIDTH", "higgs_width_rows", "FITS",
           "SAMPLED_MODES", "MSLR_FEATURES", "MSLR_MAX_QUERY", "MSLR_TRAIN", "MSLR_VALID",
           "MSLR_SHARES", "mslr_rows", "HASHED_TEXT_BITS", "HASHED_TEXT_TOKENS",
           "hashed_text_rows", "MOVIELENS_10M", "MOVIELENS_STAR_SHARES", "movielens_rows",
           "access_rows", "embedding_rows"]

ADULT_COLUMNS = ["age", "workclass", "fnlwgt", "education", "education-num",
                 "marital-status", "occupation", "relationship", "race", "sex",
                 "capital-gain", "capital-loss", "hours-per-week", "native-country"]
ADULT_CARDINALITY = {"workclass": 9, "education": 16, "marital-status": 7,
                     "occupation": 15, "relationship": 6, "race": 5, "sex": 2,
                     "native-country": 42}
ADULT_CATEGORICAL = [ADULT_COLUMNS.index(c) for c in ADULT_CARDINALITY]
# occupation codes that raise the odds of the positive label
ADULT_SETS = (3, 4, 9, 11)
# the label's strings in the census files, negative first
ADULT_INCOME = ("<=50K", ">50K")

COVTYPE_COLUMNS = ["Elevation", "Aspect", "Slope", "Horizontal_Distance_To_Hydrology",
                   "Vertical_Distance_To_Hydrology", "Horizontal_Distance_To_Roadways",
                   "Hillshade_9am", "Hillshade_Noon", "Hillshade_3pm",
                   "Horizontal_Distance_To_Fire_Points", "Wilderness_Area", "Soil_Type"]
COVTYPE_CATEGORICAL = [10, 11]
COVTYPE_CLASSES = 7
HIGGS_WIDTH = 28

# chip_smoke.py's three fits: (training rows, rows made, the estimator's
# parameters); the rows past the training rows are held out. HIGGS has 11M
# rows, cut to the smoke's time limit; Adult's 32,561 are scaled up as
# HIGGS is; Covertype's 581,012 are split 80/20.
FITS = {
    "higgs": (4_194_304, 5_242_880, dict(num_iterations=10, num_leaves=31, max_bin=63)),
    "adult": (4_194_304, 5_242_880, dict(num_iterations=10, num_leaves=31, max_bin=255,
                                         categorical_slot_indexes=ADULT_CATEGORICAL)),
    "covertype": (464_810, 581_012, dict(num_iterations=10, num_leaves=31, max_bin=255,
                                         categorical_slot_indexes=COVTYPE_CATEGORICAL)),
    # MSLR-WEB30K Fold1 (training and validation documents), at LightGBM's
    # lambdarank example settings (examples/lambdarank/train.conf), 10 iterations
    "mslr": (2_270_296, 3_017_514, dict(
        num_iterations=10, num_leaves=31, max_bin=255, min_data_in_leaf=50,
        min_sum_hessian_in_leaf=5.0, learning_rate=0.1, lambdarank_truncation_level=30,
        ndcg_at=10)),
}

# chip_smoke.py's phase 2g: reviews hashed into VW's default 2^18 slots (the
# estimators' sparse_num_bits default), trained at 1,048,576 of Amazon Review
# Polarity's 3,600,000 and scored on 262,144 held out
HASHED_TEXT_BITS = 18
HASHED_TEXT_TOKENS = 80          # mean tokens a review
HASHED_TEXT_LEXICON = 50         # words of each side of the sentiment lexicon
FITS["hashed_text"] = (1_048_576, 1_310_720, dict(num_iterations=10, num_leaves=31))

# chip_smoke.py's phase 2d: the HIGGS fit's parameters under each training
# control, as the estimator takes them. "bagged_eval" also passes the
# held-out rows as validation rows, watched by AUC with early stopping.
# DART's defaults (skip_drop=0.5, drop_rate=0.1) drop few trees in 10
# iterations, so it drops more here.
SAMPLED_MODES = {
    "bagged_eval": dict(bagging_fraction=0.5, bagging_freq=1, feature_fraction=0.8,
                        metric="auc", early_stopping_round=3),
    "goss": dict(boosting_type="goss"),
    "dart": dict(boosting_type="dart", skip_drop=0.0, drop_rate=0.3),
    "rf": dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
}


def _rngs(seed: int):
    """(structure, rows) generators: the schema's fixed parts (code
    frequencies, maps, effects) come from the first, so they do not depend
    on the row count."""
    return np.random.default_rng([seed, 0]), np.random.default_rng([seed, 1])


def _zipf_codes(structure, rng, n: int, k: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** s
    return structure.permutation(k)[rng.choice(k, size=n, p=p / p.sum())].astype(np.float32)


def higgs_width_rows(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 28) f32 features and the label x0 + 0.4*x5 + 0.2*N(0,1) > 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, HIGGS_WIDTH), dtype=np.float32)
    noise = rng.standard_normal(n, dtype=np.float32)
    y = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * noise > 0).astype(np.float64)
    return x, y


def adult_rows(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, 14) f32 rows, (n,) 0/1 labels and (n,) f64 true probabilities."""
    structure, rng = _rngs(seed)
    x = np.empty((n, 14), np.float32)
    for name, k in ADULT_CARDINALITY.items():
        x[:, ADULT_COLUMNS.index(name)] = _zipf_codes(
            structure, rng, n, k, 2.0 if name == "native-country" else 1.1)
    edu = x[:, ADULT_COLUMNS.index("education")].astype(np.int64)
    x[:, 0] = np.clip(np.round(rng.normal(38.6, 13.6, n)), 17, 90)
    x[:, 2] = np.round(rng.lognormal(12.0, 0.5, n))
    x[:, 4] = structure.permutation(16)[edu] + 1            # a function of education
    gain = np.where(rng.random(n) < 0.917, 0.0, np.round(rng.lognormal(8.5, 1.0, n)))
    x[:, 10] = np.minimum(gain, 99999)
    x[:, 11] = np.where(rng.random(n) < 0.953, 0.0, np.round(rng.normal(1870, 370, n)))
    x[:, 12] = np.clip(np.round(rng.normal(40.4, 12.3, n)), 1, 99)
    for name in ("workclass", "occupation", "native-country"):
        j = ADULT_COLUMNS.index(name)
        x[rng.random(n) < 0.02, j] = np.nan
    occ = x[:, ADULT_COLUMNS.index("occupation")]
    logit = (-2.2 + 1.3 * np.isin(occ, ADULT_SETS) + 0.35 * (x[:, 4] - 10)
             + 2.0 * (x[:, 10] > 5000))
    prob = 1.0 / (1.0 + np.exp(-logit))
    y = (rng.random(n) < prob).astype(np.float64)
    return x, y, prob


def adult_columns(x: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
    """:func:`adult_rows`' rows as a table's columns, the way SynapseML's
    Adult Census notebook reads the CSV: the 6 numeric columns as f64, the
    8 categorical ones as strings (``"<column>_<code>"``, None where the
    files hold '?') and the label as the census's ``income`` strings."""
    cols: Dict[str, np.ndarray] = {}
    for j, name in enumerate(ADULT_COLUMNS):
        if name not in ADULT_CARDINALITY:
            cols[name] = x[:, j].astype(np.float64)
            continue
        k = ADULT_CARDINALITY[name]
        levels = np.array([f"{name}_{c}" for c in range(k)] + [None], dtype=object)
        code = x[:, j]
        cols[name] = levels[np.where(np.isnan(code), k, code).astype(np.int64)]
    cols["income"] = np.array(ADULT_INCOME, dtype=object)[y.astype(np.int64)]
    return cols


def adult_unseen_codes(x: np.ndarray, seed: int, share: float) -> np.ndarray:
    """A copy of Adult rows where ``share`` of them carry occupation and
    native-country codes past the cardinality (categories no fit saw)."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    for name in ("occupation", "native-country"):
        rows = rng.random(len(x)) < share
        x[rows, ADULT_COLUMNS.index(name)] = (ADULT_CARDINALITY[name]
                                              + rng.integers(0, 3, int(rows.sum())))
    return x


def covertype_rows(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, 12) f32 rows, (n,) class labels 0..6 and (n, 7) true logits."""
    structure, rng = _rngs(seed)
    soil = structure.normal(0.0, 0.8, (40, COVTYPE_CLASSES))
    wild = structure.normal(0.0, 0.6, (4, COVTYPE_CLASSES))
    x = np.empty((n, 12), np.float32)
    x[:, 0] = np.clip(np.round(rng.normal(2959, 280, n)), 1859, 3858)
    x[:, 1] = rng.integers(0, 361, n)
    x[:, 2] = np.clip(np.round(rng.gamma(3.0, 4.7, n)), 0, 66)
    x[:, 3] = np.minimum(np.round(rng.exponential(270, n)), 1397)
    x[:, 4] = np.round(rng.normal(46, 58, n))
    x[:, 5] = np.minimum(np.round(rng.exponential(2350, n)), 7117)
    x[:, 6] = np.clip(np.round(rng.normal(212, 27, n)), 0, 254)
    x[:, 7] = np.clip(np.round(rng.normal(223, 20, n)), 0, 254)
    x[:, 8] = np.clip(np.round(rng.normal(142, 38, n)), 0, 254)
    x[:, 9] = np.minimum(np.round(rng.exponential(1980, n)), 7173)
    x[:, 10] = rng.choice(4, size=n, p=[0.45, 0.05, 0.44, 0.06])
    x[:, 11] = _zipf_codes(structure, rng, n, 40, 1.0)
    # class elevation centres and log frequencies near the dataset's
    centre = np.array([3130, 2920, 2390, 2220, 2790, 2420, 3360], np.float64)
    freq = np.array([0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035])
    logits = (np.log(freq)[None] - ((x[:, :1] - centre[None]) / 160.0) ** 2
              + soil[x[:, 11].astype(np.int64)] + wild[x[:, 10].astype(np.int64)]
              - 0.002 * x[:, 3:4] * (np.arange(COVTYPE_CLASSES) % 2)[None])
    y = np.argmax(logits + rng.gumbel(size=logits.shape), axis=1).astype(np.float64)
    return x, y, logits


MSLR_FEATURES = 136
MSLR_MAX_QUERY = 1_251
# (queries, documents) of MSLR-WEB30K Fold1's training and validation files
MSLR_TRAIN = (18_919, 2_270_296)
MSLR_VALID = (6_306, 747_218)
# relevance 0..4: about half 0, a third 1, an eighth 2, a few percent 3 and 4
# (the released labels' shares, rounded)
MSLR_SHARES = (0.515, 0.325, 0.134, 0.018, 0.008)


def _mslr_sizes(rng, n_queries: int, n_docs: int) -> np.ndarray:
    """Query sizes in [1, MSLR_MAX_QUERY] summing to ``n_docs``: lognormal
    (median ~ 0.73 of the mean, a long tail clipped at the largest query),
    1 % of them 1-10 documents, then moved one document at a time to the
    exact total."""
    mean = n_docs / n_queries
    sizes = np.clip(np.round(rng.lognormal(np.log(mean) - 0.32, 0.8, n_queries)),
                    1, MSLR_MAX_QUERY).astype(np.int64)
    tiny = rng.random(n_queries) < 0.01          # a few queries of 1-10 documents
    sizes[tiny] = rng.integers(1, 11, int(tiny.sum()))
    while sizes.sum() != n_docs:
        diff = n_docs - int(sizes.sum())
        pick = rng.integers(0, n_queries, min(abs(diff), n_queries))
        sizes[pick] = np.clip(sizes[pick] + np.sign(diff), 1, MSLR_MAX_QUERY)
    return sizes


def mslr_rows(seed: int, n_queries: int, n_docs: int = None,
              part: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, 136) f32 features, (n,) relevance labels 0..4 (f64) and (Q,) query
    sizes, rows contiguous by query, at MSLR-WEB30K's schema.

    ``n_docs`` defaults to about 120 a query, MSLR's mean; sizes run from 1
    to 1,251 with MSLR's mean. ``part`` picks a stream of rows (0 training,
    1 validation) over one structure (feature scales, the label's weights),
    so a model fit on part 0 ranks part 1. Columns: 60 integer count
    features (term-frequency-like: ``floor(Exp * mean)``, means 0.3-20, many
    zeros and heavy ties), 60 continuous scores (BM25/LMIR-like), 16 ratios
    on eighths (quality and coverage). The label is a latent score over six
    of them plus noise and a per-query effect, quantised within each query
    at :data:`MSLR_SHARES`: a query's top documents by latent score take the
    highest grades (queries of 1-2 documents take 0-1, so some queries have
    one label only)."""
    structure, _ = _rngs(seed)
    rng = np.random.default_rng([seed, 2 + part])
    n_docs = int(round(n_queries * 120.0)) if n_docs is None else int(n_docs)
    sizes = _mslr_sizes(rng, n_queries, n_docs)
    means = structure.uniform(np.log(0.3), np.log(20.0), 60)
    scales = structure.uniform(0.5, 3.0, 60).astype(np.float32)
    x = np.empty((n_docs, MSLR_FEATURES), np.float32)
    counts = rng.standard_exponential((n_docs, 60), dtype=np.float32)
    x[:, :60] = np.floor(counts * np.exp(means).astype(np.float32))
    del counts
    x[:, 60:120] = rng.standard_normal((n_docs, 60), dtype=np.float32) * scales
    x[:, 120:] = rng.integers(0, 9, (n_docs, 16)).astype(np.float32) / 8
    qid = np.repeat(np.arange(n_queries), sizes)
    effect = rng.normal(0.0, 0.5, n_queries)[qid]
    latent = (0.9 * x[:, 60] / scales[0] + 0.6 * np.log1p(x[:, 3]) + 0.5 * x[:, 120]
              + 0.4 * x[:, 75] / scales[15] - 0.3 * np.log1p(x[:, 17]) + 0.3 * x[:, 130]
              + effect + rng.normal(0.0, 1.0, n_docs))
    order = np.lexsort((-latent, qid))            # per query, highest latent first
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    top = (np.arange(n_docs) - starts + 0.5) / np.repeat(sizes, sizes)  # (rank + 0.5) / m
    cum = np.cumsum(MSLR_SHARES[::-1])[:-1]        # shares of grades 4, 3, 2, 1 from the top
    y = np.empty(n_docs, np.float64)
    y[order] = 4 - np.searchsorted(cum, top, side="right")
    return x, y, sizes


def _fmix32(x: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finalizer, elementwise on uint32."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def hashed_text_rows(seed: int, n: int, num_bits: int = HASHED_TEXT_BITS):
    """(CSRMatrix (n, 2**num_bits), (n,) f64 labels) of hashed reviews at
    Amazon Review Polarity's schema.

    A review has Poisson(80) tokens (at least 4), each a word of a Zipf(1.1)
    vocabulary (numpy's unbounded ``zipf``: word 1 is about a tenth of all
    tokens, present in nearly every review, while most words are rare) or,
    one token in 16, a word of a sentiment lexicon: 50 positive and 50
    negative words among ranks 50-2,000, drawn from the review's latent
    polarity's side four times in five. The label is 1 where the review's
    lexicon count (positive minus negative) plus N(0, 1.5^2) noise is above
    0. A word's slot is MurmurHash3's finalizer of its id, masked to
    ``num_bits`` bits (VW's learner-side mask); a slot's value is its count
    in the review (the VW featurizer's counts), colliding words summed. The
    rows come in CSR order with ascending columns."""
    structure, rng = _rngs(seed)
    lex = structure.choice(np.arange(50, 2001), size=2 * HASHED_TEXT_LEXICON, replace=False)
    pos_words, neg_words = lex[:HASHED_TEXT_LEXICON], lex[HASHED_TEXT_LEXICON:]
    lens = np.maximum(rng.poisson(HASHED_TEXT_TOKENS, n), 4)
    total = int(lens.sum())
    review = np.repeat(np.arange(n, dtype=np.int64), lens)
    polarity = rng.random(n) < 0.5
    words = rng.zipf(1.1, total).astype(np.int64)
    senti = rng.random(total) < 1 / 16
    k = int(senti.sum())
    own_side = rng.random(k) < 0.8
    positive = polarity[review[senti]] == own_side
    pick = rng.integers(0, HASHED_TEXT_LEXICON, k)
    words[senti] = np.where(positive, pos_words[pick], neg_words[pick])
    score = np.bincount(review[senti], weights=np.where(positive, 1.0, -1.0), minlength=n)
    y = (score + rng.normal(0.0, 1.5, n) > 0).astype(np.float64)
    del senti, own_side, positive, pick
    mask = np.uint32((1 << num_bits) - 1)
    slot = (_fmix32((words & 0xFFFFFFFF).astype(np.uint32) ^ np.uint32(seed * 0x9E3779B9 & 0xFFFFFFFF))
            & mask).astype(np.int64)
    del words
    key, counts = np.unique(review << num_bits | slot, return_counts=True)
    del review, slot
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key >> num_bits, minlength=n), out=indptr[1:])
    from ..gbdt.sparse import CSRMatrix

    return (CSRMatrix(indptr, (key & int(mask)).astype(np.int32), counts.astype(np.float64),
                      (n, 1 << num_bits)), y)


# MovieLens-10M (ml-10M100K): users, movies, ratings; every user has at
# least 20 ratings; times run from 1995 to early 2009
MOVIELENS_10M = (69_878, 10_677, 10_000_054)
MOVIELENS_MIN_RATINGS = 20
MOVIELENS_TIMES = (788_918_400.0, 1_231_131_736.0)   # 1995-01-01 .. 2009-01-05 UTC
# shares of the half-star grades 0.5, 1.0, ..., 5.0 in the release (rounded)
MOVIELENS_STAR_SHARES = (0.009, 0.038, 0.012, 0.079, 0.037, 0.236, 0.088, 0.288, 0.058,
                         0.155)


def movielens_rows(seed: int, n_users: int = MOVIELENS_10M[0],
                   n_items: int = MOVIELENS_10M[1], n_ratings: int = MOVIELENS_10M[2]):
    """(users int64, items int64, ratings f64, times f64), ``n_ratings``
    distinct (user, item) pairs at MovieLens-10M's shape, in no order.

    Each user has at least 20 ratings (the release's floor), the rest spread
    by lognormal(0, 1.2) activity; a rating's movie is drawn by Zipf-
    Mandelbrot popularity ``1 / (rank + 50)`` over a fixed permutation of
    the ids, and a pair drawn twice is drawn again (after three rounds
    uniformly; after eight the few users left take items they lack), so
    every pair is distinct and the most-rated movie has about 24,000
    ratings (the release's has 34,864). Ratings are half stars at
    :data:`MOVIELENS_STAR_SHARES`, times uniform epoch seconds over
    1995-2009."""
    structure, rng = _rngs(seed)
    floor = min(MOVIELENS_MIN_RATINGS, n_ratings // max(1, n_users))
    weight = rng.lognormal(0.0, 1.2, n_users)
    per_user = floor + rng.multinomial(n_ratings - floor * n_users, weight / weight.sum())
    per_user = np.minimum(per_user, n_items)
    while per_user.sum() < n_ratings:          # users capped at every item
        room = np.flatnonzero(per_user < n_items)
        per_user[room[:n_ratings - int(per_user.sum())]] += 1
    p = 1.0 / (np.arange(n_items) + 50.0)
    ids = structure.permutation(n_items)
    users = np.repeat(np.arange(n_users, dtype=np.int64), per_user)
    cdf = np.cumsum(p / p.sum())
    draw = lambda m, zipf: ids[np.minimum(np.searchsorted(cdf, rng.random(m)), n_items - 1)
                               if zipf else rng.integers(0, n_items, m)]
    items = draw(len(users), True).astype(np.int64)
    rows = np.arange(len(users))          # rows of the users still to check
    for round_ in range(8):
        key = users[rows] * n_items + items[rows]
        _, first = np.unique(key, return_index=True)
        dup = np.ones(len(rows), bool)
        dup[first] = False
        if not dup.any():
            break
        items[rows[dup]] = draw(int(dup.sum()), round_ < 3)
        rows = rows[np.isin(users[rows], users[rows[dup]])]
    else:
        # the few users left (near every item) take their missing items
        for u in np.unique(users[rows]).tolist():
            mine = rows[users[rows] == u]
            seen, first = np.unique(items[mine], return_index=True)
            again = np.setdiff1d(np.arange(len(mine)), first)
            items[mine[again]] = rng.permutation(np.setdiff1d(ids, seen))[:len(again)]
    stars = (rng.choice(10, size=len(users), p=np.asarray(MOVIELENS_STAR_SHARES) /
                        sum(MOVIELENS_STAR_SHARES)) + 1) * 0.5
    times = np.floor(rng.uniform(*MOVIELENS_TIMES, size=len(users)))
    return users, items, stars.astype(np.float64), times


def access_rows(seed: int, tenants, departments: int = 20, closed: int = 2,
                cross: float = 0.05):
    """CyberML access rows: ``{"tenant", "user", "res"}`` strings and
    ``"likelihood"`` f64, for ``tenants`` = [(name, users, resources,
    rows), ...]. A tenant's users and resources fall into ``departments``
    equal groups; a user touches its own department's resources, and a
    ``cross`` share of its rows any resource of the tenant, except in the
    first ``closed`` departments, which touch only their own (so each is a
    connected component of its own). Users are drawn with Zipf(1) activity
    over a permutation, resources uniformly within the group; the
    likelihood is an access count, 1 + Poisson(3). Pairs may repeat (the
    fit sums them)."""
    structure, rng = _rngs(seed)
    cols = {"tenant": [], "user": [], "res": [], "likelihood": []}
    for name, n_users, n_res, n_rows in tenants:
        g = min(departments, n_users, n_res)
        p = 1.0 / np.arange(1, n_users + 1)
        user = structure.permutation(n_users)[rng.choice(n_users, size=n_rows, p=p / p.sum())]
        dept = user % g
        res_in = dept + g * rng.integers(0, max(1, n_res // g), n_rows)
        anywhere = (rng.random(n_rows) < cross) & (dept >= closed)
        res = np.where(anywhere, rng.integers(0, n_res, n_rows), np.minimum(res_in, n_res - 1))
        res = np.where((res % g < closed) & (res % g != dept), res_in, res)
        cols["tenant"].append(np.full(n_rows, name, dtype=object))
        cols["user"].append(np.char.add("u", user.astype(str)).astype(object))
        cols["res"].append(np.char.add("r", res.astype(str)).astype(object))
        cols["likelihood"].append(1.0 + rng.poisson(3.0, n_rows))
    return {k: np.concatenate(v) for k, v in cols.items()}


def embedding_rows(seed: int, n: int, d: int, n_labels: int = 0, clusters: int = 64,
                   nonnegative: bool = False):
    """((n, d) f32 embeddings, (n,) int64 labels or None): points around
    ``clusters`` Gaussian centres (spread 0.5 about unit-variance centres),
    rectified when ``nonnegative`` (pooled ReLU features such as
    ResNet-50's), each labelled with its cluster modulo ``n_labels``. The
    centres depend on ``seed`` and ``d`` only, so keys and queries cut from
    one call share them."""
    structure, rng = _rngs(seed)
    centres = structure.standard_normal((clusters, d), dtype=np.float32)
    which = rng.integers(0, clusters, n)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= np.float32(0.5)
    x += centres[which]
    if nonnegative:
        np.maximum(x, 0.0, out=x)
    return x, (which % n_labels).astype(np.int64) if n_labels else None
