"""The port's SAR and ranking stack against the JAX package's, on the CPU.

- SAR's two fitted matrices are bit-equal to the reference's: the affinity
  is summed with the reference's arithmetic (f64 weights rounded to f32,
  added in row order), the co-occurrence counts are exact integers in f32,
  and jaccard / lift / the support threshold are the same f32 operations.
- Recommendations (``recommend_for_all_users``, ``recommend_for_user_subset``,
  ``recommend_for_all_items``) are the reference's, in its order: exactly
  where the scores are exact (0/1 and integer affinities), and by
  ``kernel_cases.same_up_to_ties`` within ``SCORE_TOL`` where the scores are
  f32 sums of decayed weights, which the two matrix products add in other
  orders. Scores agree within ``SCORE_TOL`` relative to the row's largest.
- Every fixture of ``tests/test_recommendation.py`` runs through both
  packages; the ranking stack's metrics agree within ``METRIC_TOL``.
"""

import numpy as np
import pytest

from synapseml_tpu import Table as RefTable
from synapseml_tpu import recommendation as ref_rec
from synapseml_tpu_torch import recommendation as port_rec
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.recommendation import SAR, SARModel
from synapseml_tpu_torch.recommendation import sar as port_sar
from synapseml_tpu_torch.tools.kernel_cases import same_up_to_ties
from synapseml_tpu_torch.tools.schema_data import movielens_rows
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCORE_TOL = 1e-5
METRIC_TOL = 1e-9
SIMILARITY = ("jaccard", "lift", "cooccurrence")


def _both(cols):
    return RefTable(dict(cols)), Table(dict(cols))


def _fit(cols, **params):
    rt, pt = _both(cols)
    return ref_rec.SAR(**params).fit(rt), SAR(device="cpu", **params).fit(pt)


def _tiny():
    return {"user": np.array([0, 0, 1, 1, 1, 2, 2, 2], np.int64),
            "item": np.array([0, 1, 0, 1, 2, 1, 2, 3], np.int64)}


def _logs(seed=0, n_users=60, n_items=40, n=900, time=True, rating=True):
    users, items, stars, times = movielens_rows(seed, n_users, n_items, n)
    cols = {"user": users, "item": items}
    if rating:
        cols["rating"] = stars
    if time:
        cols["time"] = times
    return cols


def _recs(table, col="recommendations"):
    """(indices, scores) of a recommendations column, padded with -1 / nan."""
    rows = list(table[col])
    width = max((len(r) for r in rows), default=0)
    idx = np.full((len(rows), width), -1, np.int64)
    val = np.full((len(rows), width), np.nan)
    for r, recs in enumerate(rows):
        for j, (i, s) in enumerate(recs):
            idx[r, j], val[r, j] = i, s
    return idx, val


def _same_recs(ref_t, port_t, key_col, exact):
    np.testing.assert_array_equal(np.asarray(port_t[key_col]), np.asarray(ref_t[key_col]))
    ri, rv = _recs(ref_t)
    pi, pv = _recs(port_t)
    assert [len(r) for r in port_t["recommendations"]] == \
        [len(r) for r in ref_t["recommendations"]]
    if exact:
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pv, rv)
    else:
        ok = np.isfinite(rv)
        assert same_up_to_ties(np.where(ok, pi, -1), np.where(ok, pv, 0.0),
                               np.where(ok, ri, -1), np.where(ok, rv, 0.0), SCORE_TOL)


# -- the fitted matrices ------------------------------------------------------------------

@pytest.mark.parametrize("fn", SIMILARITY)
@pytest.mark.parametrize("data", ["tiny", "logs", "logs_rating_only", "logs_time_only",
                                  "logs_counts"])
def test_matrices_bit_equal(fn, data):
    cols = (_tiny() if data == "tiny" else
            _logs(1, time=data != "logs_rating_only", rating=data != "logs_time_only")
            if data != "logs_counts" else _logs(2, time=False, rating=False))
    for threshold in (0, 1, 4):
        ref, port = _fit(cols, similarity_function=fn, support_threshold=threshold)
        for name in ("user_affinity", "item_similarity"):
            a, b = np.asarray(ref.get(name)), np.asarray(port.get(name))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))


def test_cooccurrence_counts_equal_a_host_count():
    cols = _logs(3)
    u, i = cols["user"], cols["item"]
    nu, ni = int(u.max()) + 1, int(i.max()) + 1
    import torch

    c = port_sar.cooccurrence(u, i, nu, ni, torch.device("cpu")).numpy()
    occ = np.zeros((nu, ni), np.int64)
    occ[u, i] = 1
    np.testing.assert_array_equal(c, (occ.T @ occ).astype(np.float32))


# -- recommendations -------------------------------------------------------------------------

@pytest.mark.parametrize("fn", SIMILARITY)
@pytest.mark.parametrize("remove_seen", [False, True])
def test_recommend_for_all_users_exact_scores(fn, remove_seen):
    """Counts as affinities (no time, no rating): every score is an exact
    f32 value in both, so ties (common here) are held in the reference's
    order."""
    ref, port = _fit(_logs(4, time=False, rating=False), similarity_function=fn,
                     support_threshold=1)
    for k in (1, 5, 40, 100):
        _same_recs(ref.recommend_for_all_users(k, remove_seen=remove_seen),
                   port.recommend_for_all_users(k, remove_seen=remove_seen), "user",
                   exact=fn == "cooccurrence")


@pytest.mark.parametrize("remove_seen", [False, True])
def test_recommend_decayed_scores_up_to_ties(remove_seen):
    ref, port = _fit(_logs(5), support_threshold=2)
    _same_recs(ref.recommend_for_all_users(10, remove_seen=remove_seen),
               port.recommend_for_all_users(10, remove_seen=remove_seen), "user", exact=False)
    users = {"user": np.array([3, 3, 0, 59, 200, -1, 17], np.int64)}
    _same_recs(ref.recommend_for_user_subset(RefTable(dict(users)), 7, remove_seen=remove_seen),
               port.recommend_for_user_subset(Table(dict(users)), 7, remove_seen=remove_seen),
               "user", exact=False)


def test_recommend_for_all_items():
    ref, port = _fit(_logs(6, time=False, rating=False), similarity_function="cooccurrence",
                     support_threshold=1)
    _same_recs(ref.recommend_for_all_items(6), port.recommend_for_all_items(6), "item",
               exact=True)
    ref, port = _fit(_logs(6))
    _same_recs(ref.recommend_for_all_items(6), port.recommend_for_all_items(6), "item",
               exact=False)


def test_score_chunks_do_not_change_the_answer(monkeypatch):
    ref, port = _fit(_logs(7, time=False, rating=False), similarity_function="cooccurrence",
                     support_threshold=1)
    whole = port.recommend_for_all_users(5, remove_seen=True)
    from synapseml_tpu_torch.nn import knn as port_knn

    monkeypatch.setattr(port_knn, "SCORE_BUDGET", 7 * 40 * 4)
    chunked = port.recommend_for_all_users(5, remove_seen=True)
    _same_recs(whole, chunked, "user", exact=True)
    _same_recs(ref.recommend_for_all_users(5, remove_seen=True), chunked, "user", exact=True)


def test_transform_from_carried_state():
    """The reference's fitted model carried across (``from_state``) scores
    (user, item) rows as the reference does, cold-start rows dropped."""
    ref, _ = _fit(_logs(8))
    port = SARModel.from_state({k: ref.get_or_default(k) for k in SARModel._STATE}, device="cpu")
    rng = np.random.default_rng(8)
    q = {"user": rng.integers(-2, 70, 300), "item": rng.integers(-2, 45, 300)}
    a = ref.transform(RefTable(dict(q)))
    b = port.transform(Table(dict(q)))
    np.testing.assert_array_equal(np.asarray(b["user"]), np.asarray(a["user"]))
    np.testing.assert_array_equal(np.asarray(b["item"]), np.asarray(a["item"]))
    pa, pb = np.asarray(a["prediction"]), np.asarray(b["prediction"])
    assert pb.dtype == np.float64
    np.testing.assert_allclose(pb, pa, rtol=SCORE_TOL, atol=SCORE_TOL * np.abs(pa).max())
    back = ref_rec.SARModel(**port.state_dict())
    np.testing.assert_array_equal(np.asarray(back.transform(RefTable(dict(q)))["prediction"]),
                                  pa)


def test_new_matrices_after_a_transform():
    """Matrices set after a transform are the ones scored: the uploaded
    matrices are rebuilt when a param holds another array."""
    ref_a, port = _fit(_logs(10))
    ref_b, _ = _fit(_logs(11))
    q = {"user": np.arange(40) % 30, "item": np.arange(40) % 25}
    port.transform(Table(dict(q)))
    port.set_params(user_affinity=np.asarray(ref_b.user_affinity).copy(),
             item_similarity=np.asarray(ref_b.item_similarity).copy())
    a = np.asarray(ref_b.transform(RefTable(dict(q)))["prediction"])
    b = np.asarray(port.transform(Table(dict(q)))["prediction"])
    np.testing.assert_allclose(b, a, rtol=SCORE_TOL, atol=SCORE_TOL * np.abs(a).max())
    _same_recs(ref_b.recommend_for_all_users(5), port.recommend_for_all_users(5), "user",
               exact=False)


def test_default_device_needs_a_card(monkeypatch):
    import torch

    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        SAR().fit(Table(_tiny()))


# -- the reference's fixtures (tests/test_recommendation.py), through both ------------------

def test_fixture_cooccurrence_and_jaccard():
    for fn in SIMILARITY:
        ref, port = _fit(_tiny(), support_threshold=1, similarity_function=fn)
        np.testing.assert_array_equal(np.asarray(port.item_similarity),
                                      np.asarray(ref.item_similarity))
    sim = np.asarray(_fit(_tiny(), support_threshold=1,
                          similarity_function="cooccurrence")[1].item_similarity)
    assert sim[0, 1] == 2 and sim[0, 2] == 1 and sim[0, 3] == 0 and sim[2, 3] == 1


def test_fixture_support_threshold_zeroes_rare_pairs():
    ref, port = _fit(_tiny(), support_threshold=2, similarity_function="cooccurrence")
    np.testing.assert_array_equal(np.asarray(port.item_similarity),
                                  np.asarray(ref.item_similarity))
    assert np.asarray(port.item_similarity)[0, 2] == 0


def test_fixture_time_decay_affinity():
    day_s = 24 * 3600.0
    cols = {"user": np.array([0, 0], np.int64), "item": np.array([0, 0], np.int64),
            "time": np.array([30 * day_s, 0.0])}
    ref, port = _fit(cols, support_threshold=1, time_decay_coeff=30)
    np.testing.assert_array_equal(np.asarray(port.user_affinity), np.asarray(ref.user_affinity))
    assert np.asarray(port.user_affinity)[0, 0] == np.float32(1.5)


def test_fixture_rating_blend_and_string_times():
    cols = {"user": np.array([0], np.int64), "item": np.array([0], np.int64),
            "rating": np.array([4.0]), "time": np.array(["2024/01/02T00:00:00"], dtype=object)}
    ref, port = _fit(cols, support_threshold=1)
    np.testing.assert_array_equal(np.asarray(port.user_affinity), np.asarray(ref.user_affinity))


def test_fixture_start_time_java_default_format():
    cols = {"user": np.array([0], np.int64), "item": np.array([0], np.int64),
            "time": np.array(["2024/01/01T00:00:00"], dtype=object)}
    ref, port = _fit(cols, support_threshold=1, start_time="Mon Jan 01 00:00:00 +0000 2024")
    np.testing.assert_array_equal(np.asarray(port.user_affinity), np.asarray(ref.user_affinity))


def test_fixture_transform_scores_and_cold_start_drop():
    ref, port = _fit(_tiny(), support_threshold=1)
    q = {"user": np.array([0, 0, 99], np.int64), "item": np.array([2, 3, 0], np.int64)}
    a, b = ref.transform(RefTable(dict(q))), port.transform(Table(dict(q)))
    assert b.num_rows == a.num_rows == 2
    np.testing.assert_allclose(np.asarray(b["prediction"]), np.asarray(a["prediction"]),
                               rtol=SCORE_TOL)


def test_fixture_recommend_top_k_and_remove_seen():
    ref, port = _fit(_tiny(), support_threshold=1)
    for k, seen in ((2, False), (4, True)):
        _same_recs(ref.recommend_for_all_users(k, remove_seen=seen),
                   port.recommend_for_all_users(k, remove_seen=seen), "user", exact=False)


def test_fixture_model_save_load(tmp_path):
    ref, port = _fit(_tiny(), support_threshold=1)
    path = str(tmp_path / "sar")
    port.save(path)
    loaded = load_stage(path)
    assert isinstance(loaded, SARModel) and loaded.device == "cpu"
    np.testing.assert_array_equal(np.asarray(loaded.item_similarity),
                                  np.asarray(ref.item_similarity))
    _same_recs(ref.recommend_for_all_users(2), loaded.recommend_for_all_users(2), "user",
               exact=False)


def test_fixture_recommendation_indexer_roundtrip():
    cols = {"user": np.array(["alice", "bob", "alice"], dtype=object),
            "item": np.array(["x", "y", "y"], dtype=object), "rating": np.array([1.0, 2.0, 3.0])}
    rt, pt = _both(cols)
    rm = ref_rec.RecommendationIndexer(user_input_col="user", item_input_col="item").fit(rt)
    pm = port_rec.RecommendationIndexer(user_input_col="user", item_input_col="item").fit(pt)
    for col in ("user_idx", "item_idx"):
        np.testing.assert_array_equal(np.asarray(pm.transform(pt)[col]),
                                      np.asarray(rm.transform(rt)[col]))
    assert pm.recover_user(0) == rm.recover_user(0) and pm.recover_item(999) == "-1"


def _ranking_data(seed=7, n_users=40, n_items=30, per_user=8):
    rng = np.random.default_rng(seed)
    users, items, ratings = [], [], []
    for u in range(n_users):
        pool = np.arange(0, n_items // 2) if u % 2 == 0 else np.arange(n_items // 2, n_items)
        for it in rng.choice(pool, size=per_user, replace=False):
            users.append(u)
            items.append(int(it))
            ratings.append(float(rng.integers(3, 6)))
    return {"user": np.array(users, np.int64), "item": np.array(items, np.int64),
            "rating": np.array(ratings)}


def _same_ranked(a, b):
    assert a.column_names == b.column_names
    for col in a.column_names:
        va, vb = list(a[col]), list(b[col])
        assert len(va) == len(vb)
        for x, y in zip(va, vb):
            assert list(np.asarray(x).ravel()) == list(np.asarray(y).ravel()), col


@pytest.mark.parametrize("mode", ["allUsers", "normal"])
def test_fixture_ranking_adapter_and_evaluator(mode):
    rt, pt = _both(_ranking_data())
    ref = ref_rec.RankingAdapter(k=5, mode=mode,
                                 recommender=ref_rec.SAR(support_threshold=1)).fit(rt)
    port = port_rec.RankingAdapter(k=5, mode=mode,
                                   recommender=SAR(support_threshold=1, device="cpu")).fit(pt)
    ra, pa = ref.transform(rt), port.transform(pt)
    _same_ranked(ra, pa)
    rm = ref_rec.RankingEvaluator(k=5, n_items=30).get_metrics_map(ra)
    pm = port_rec.RankingEvaluator(k=5, n_items=30).get_metrics_map(pa)
    assert set(pm) == set(rm)
    for key in rm:
        assert pm[key] == pytest.approx(rm[key], abs=METRIC_TOL), key
    if mode == "allUsers":
        assert pm["ndcgAt"] > 0.5 and pm["map"] > 0.3


def test_fixture_ranking_adapter_min_ratings_filters_before_fit():
    cols = {"user": np.array([0, 0, 0, 1], np.int64), "item": np.array([0, 1, 2, 3], np.int64),
            "rating": np.ones(4)}
    rt, pt = _both(cols)
    ref = ref_rec.RankingAdapter(k=2, min_ratings_per_user=2,
                                 recommender=ref_rec.SAR(support_threshold=1)).fit(rt)
    port = port_rec.RankingAdapter(k=2, min_ratings_per_user=2,
                                   recommender=SAR(support_threshold=1, device="cpu")).fit(pt)
    np.testing.assert_array_equal(np.asarray(port.recommender_model.user_affinity),
                                  np.asarray(ref.recommender_model.user_affinity))
    assert np.asarray(port.recommender_model.user_affinity).shape[0] == 1


def test_fixture_ranking_tvs_picks_better_param_map():
    rt, pt = _both(_ranking_data())
    maps = [{"similarity_function": "jaccard"}, {"similarity_function": "cooccurrence"}]
    ref = ref_rec.RankingTrainValidationSplit(
        estimator=ref_rec.SAR(support_threshold=1), estimator_param_maps=maps,
        evaluator=ref_rec.RankingEvaluator(k=5, metric_name="ndcgAt"), train_ratio=0.75,
        seed=3).fit(rt)
    port = port_rec.RankingTrainValidationSplit(
        estimator=SAR(support_threshold=1, device="cpu"), estimator_param_maps=maps,
        evaluator=port_rec.RankingEvaluator(k=5, metric_name="ndcgAt"), train_ratio=0.75,
        seed=3).fit(pt)
    np.testing.assert_allclose(port.validation_metrics, ref.validation_metrics, atol=METRIC_TOL)
    _same_recs(ref.recommend_for_all_users(3), port.recommend_for_all_users(3), "user",
               exact=False)


def test_fixture_ranking_tvs_filters_min_ratings():
    cols = {"user": np.array([0, 0, 0, 1], np.int64), "item": np.array([0, 1, 2, 0], np.int64),
            "rating": np.ones(4)}
    rt, pt = _both(cols)
    ref = ref_rec.RankingTrainValidationSplit(min_ratings_u=2, min_ratings_i=1,
                                              estimator=ref_rec.SAR(),
                                              evaluator=ref_rec.RankingEvaluator())
    port = port_rec.RankingTrainValidationSplit(min_ratings_u=2, min_ratings_i=1,
                                                estimator=SAR(device="cpu"),
                                                evaluator=port_rec.RankingEvaluator())
    assert port._filter_ratings(pt).num_rows == ref._filter_ratings(rt).num_rows == 3


def test_fixture_advanced_ranking_metrics_hand_checked():
    args = ([[1, 2, 3], [4, 5, 6]], [[1, 3], [7]])
    ref = ref_rec.AdvancedRankingMetrics(*args, k=3, n_items=10)
    port = port_rec.AdvancedRankingMetrics(*args, k=3, n_items=10)
    assert port.all_metrics() == ref.all_metrics()
    np.testing.assert_allclose(port.map(), ((1 + 2 / 3) / 2) / 2)


def test_fixture_ndcg_perfect_ranking_is_one():
    m = port_rec.AdvancedRankingMetrics([[1, 2, 3]], [[1, 2, 3]], k=3, n_items=5)
    assert m.ndcg_at() == ref_rec.AdvancedRankingMetrics(
        [[1, 2, 3]], [[1, 2, 3]], k=3, n_items=5).ndcg_at() == pytest.approx(1.0)


def test_fixture_evaluator_rejects_unknown_metric():
    for mod in (ref_rec, port_rec):
        with pytest.raises(ValueError):
            mod.RankingEvaluator(metric_name="nope")
