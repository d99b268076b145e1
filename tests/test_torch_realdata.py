"""The breast-cancer rows of ``tests/benchmarks/benchmarks_gbdt_realdata.csv``
(sklearn's bundled real dataset: gbdt, rf, dart, goss) reached by the
port's own CPU ``train``, with ``benchmark_utils.measure_classifier``'s
config and split."""

import pytest

import benchmark_utils as bu
from synapseml_tpu_torch.gbdt.boost import train
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _realdata_rows():
    return [pytest.param(r, id=r["variant"])
            for r in bu.read_benchmarks("benchmarks_gbdt_realdata.csv")
            if r["dataset"] == "breast_cancer"]


@pytest.mark.parametrize("row", _realdata_rows())
def test_breast_cancer_rows_reached_by_the_port(row):
    """``benchmark_utils.measure_classifier``'s config and split, trained by
    the port's CPU ``train``: held-out AUC within the row's precision (0.01)
    of the reference's committed value."""
    x, y = bu.CLF_DATASETS["breast_cancer"]()
    xtr, ytr, xte, yte = bu._split(x, y)
    params = {"objective": "binary", "num_iterations": 100, "num_leaves": 31,
              "min_data_in_leaf": 20, "seed": 0, **bu.CLF_VARIANTS[row["variant"]]}
    booster = train(params, xtr, ytr, device="cpu")
    got = float(bu.auc(yte, booster.predict(xte, device="cpu")))
    assert abs(got - float(row["value"])) <= float(row["precision"]), (got, row)
