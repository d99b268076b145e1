"""AccessAnomaly: collaborative-filtering anomaly scores, ALS on the card.

Port of ``synapseml_tpu/cyber/anomaly.py`` (reference:
``cyber/anomaly/collaborative_filtering.py`` — ``AccessAnomaly:472``,
``ModelNormalizeTransformer:886``, ``ConnectedComponents:415``,
``AccessAnomalyModel:161``): the same Params, outputs and fitted state.

- Per tenant, a dense ALS (:func:`als`) on the estimator's device: the
  initial factors are the reference's threefry draws (``gbdt/sampling.py``,
  bit-equal to ``jax.random.uniform``); each half-step's weighted Gram
  matrices ``einsum("bj,jk,jl->bkl")`` are one matrix product ``(B, J) @
  (J, k*k)`` over the factors' outer products, then a batched
  ``torch.linalg.solve`` and the projection to >= 0, all in full f32.
- The normalization (the negated per-tenant z-score folded into two bias
  dimensions) runs in numpy on the factors read back, as the reference's.
- Per-tenant ids, connected components and scoring are vectorized: ids by
  sorted unique (tenant, name) pairs, components by
  ``scipy.sparse.csgraph.connected_components`` numbered by the first row in
  which they appear (the reference's union-find numbering), scores by
  gathering each row's two vectors and one batched dot, with the
  reference's precedence: history -> 0, unknown user / resource -> NaN,
  cross-component -> +inf, else the dot.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import CarriedModel, ComplexParam, Estimator, Param, Table
from ..core.params import ParamValidators
from ..gbdt.sampling import prng_key, split, uniform
from ..runtime.device import full_f32, resolve_device
from .complement import ComplementAccessTransformer
from .scalers import LinearScalarScaler

__all__ = ["AccessAnomaly", "AccessAnomalyModel", "ConnectedComponents", "ANOMALY_TOL",
           "scores_agree", "dots_agree", "tenant_centres", "als", "als_initial_factors", "component_labels"]

_DEVICE_DOC = "'cuda[:i]' (default: the GPU) or 'cpu'"
# Port against reference (and card against CPU): anomaly scores agree within
# ANOMALY_TOL in z units (:func:`scores_agree`). The ALS solves k x k
# systems 2 x max_iter times in f32 with LU factorizations and Gram sums
# that round in another order than XLA's (and than the other device's): a
# half-step's system and solution differ by an ulp or two, which the
# iteration carries forward (further in explicit ALS than in implicit).
# A score is the tenant's z-score of the dot, -(dot - mean) / std, so its
# error is the dot's over std, and a tenant whose dots barely vary about a
# large mean (|mean / std| in the tens or more) magnifies it; such tenants
# are held to ANOMALY_TOL of the dot instead (:func:`dots_agree`).
ANOMALY_TOL = 1e-3


def tenant_centres(user_vectors: Dict[str, Dict[str, list]]) -> Dict[str, float]:
    """Each tenant's mean / std of its training dots: the first appended
    bias of any of its user vectors (``-1/std * [u, -mean, 1]``)."""
    return {t: float(next(iter(d.values()))[-2]) for t, d in user_vectors.items() if d}


def scores_agree(got: np.ndarray, want: np.ndarray, tol: float = ANOMALY_TOL) -> bool:
    """Whether finite anomaly scores agree within ``tol`` in z units."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= tol))


def dots_agree(got: np.ndarray, want: np.ndarray, centres: np.ndarray,
               tol: float = ANOMALY_TOL) -> bool:
    """Whether finite anomaly scores agree within ``tol`` of the dot product
    they standardize: in z units ``tol`` x max(1, |dot| / std), bounded by
    ``tol`` x max(1, |want| + |centre|), ``centres`` each row's tenant's
    mean / std (:func:`tenant_centres`)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(1.0, np.abs(want) + np.abs(np.asarray(centres, np.float64)))
    return bool(np.all(np.abs(got - want) <= tol * scale))


def _str(col) -> np.ndarray:
    """A column's values as strings, as ``str`` of each element gives them."""
    return np.asarray(col).astype(str)


def _codes(*cols: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Sorted unique (c0, c1, ...) tuples of string columns: (each row's
    tuple code, in sorted order; each level column of the unique tuples)."""
    parts = [np.unique(c, return_inverse=True) for c in cols]
    key = np.zeros(len(cols[0]), dtype=np.int64)
    for lv, inv in parts:
        key = key * len(lv) + inv
    uk, inv = np.unique(key, return_inverse=True)
    levels = []
    for lv, _ in reversed(parts):
        levels.append(lv[uk % len(lv)])
        uk = uk // len(lv)
    return inv.reshape(-1), levels[::-1]


def _ids_per_tenant(tenants: np.ndarray, names: np.ndarray):
    """The reference's ``IdIndexer(reset_per_partition=True)``: each row's id
    from 1 in the sorted order of its tenant's distinct names, and each
    tenant's sorted names (index i holds id i + 1)."""
    code, (t_lv, n_lv) = _codes(tenants, names)
    first = np.searchsorted(t_lv, t_lv, side="left")
    ids = np.arange(len(t_lv)) - first + 1
    vocab = {t: n_lv[t_lv == t] for t in np.unique(t_lv)}
    return ids[code], vocab


def als_initial_factors(n_users: int, n_items: int, rank: int, seed: int,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.uniform(k, (n, rank)) * 0.1`` of the two keys split from
    ``PRNGKey(seed)``, as f32 tensors on ``device``."""
    ku, ki = split(prng_key(seed))
    u = uniform(ku, n_users * rank, device).reshape(n_users, rank) * 0.1
    v = uniform(ki, n_items * rank, device).reshape(n_items, rank) * 0.1
    return u, v


def _gram(w: torch.Tensor, fixed: torch.Tensor) -> torch.Tensor:
    """``einsum("bj,jk,jl->bkl", w, fixed, fixed)`` as one matrix product."""
    j, k = fixed.shape
    outer = (fixed[:, :, None] * fixed[:, None, :]).reshape(j, k * k)
    return (w @ outer).reshape(w.shape[0], k, k)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve(a, b[..., None])[..., 0].clamp(min=0.0)


def als(ratings: np.ndarray, rank: int, iters: int, reg: float, implicit: bool,
        alpha: float, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ALS of ``ratings`` (n_u, n_i), 0 = unobserved, on ``device``;
    returns the (n_u, rank), (n_i, rank) f32 factors.

    Implicit (Hu-Koren-Volinsky, the reference's default): confidence
    c = 1 + alpha*r toward preference 1. Explicit: squared error on observed
    entries. Both half-steps are batched normal-equation solves; factors are
    projected to >= 0 (the reference sets ``nonnegative=True``)."""
    n_u, n_i = ratings.shape
    u, v = als_initial_factors(n_u, n_i, rank, seed, device)
    r = torch.from_numpy(np.asarray(ratings, np.float32)).to(device)
    p = (r > 0).to(torch.float32)
    eye = torch.eye(rank, dtype=torch.float32, device=device) * reg
    with full_f32():
        if implicit:
            ar, ar_t = alpha * r, (alpha * r).T.contiguous()
            p_t = p.T.contiguous()

            def half(fixed, rows, alpha_r):
                a = (fixed.T @ fixed + eye)[None] + _gram(alpha_r, fixed)
                return _solve(a, ((1.0 + alpha_r) * rows) @ fixed)

            for _ in range(iters):
                u = half(v, p, ar)
                v = half(u, p_t, ar_t)
        else:
            r_t, p_t = r.T.contiguous(), p.T.contiguous()

            def half(fixed, r_rows, w_rows):
                return _solve(_gram(w_rows, fixed) + eye[None], (w_rows * r_rows) @ fixed)

            for _ in range(iters):
                u = half(v, r, p)
                v = half(u, r_t, p_t)
    return u.cpu().numpy(), v.cpu().numpy()


def component_labels(tenants: np.ndarray, users: np.ndarray, resources: np.ndarray):
    """Bipartite user/resource components of string columns, numbered as the
    reference's union-find numbers them: by the first row in which a
    component appears. Returns (each row's component; the distinct (tenant,
    user) nodes' tenants, names, components; the same for resources)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(tenants)
    uc, (ut, un) = _codes(tenants, users)
    rc, (rt, rn) = _codes(tenants, resources)
    nu, nr = len(ut), len(rt)
    graph = coo_matrix((np.ones(n, np.int8), (uc, nu + rc)), shape=(nu + nr, nu + nr))
    _, lab = connected_components(graph, directed=False)
    row_comp = lab[uc]
    comps, first = np.unique(row_comp, return_index=True)
    relabel = np.zeros(lab.max() + 1 if len(lab) else 0, dtype=np.int64)
    relabel[comps[np.argsort(first)]] = np.arange(len(comps))
    return (relabel[row_comp], (ut, un, relabel[lab[:nu]]), (rt, rn, relabel[lab[nu:]]))


def _nest(tenants, names, values) -> Dict[str, Dict[str, int]]:
    """{tenant: {name: value}} of three parallel arrays (JSON-persistable)."""
    out: Dict[str, Dict[str, int]] = {}
    for t, n, v in zip(tenants.tolist(), names.tolist(), values.tolist()):
        out.setdefault(t, {})[n] = v
    return out


class ConnectedComponents:
    """Bipartite user/resource connected components per tenant (reference
    ``ConnectedComponents:415``; the iterative min-propagation joins are
    ``scipy.sparse.csgraph`` here)."""

    def __init__(self, tenant_col: str, user_col: str, res_col: str):
        self.tenant_col = tenant_col
        self.user_col = user_col
        self.res_col = res_col

    def compute(self, table: Table) -> Tuple[Dict, Dict]:
        """Returns ({(tenant, user): comp}, {(tenant, res): comp})."""
        _, users, resources = component_labels(_str(table[self.tenant_col]),
                                               _str(table[self.user_col]),
                                               _str(table[self.res_col]))
        return tuple({(t, n): c for t, n, c in zip(*(a.tolist() for a in nodes))}
                     for nodes in (users, resources))


class AccessAnomaly(Estimator):
    """Reference ``AccessAnomaly:472``; param names snake_cased from the
    reference's ``AccessAnomalyConfig`` defaults."""

    tenant_col = Param("tenant partition column", str, default="tenant")
    user_col = Param("user column", str, default="user")
    res_col = Param("resource column", str, default="res")
    likelihood_col = Param("access likelihood column (e.g. counts per time unit)", str,
                           default="likelihood")
    output_col = Param("anomaly score output (mean ~0, std ~1 per tenant)", str,
                       default="anomaly_score")
    rank_param = Param("latent factors", int, default=10, validator=ParamValidators.gt(0))
    max_iter = Param("ALS iterations", int, default=25, validator=ParamValidators.gt(0))
    reg_param = Param("ALS regularization", float, default=1.0)
    apply_implicit_cf = Param("implicit-feedback ALS (True, default) vs explicit with "
                              "complement sampling", bool, default=True)
    alpha_param = Param("implicit: confidence slope", float, default=1.0)
    complementset_factor = Param("explicit: complement samples per row", int, default=2)
    neg_score = Param("explicit: rating assigned to complement rows", float, default=1.0)
    low_value = Param("scale likelihood to [low_value, high_value] (None = no scaling)",
                      float, default=5.0)
    high_value = Param("scale likelihood upper bound", float, default=10.0)
    seed = Param("random seed", int, default=0)
    history_access_df = ComplexParam("optional Table of seen (tenant, user, res) scoring 0",
                                     object, default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    def _likelihood(self, table: Table) -> np.ndarray:
        """The likelihood scaled to [low, high] per tenant; ``high`` (1.0
        unscaled) where the column is absent."""
        if self.likelihood_col not in table:
            default = 1.0 if self.high_value is None else self.high_value
            return np.full(table.num_rows, default)
        if self.low_value is None:
            return np.asarray(table[self.likelihood_col], np.float64)
        scaler = LinearScalarScaler(
            input_col=self.likelihood_col, partition_key=self.tenant_col,
            output_col="__lik__", min_required_value=self.low_value,
            max_required_value=self.high_value)
        return np.asarray(scaler.fit(table).transform(table)["__lik__"], np.float64)

    def _fit(self, table: Table) -> "AccessAnomalyModel":
        self._validate_input(table, self.tenant_col, self.user_col, self.res_col)
        if (self.low_value is None) != (self.high_value is None):
            raise ValueError("low_value and high_value must be set together")
        dev = resolve_device(self.device)
        tenant_s = _str(table[self.tenant_col])
        # per-tenant consecutive ids from 1 (unknown -> 0 at transform)
        uid, user_names = _ids_per_tenant(tenant_s, _str(table[self.user_col]))
        rid, res_names = _ids_per_tenant(tenant_s, _str(table[self.res_col]))
        lik = self._likelihood(table)

        k = self.rank_param
        user_vecs: Dict[str, Dict[str, list]] = {}
        res_vecs: Dict[str, Dict[str, list]] = {}
        for tenant in sorted(set(tenant_s.tolist())):
            m = tenant_s == tenant
            uidx, ridx = uid[m] - 1, rid[m] - 1
            n_u, n_i = int(uidx.max()) + 1, int(ridx.max()) + 1
            ratings = np.zeros((n_u, n_i), dtype=np.float64)
            np.add.at(ratings, (uidx, ridx), lik[m])
            if not self.apply_implicit_cf:
                # explicit CF: unseen sampled pairs get neg_score
                comp = ComplementAccessTransformer(
                    partition_key=None, indexed_col_names=["u", "r"],
                    complementset_factor=self.complementset_factor, seed=self.seed,
                ).transform(Table({"u": uidx, "r": ridx}))
                if comp.num_rows:
                    ratings[np.asarray(comp["u"], np.int64),
                            np.asarray(comp["r"], np.int64)] = self.neg_score
            u, v = als(ratings, k, self.max_iter, self.reg_param, self.apply_implicit_cf,
                       self.alpha_param, self.seed, dev)
            # normalization (reference ModelNormalizeTransformer:886): compute
            # train-pair dots, per-tenant mean/std_pop, then fold the z-score
            # and negation into appended bias dims:
            #   user' = -1/std * [u, -mean, 1] ; res' = [v, 1, 0]
            #   => user'.res' = -(u.v - mean)/std
            dots = np.einsum("rk,rk->r", u[uidx], v[ridx])
            mean, std = float(dots.mean()), float(dots.std())
            std = std if std != 0.0 else 1.0
            u_aug = np.concatenate([u, np.full((n_u, 1), -mean), np.ones((n_u, 1))], axis=1)
            u_aug *= -1.0 / std
            v_aug = np.concatenate([v, np.ones((n_i, 1)), np.zeros((n_i, 1))], axis=1)
            user_vecs[tenant] = dict(zip(user_names[tenant].tolist(), u_aug.tolist()))
            res_vecs[tenant] = dict(zip(res_names[tenant].tolist(), v_aug.tolist()))

        history = self.history_access_df
        access = history if history is not None else table
        hist_cols = [_str(access[c]) for c in (self.tenant_col, self.user_col, self.res_col)]
        _, users, resources = component_labels(*hist_cols)
        return AccessAnomalyModel(
            tenant_col=self.tenant_col, user_col=self.user_col, res_col=self.res_col,
            output_col=self.output_col, user_vectors=user_vecs, res_vectors=res_vecs,
            user_components=_nest(*users), res_components=_nest(*resources),
            history=None if history is None else np.stack(hist_cols, axis=1).tolist(),
            device=self.device)


class _Side:
    """One side's (users' or resources') lookup: per tenant the sorted names
    and their rows of one matrix of vectors, and each row's component."""

    def __init__(self, vectors: Dict[str, Dict[str, list]],
                 components: Optional[Dict[str, Dict[str, int]]]):
        self.names: Dict[str, np.ndarray] = {}
        self.offset: Dict[str, int] = {}
        mats, comps, at = [], [], 0
        for tenant, d in (vectors or {}).items():
            names = np.array(sorted(d), dtype=str)
            cd = (components or {}).get(tenant, {})
            self.names[tenant], self.offset[tenant] = names, at
            mats.append(np.asarray([d[n] for n in names.tolist()], np.float64).reshape(
                len(names), -1))
            comps.append(np.asarray([cd.get(n, -1) for n in names.tolist()], np.int64))
            at += len(names)
        width = max((m.shape[1] for m in mats), default=0)
        self.vectors = (np.concatenate(mats) if mats else np.zeros((0, width)))
        self.components = np.concatenate(comps) if comps else np.zeros(0, np.int64)

    def rows(self, tenants: np.ndarray, names: np.ndarray) -> np.ndarray:
        """Each query's row in :attr:`vectors`, -1 where unknown."""
        out = np.full(len(names), -1, dtype=np.int64)
        for tenant in np.unique(tenants).tolist():
            known = self.names.get(tenant)
            if known is None or len(known) == 0:
                continue
            m = tenants == tenant
            q = names[m]
            pos = np.minimum(np.searchsorted(known, q), len(known) - 1)
            out[m] = np.where(known[pos] == q, pos + self.offset[tenant], -1)
        return out


class AccessAnomalyModel(CarriedModel):
    """Reference ``AccessAnomalyModel:161``. Scores (tenant, user, res) rows:
    NaN for unknown user/resource, +inf for cross-component access, 0 for
    pairs present in the history set, else the normalized CF score (the dot
    in f64 on the model's device)."""

    tenant_col = Param("tenant partition column", str, default="tenant")
    user_col = Param("user column", str, default="user")
    res_col = Param("resource column", str, default="res")
    output_col = Param("anomaly score output column", str, default="anomaly_score")
    user_vectors = ComplexParam("tenant -> {user -> augmented latent vector}", dict,
                                default=None)
    res_vectors = ComplexParam("tenant -> {res -> augmented latent vector}", dict,
                               default=None)
    user_components = ComplexParam("tenant -> {user -> component id}", dict, default=None)
    res_components = ComplexParam("tenant -> {res -> component id}", dict, default=None)
    history = ComplexParam("list of seen [tenant, user, res] scoring 0", object,
                           default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    _STATE = ("tenant_col", "user_col", "res_col", "output_col", "user_vectors",
              "res_vectors", "user_components", "res_components", "history")

    def _lookup(self, dev: torch.device):
        """(users, resources, their vectors on ``dev``), built once a model
        and device."""
        def build():
            users = _Side(self.user_vectors, self.user_components)
            resources = _Side(self.res_vectors, self.res_components)
            up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)
            return users, resources, up(users.vectors), up(resources.vectors)

        return self._cached("sides", str(dev), ("user_vectors", "res_vectors",
                                                "user_components", "res_components"), build)

    def _seen(self, tenants, users, resources) -> np.ndarray:
        """Which rows' (tenant, user, res) the history holds."""
        if self.history is None:
            return np.zeros(len(tenants), dtype=bool)
        hist = np.asarray(self.history, dtype=str).reshape(-1, 3)
        n = len(tenants)
        code, _ = _codes(*(np.concatenate([q, hist[:, j]])
                           for j, q in enumerate((tenants, users, resources))))
        return np.isin(code[:n], code[n:])

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.tenant_col, self.user_col, self.res_col)
        tenants, users, resources = (_str(table[c]) for c in
                                     (self.tenant_col, self.user_col, self.res_col))
        dev = resolve_device(self.device)
        user_side, res_side, u_vec, r_vec = self._lookup(dev)
        ui = user_side.rows(tenants, users)
        ri = res_side.rows(tenants, resources)
        known = (ui >= 0) & (ri >= 0)
        dots = np.zeros(len(ui))
        if known.any():
            gi = torch.from_numpy(ui[known]).to(dev)
            gr = torch.from_numpy(ri[known]).to(dev)
            dots[known] = (u_vec[gi] * r_vec[gr]).sum(1).cpu().numpy()
        uc = np.where(known, user_side.components[np.maximum(ui, 0)], -1)
        rc = np.where(known, res_side.components[np.maximum(ri, 0)], -1)
        cross = (uc >= 0) & (rc >= 0) & (uc != rc)
        out = np.where(known, np.where(cross, np.inf, dots), np.nan)
        out[self._seen(tenants, users, resources)] = 0.0
        return table.with_column(self.output_col, out)
