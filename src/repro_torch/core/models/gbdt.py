"""From-scratch histogram gradient-boosted regression trees.

Plays the role of XGBoost [11] in the paper (the package takes no xgboost
dependency): second-order boosting on binned
features with the paper's **gamma-deviance objective** (log link) for
right-skewed runtimes, plus an L2 objective for generality.

Gamma deviance, log link F = log(mu):
    dev = 2 * (log(mu/y) + y/mu - 1)
    g   = d(dev/2)/dF = 1 - y/mu
    h   = d2(dev/2)/dF2 = y/mu

Everything is vectorized numpy: histograms via one bincount over
(feature x bin) flattened codes per node; prediction via level-synchronous
array traversal. Deterministic given the seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["GBDTConfig", "GBDT"]


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    n_trees: int = 150
    max_depth: int = 6
    learning_rate: float = 0.1
    objective: str = "gamma"          # gamma | l2
    max_bins: int = 256
    reg_lambda: float = 1.0
    min_child_weight: float = 1e-3
    min_split_gain: float = 1e-6
    subsample: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class _Tree:
    feature: np.ndarray    # (nodes,) int32, -1 = leaf
    threshold: np.ndarray  # (nodes,) int32 bin id; go left if code <= thr
    left: np.ndarray       # (nodes,) int32
    right: np.ndarray      # (nodes,) int32
    value: np.ndarray      # (nodes,) float64 leaf values


class GBDT:
    """Histogram GBDT regressor (fit/predict, sklearn-ish surface)."""

    def __init__(self, config: GBDTConfig = GBDTConfig()):
        self.cfg = config
        self.trees: List[_Tree] = []
        self.bin_edges: List[np.ndarray] = []
        self.base_score: float = 0.0

    # ------------------------------------------------------------- binning --
    def _fit_bins(self, X: np.ndarray) -> np.ndarray:
        nb = self.cfg.max_bins
        codes = np.empty(X.shape, np.uint8)
        self.bin_edges = []
        for f in range(X.shape[1]):
            qs = np.quantile(X[:, f], np.linspace(0, 1, nb + 1)[1:-1])
            edges = np.unique(qs)
            self.bin_edges.append(edges)
            codes[:, f] = np.searchsorted(edges, X[:, f], side="left")
        return codes

    def _transform_bins(self, X: np.ndarray) -> np.ndarray:
        codes = np.empty(X.shape, np.uint8)
        for f, edges in enumerate(self.bin_edges):
            codes[:, f] = np.searchsorted(edges, X[:, f], side="left")
        return codes

    # ----------------------------------------------------------- objective --
    def _grad_hess(self, y: np.ndarray, F: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        if self.cfg.objective == "gamma":
            r = y * np.exp(-F)                 # y / mu
            return 1.0 - r, np.maximum(r, 1e-12)
        return F - y, np.ones_like(y)          # l2

    # ----------------------------------------------------------------- fit --
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDT":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        assert np.all(y > 0) or self.cfg.objective != "gamma", \
            "gamma objective needs positive targets"
        cfg = self.cfg
        rng = np.random.RandomState(cfg.seed)
        codes = self._fit_bins(X)
        n, F_dim = codes.shape
        nb = cfg.max_bins

        self.base_score = (float(np.log(np.mean(y))) if cfg.objective == "gamma"
                           else float(np.mean(y)))
        F = np.full(n, self.base_score)
        flat_base = (np.arange(F_dim, dtype=np.int64) * nb)[None, :]  # (1, F)

        for _ in range(cfg.n_trees):
            g, h = self._grad_hess(y, F)
            rows = (np.nonzero(rng.rand(n) < cfg.subsample)[0]
                    if cfg.subsample < 1.0 else np.arange(n))
            tree = self._grow_tree(codes, g, h, rows, flat_base)
            self.trees.append(tree)
            F += cfg.learning_rate * self._predict_tree(tree, codes)
        return self

    def _grow_tree(self, codes, g, h, rows, flat_base) -> _Tree:
        cfg = self.cfg
        nb = cfg.max_bins
        F_dim = codes.shape[1]
        max_nodes = 2 ** (cfg.max_depth + 1)
        feature = np.full(max_nodes, -1, np.int32)
        threshold = np.zeros(max_nodes, np.int32)
        left = np.zeros(max_nodes, np.int32)
        right = np.zeros(max_nodes, np.int32)
        value = np.zeros(max_nodes, np.float64)
        next_id = 1

        # stack of (node_id, row_indices, depth)
        stack: List[Tuple[int, np.ndarray, int]] = [(0, rows, 0)]
        while stack:
            nid, idx, depth = stack.pop()
            Gn, Hn = g[idx].sum(), h[idx].sum()
            value[nid] = -Gn / (Hn + cfg.reg_lambda)
            if depth >= cfg.max_depth or idx.size < 2:
                continue
            # histograms over (feature, bin) in one bincount
            flat = (codes[idx].astype(np.int64) + flat_base).ravel()
            Gh = np.bincount(flat, weights=np.repeat(g[idx], F_dim),
                             minlength=F_dim * nb).reshape(F_dim, nb)
            Hh = np.bincount(flat, weights=np.repeat(h[idx], F_dim),
                             minlength=F_dim * nb).reshape(F_dim, nb)
            GL = np.cumsum(Gh, axis=1)
            HL = np.cumsum(Hh, axis=1)
            GR = Gn - GL
            HR = Hn - HL
            lam = cfg.reg_lambda
            gain = (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                    - Gn ** 2 / (Hn + lam))
            ok = (HL >= cfg.min_child_weight) & (HR >= cfg.min_child_weight)
            gain = np.where(ok, gain, -np.inf)
            gain[:, -1] = -np.inf                     # no empty right child
            f_best, b_best = np.unravel_index(np.argmax(gain), gain.shape)
            if gain[f_best, b_best] <= cfg.min_split_gain:
                continue
            go_left = codes[idx, f_best] <= b_best
            li, ri = idx[go_left], idx[~go_left]
            if li.size == 0 or ri.size == 0:
                continue
            feature[nid] = f_best
            threshold[nid] = b_best
            left[nid], right[nid] = next_id, next_id + 1
            stack.append((next_id, li, depth + 1))
            stack.append((next_id + 1, ri, depth + 1))
            next_id += 2
        return _Tree(feature[:next_id], threshold[:next_id],
                     left[:next_id], right[:next_id], value[:next_id])

    # ------------------------------------------------------------- predict --
    @staticmethod
    def _predict_tree(tree: _Tree, codes: np.ndarray) -> np.ndarray:
        node = np.zeros(codes.shape[0], np.int32)
        while True:
            feat = tree.feature[node]
            active = feat >= 0
            if not active.any():
                break
            f = np.maximum(feat, 0)
            go_left = codes[np.arange(codes.shape[0]), f] <= tree.threshold[node]
            nxt = np.where(go_left, tree.left[node], tree.right[node])
            node = np.where(active, nxt, node)
        return tree.value[node]

    def raw_predict(self, X: np.ndarray) -> np.ndarray:
        codes = self._transform_bins(np.asarray(X, np.float64))
        F = np.full(codes.shape[0], self.base_score)
        for t in self.trees:
            F += self.cfg.learning_rate * self._predict_tree(t, codes)
        return F

    def predict(self, X: np.ndarray) -> np.ndarray:
        F = self.raw_predict(X)
        return np.exp(F) if self.cfg.objective == "gamma" else F
