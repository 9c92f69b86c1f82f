"""Scalable t-SNE — the BarnesHutTsne role (DL4J `deeplearning4j-tsne/.../
plot/BarnesHutTsne.java:70`), the variant that scales past the exact
algorithm's N x N matrices.

The attractive term is sparse: a k-nearest-neighbour affinity graph (k =
3 * perplexity) built on the estimator's device, tile by tile (each tile
of rows: its distances to all N points by a float64 matmul, top-k, the
precision search on the k neighbours in float32). The repulsion has two routes:
- theta > 0 (the default 0.5, as DL4J): true Barnes-Hut on the host, the
  C++ sp-tree of `native/src/sptree.cpp` through `manifold/sptree.py`,
  O(N log N) a gradient; the attraction in numpy.
- theta == 0, or no native library: exact repulsion streamed over row
  tiles of the kernel 1/(1 + d^2) on the device, so memory stays O(N *
  tile) (no N x N tensor) while the work is O(N^2) a gradient (the
  embedding's distances from coordinate differences); the attraction
  scattered over the edge list with `index_add_` (atomic adds
  on CUDA, so two runs on the card can differ in the last ulps).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.manifold.tsne import (
    _binary_search_perplexity, _embed_sqdist, _gains_step, _init_embedding,
)
from deeplearning4j_tpu_torch.util.platform import (
    resolve_device, set_f32_matmul_exact,
)

log = logging.getLogger("deeplearning4j_tpu_torch")


def _knn_affinity_tile(X, rows, k, target_entropy, sq=None):
    """For a tile of row indices: squared distances to ALL points, top-k
    neighbors, per-row beta (precision) binary search restricted to those
    neighbors. Returns (neighbor_idx (K,k), p_rows (K,k) in float32).

    The distances are the reference's expansion |x_i|^2 - 2 x_i.x_j +
    |x_j|^2, evaluated in float64 (pass X as float64 to convert it once):
    in float32 it cancels to ~1e-4 of d^2 at MNIST's |x|^2 ~ 300, which
    moves neighbour sets and the precision search. `sq`: the points'
    squared norms (float64), when the caller keeps them across tiles."""
    X = X.to(torch.float64)
    rows = torch.as_tensor(rows, device=X.device)
    if sq is None:
        sq = (X ** 2).sum(1)
    Xr = X[rows]                                     # (K, D)
    d2 = torch.addmm(sq[rows][:, None], Xr, X.T, alpha=-2.0)
    d2.add_(sq[None, :])
    # exclude self by +inf at each row's own column
    d2[torch.arange(len(rows), device=d2.device), rows] = float("inf")
    nd2, idx = torch.topk(d2, k, dim=1, largest=False)   # nearest k
    del d2
    return idx, _binary_search_perplexity(nd2.float(), target_entropy)


def _tiled_repulsion(Y, n_tiles, n_valid):
    """The repulsive numerators and the partition function, streamed over
    row tiles of the pairwise kernel num = 1/(1 + ||y_i - y_j||^2):
        frep[i] = y_i * sum_j num_ij^2 - num_i^2 @ Y,   Z = sum_ij num_ij
    The diagonal and every pad row and column (points >= n_valid exist
    only to make the tiling even) are zeroed. One (tile, N) buffer at a
    time (two while a tile's distances are summed)."""
    n = Y.shape[0]
    n_valid = int(n_valid)
    tile = n // n_tiles
    rows = torch.arange(tile, device=Y.device)
    z = torch.zeros((), dtype=Y.dtype, device=Y.device)
    frep = torch.zeros_like(Y)
    for r0 in range(0, n_tiles * tile, tile):
        Yr = Y[r0:r0 + tile]
        num = _embed_sqdist(Yr, Y).add_(1.0).reciprocal_()
        num[rows, rows + r0] = 0.0
        num[:, n_valid:] = 0.0
        if r0 + tile > n_valid:
            num[max(n_valid - r0, 0):] = 0.0
        z = z + num.sum()
        n2 = num.square_()
        frep[r0:r0 + tile] = Yr * n2.sum(1)[:, None] - n2 @ Y
        del num, n2
    return frep, z


def _tiled_forces(Y, edge_src, edge_dst, n_tiles, edge_p, n_valid):
    """One gradient evaluation with O(N * tile) memory.

    Attraction: over the sparse symmetric edge list (src, dst, p_sym):
        F_att[i] = sum_j p_sym_ij * num_ij * (y_i - y_j), scattered to both
        endpoints (`index_add_`).
    Repulsion + Z: `_tiled_repulsion`; F_rep[i] = frep[i] / Z.
    KL is accumulated over the sparse support (BarnesHutTsne.java reports
    the same sparse-support KL). Returns (grad, kl) as tensors on Y's
    device."""
    frep, z = _tiled_repulsion(Y, n_tiles, n_valid)
    z = torch.clamp(z, min=1e-12)

    dy = Y[edge_src] - Y[edge_dst]                   # (E, dim)
    num_e = 1.0 / (1.0 + (dy * dy).sum(1))
    f_e = (edge_p * num_e)[:, None] * dy
    fatt = torch.zeros_like(Y).index_add_(0, edge_src, f_e) \
        .index_add_(0, edge_dst, -f_e)

    grad = 4.0 * (fatt - frep / z)
    q_e = torch.clamp(num_e / z, min=1e-12)
    kl = torch.sum(edge_p * torch.log(torch.clamp(edge_p, min=1e-12) / q_e))
    return grad, kl


def _attraction(Y: np.ndarray, src, dst, p):
    """The host loop's attraction: num_e = 1/(1 + |y_src - y_dst|^2) and
    fatt, with fatt[src] += p num_e dy and fatt[dst] -= p num_e dy. The
    reference's row-wise numpy (`Y[src]`, `np.sum(dy * dy, 1)`, two
    `np.add.at` over rows) done one contiguous column at a time: the same
    operations on each element in the same order, so the same values
    bitwise, in a fraction of the time."""
    cols = np.ascontiguousarray(Y.T)
    dy = [np.take(c, src) - np.take(c, dst) for c in cols]
    sq = dy[0] * dy[0]
    for d in dy[1:]:
        sq += d * d
    num_e = 1.0 / (1.0 + sq)
    w = p * num_e
    fatt = np.zeros(cols.shape, Y.dtype)
    for j, d in enumerate(dy):
        f = w * d
        np.add.at(fatt[j], src, f)
        np.subtract.at(fatt[j], dst, f)
    return np.ascontiguousarray(fatt.T), num_e


class BarnesHutTsne:
    """Scalable t-SNE with the DL4J BarnesHutTsne knob set.

    theta > 0 (default 0.5, as the reference): TRUE Barnes-Hut — repulsion
    via the host-side sp-tree (`manifold/sptree.py` -> C++
    `native/src/sptree.cpp`) with the theta summary criterion; O(N log N)
    per iteration. Without the native library it takes the exact device
    path (and logs a warning): the Python tree is orders of magnitude
    slower.
    theta == 0: exact repulsion streamed in device row tiles (O(N^2) work,
    O(N*tile) memory) — approximation-free; the accuracy yardstick the
    tests compare against."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, max_iter: int = 500,
                 learning_rate: float = 200.0,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100,
                 early_exaggeration: float = 12.0,
                 tile_rows: int = 1024, use_pca_init: bool = True,
                 seed: int = 0, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.early_exaggeration = early_exaggeration
        self.tile_rows = tile_rows
        self.use_pca_init = use_pca_init
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_matmul_exact()      # TF32 would move neighbour sets
        self.kl_divergence_: Optional[float] = None
        self.kl_history_: list = []

    # ------------------------------------------------------------ affinity
    def _build_sparse_p(self, X: np.ndarray, perplexity: float):
        """kNN affinity graph, tiled on the device; returns the symmetric
        COO edge list (host numpy) with p values already normalized to
        sum 1 over the directed graph."""
        n = len(X)
        k = min(n - 1, max(3, int(3 * perplexity)))
        Xd = torch.as_tensor(np.asarray(X), device=self.device).double()
        sq = (Xd ** 2).sum(1)
        target_entropy = np.float32(np.log(perplexity))
        tile = min(self.tile_rows, n)
        all_idx = np.zeros((n, k), np.int64)
        all_p = np.zeros((n, k), np.float32)
        for t0 in range(0, n, tile):
            t1 = min(t0 + tile, n)
            rows = torch.arange(t0, t1, device=self.device)
            idx, p = _knn_affinity_tile(Xd, rows, k, target_entropy, sq=sq)
            all_idx[t0:t1] = idx.cpu().numpy()
            all_p[t0:t1] = p.cpu().numpy()
        # symmetrize on host: p_sym_ij = (p_ij + p_ji) / (2N); each
        # directed edge carries its own half, scatter adds both endpoint
        # contributions (BarnesHutTsne symmetrized CSR analog)
        src = np.repeat(np.arange(n), k)
        dst = all_idx.reshape(-1)
        vals = all_p.reshape(-1) / (2.0 * n)
        return src, dst, vals

    def _init_embedding(self, X: np.ndarray) -> np.ndarray:
        return _init_embedding(X, self.n_components, self.use_pca_init,
                               self.seed)

    # ----------------------------------------------------------------- fit
    def fit_transform(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        n = len(X)
        perplexity = self.perplexity if n >= 3 * self.perplexity else \
            max(2.0, (n - 1) / 3.0)
        src, dst, vals = self._build_sparse_p(X, perplexity)
        if self.theta > 0:
            from deeplearning4j_tpu_torch import native
            # mirror bh_repulsion's native gate (dim <= 3)
            if native.available() and self.n_components <= 3:
                return self._fit_barnes_hut(X, src, dst, vals)
            log.warning(
                "no native toolchain for the sp-tree; theta=%.2f takes "
                "the exact device-tiled repulsion", self.theta)
        dev = self.device
        edge_src = torch.as_tensor(src, device=dev)
        edge_dst = torch.as_tensor(dst, device=dev)
        edge_p = torch.as_tensor(vals, device=dev)
        Y = self._init_embedding(X)

        tile = min(self.tile_rows, n)
        pad = (-n) % tile           # pad to a tile multiple: even tiles
        n_tiles = (n + pad) // tile
        if pad:
            Y = np.concatenate([Y, np.full((pad, self.n_components), 1e6,
                                           np.float32)])
        Y = torch.as_tensor(Y, device=dev)
        inc = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        self.kl_history_ = []
        kl = None
        for it in range(self.max_iter):
            lying = it < self.stop_lying_iteration
            p_eff = edge_p * self.early_exaggeration if lying else edge_p
            grad, kl = _tiled_forces(Y, edge_src, edge_dst, n_tiles, p_eff,
                                     n)
            if pad:
                grad[n:] = 0.0
            mom = self.momentum if it < self.switch_momentum_iteration \
                else self.final_momentum
            Y, inc, gains = _gains_step(Y, inc, gains, grad, mom,
                                        self.learning_rate)
            Y = Y - Y[:n].mean(0)
            if it % 50 == 0 or it == self.max_iter - 1:
                self.kl_history_.append(float(kl))
        self.kl_divergence_ = float(kl)
        return Y[:n].cpu().numpy()

    def _fit_barnes_hut(self, X: np.ndarray, src, dst, vals) -> np.ndarray:
        """Host-side true Barnes-Hut loop (BarnesHutTsne.java gradient():
        sparse attraction + sp-tree theta-approximated repulsion)."""
        from deeplearning4j_tpu_torch.manifold.sptree import bh_repulsion
        Y = self._init_embedding(X)
        inc = np.zeros_like(Y)
        gains = np.ones_like(Y)
        self.kl_history_ = []
        self.cells_visited_ = []
        kl = None
        for it in range(self.max_iter):
            lying = it < self.stop_lying_iteration
            p = vals * self.early_exaggeration if lying else vals
            neg, z, visits = bh_repulsion(Y, self.theta)
            z = max(z, 1e-12)
            fatt, num_e = _attraction(Y, src, dst, p)
            grad = 4.0 * (fatt - neg / z)
            mom = self.momentum if it < self.switch_momentum_iteration \
                else self.final_momentum
            flip = np.sign(grad) != np.sign(inc)
            gains = np.where(flip, gains + 0.2, gains * 0.8)
            np.maximum(gains, 0.01, out=gains)
            inc = mom * inc - self.learning_rate * gains * grad
            Y = Y + inc
            Y -= Y.mean(0)
            if it % 50 == 0 or it == self.max_iter - 1:
                q_e = np.maximum(num_e / z, 1e-12)
                # graftlint: disable=host-sync-in-hot-path -- host numpy KL on every 50th iteration for the history curve; the gradients here are host numpy
                kl = float(np.sum(p * np.log(np.maximum(p, 1e-12) / q_e)))
                self.kl_history_.append(kl)
                self.cells_visited_.append(visits)
        self.kl_divergence_ = kl
        return Y
