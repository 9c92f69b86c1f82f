"""t-SNE (DL4J `deeplearning4j-tsne/.../plot/{Tsne,BarnesHutTsne}.java`).

Exact t-SNE on the estimator's device (CUDA by default): the affinities'
per-row precision search and every gradient step are PyTorch ops over
N x N tensors (the input distances by the reference's expansion, a
float64 matmul; the embedding's distances from coordinate differences,
which do not cancel as the embedding spreads). It holds
several N x N f32 matrices at once (400 MB each at N = 10,000), so it
serves the N range of embedding visualization (N ~ 1e3-1e4); past that,
`BarnesHutTsne` keeps memory O(N * tile). Same knobs as the reference
(perplexity, momentum/lr schedule, early exaggeration, PCA init).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.platform import (
    resolve_device, set_f32_matmul_exact,
)

#: fixed bisection steps of the precision search, as the reference's scan
SEARCH_STEPS = 50


def _hbeta(d2, beta):
    """Entropy and conditional probabilities of each row of `d2` at its
    precision `beta` (a scalar for one row, or one value per row)."""
    beta = torch.as_tensor(beta, dtype=d2.dtype, device=d2.device)
    p = torch.exp(-d2 * beta[..., None])
    sum_p = torch.clamp(p.sum(-1), min=1e-12)
    h = torch.log(sum_p) + beta * (d2 * p).sum(-1) / sum_p
    return h, p / sum_p[..., None]


def _binary_search_perplexity(d2, target_entropy):
    """Per-row precision bisection, SEARCH_STEPS fixed steps on every row
    at once; returns the rows' conditional probabilities."""
    target_entropy = float(target_entropy)
    rows = d2.shape[:-1]
    kw = dict(dtype=d2.dtype, device=d2.device)
    beta = torch.ones(rows, **kw)
    lo = torch.full(rows, -float("inf"), **kw)
    hi = torch.full(rows, float("inf"), **kw)
    for _ in range(SEARCH_STEPS):
        h, _p = _hbeta(d2, beta)
        too_high = h > target_entropy
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2,
                           torch.where(torch.isinf(lo), beta / 2,
                                       (lo + hi) / 2))
    _, p = _hbeta(d2, beta)
    return p


def _sqdist(A, B):
    """||a_i - b_j||^2 by the expansion the reference uses."""
    return ((A ** 2).sum(1)[:, None] - 2 * A @ B.T
            + (B ** 2).sum(1)[None, :])


def _embed_sqdist(A, B):
    """||a_i - b_j||^2 from coordinate differences, for the embedding's
    few dimensions. The expansion |a|^2 - 2 a.b + |b|^2 cancels once the
    embedding spreads (|y|^2 ~ 1e3 against neighbours' d^2 ~ 1e-2 late in
    a fit); the differences keep every pair to rounding."""
    d2 = None
    for k in range(A.shape[1]):
        diff = A[:, k, None] - B[None, :, k]
        if d2 is None:
            d2 = diff.square_()
        else:
            d2.addcmul_(diff, diff)
    return d2


def _tsne_grad(Y, P):
    """Exact t-SNE gradient: attractive PQ + repulsive Q^2 terms."""
    num = 1.0 / (1.0 + _embed_sqdist(Y, Y))
    num.fill_diagonal_(0.0)
    z = torch.clamp(num.sum(dtype=torch.float64), min=1e-12)
    Q = torch.clamp(num / z.to(num.dtype), min=1e-12)
    PQ = (P - Q) * num
    # 4 (diag(rowsum PQ) - PQ) @ Y without the N x N diagonal matrix; the
    # N-term sums in float64, so no device's summation order shows
    PQ = PQ.to(torch.float64)
    Y64 = Y.to(torch.float64)
    grad = 4.0 * (PQ.sum(1)[:, None] * Y64 - PQ @ Y64)
    del PQ
    kl = torch.sum(P * torch.log(torch.clamp(P, min=1e-12) / Q),
                   dtype=torch.float64)
    return grad.to(Y.dtype), kl.to(Y.dtype)


def _joint_p(Xd, perplexity: float):
    """The symmetric joint probabilities P (N x N, summing to 1) of the
    points `Xd` at `perplexity`, in Xd's dtype. The input distances are
    the reference's expansion evaluated in float64: in float32 it cancels
    to ~1e-4 of d^2 at MNIST's |x|^2 ~ 300, which the precision search
    turns into errors of P."""
    X64 = Xd.to(torch.float64)
    d2 = _sqdist(X64, X64).to(Xd.dtype)
    del X64
    d2.fill_diagonal_(1e12)                           # exclude self
    P = _binary_search_perplexity(d2, np.log(perplexity))
    del d2
    P.fill_diagonal_(0.0)
    P = P + P.T
    return P / torch.clamp(P.sum(), min=1e-12)


def _init_embedding(X: np.ndarray, n_components: int, use_pca_init: bool,
                    seed: int) -> np.ndarray:
    """The reference's start: PCA scaled to std 1e-4, or a seeded
    Gaussian."""
    rs = np.random.RandomState(seed)
    if use_pca_init:
        Xc = X - X.mean(0)
        _, _, vt = np.linalg.svd(Xc, full_matrices=False)
        Y = (Xc @ vt[:n_components].T).astype(np.float32)
        return Y / (Y.std(0) + 1e-9) * 1e-4
    return rs.randn(len(X), n_components).astype(np.float32) * 1e-4


def _gains_step(Y, inc, gains, grad, mom, learning_rate):
    """The reference's delta-bar-delta gains and momentum update."""
    gains = torch.where(torch.sign(grad) != torch.sign(inc),
                        gains + 0.2, gains * 0.8)
    gains = torch.clamp(gains, min=0.01)
    inc = mom * inc - learning_rate * gains * grad
    return Y + inc, inc, gains


class Tsne:
    """Exact t-SNE with the DL4J Tsne/BarnesHutTsne knob set."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 max_iter: int = 500, learning_rate: float = 200.0,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100,
                 early_exaggeration: float = 12.0,
                 use_pca_init: bool = True, seed: int = 0, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.early_exaggeration = early_exaggeration
        self.use_pca_init = use_pca_init
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_matmul_exact()      # TF32 would move the affinities
        self.kl_divergence_: Optional[float] = None

    def fit_transform(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        n = len(X)
        if n < 3 * self.perplexity:
            perplexity = max(2.0, (n - 1) / 3.0)
        else:
            perplexity = self.perplexity
        P = _joint_p(torch.as_tensor(X, device=self.device), perplexity)
        Y = torch.as_tensor(_init_embedding(X, self.n_components,
                                            self.use_pca_init, self.seed),
                            device=self.device)
        inc = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        kl = None
        for it in range(self.max_iter):
            lying = it < self.stop_lying_iteration
            Peff = P * self.early_exaggeration if lying else P
            grad, kl = _tsne_grad(Y, Peff)
            mom = self.momentum if it < self.switch_momentum_iteration \
                else self.final_momentum
            Y, inc, gains = _gains_step(Y, inc, gains, grad, mom,
                                        self.learning_rate)
            Y = Y - Y.mean(0)
        self.kl_divergence_ = float(kl)
        return Y.cpu().numpy()
