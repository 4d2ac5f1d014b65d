"""NME-SC spectral clustering (port of nemotron_tpu/diarize/cluster.py;
NeMo offline_clustering.py semantics).

All candidate Laplacians of the p sweep are stacked and decomposed with one
batched torch.linalg.eigvalsh on the host CPU in f32, as the JAX package
does with jnp.linalg.eigvalsh pinned to its CPU device: the sweep never
touches the serving card, and the server runs finalize_cluster on a worker
thread while engine ticks go on. The speaker count is the first maximum of
the eigengaps (np.argmax). Affinity, binarisation and k-means++ (from an
explicit np.random.Generator) stay in numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AFF_EPS = 3.5e-4
EIG_EPS = 1e-10
MIN_P_VAL = 2


@dataclasses.dataclass
class NmescConfig:
    max_num_speakers: int = 8
    max_rp_threshold: float = 0.25
    sparse_search_volume: int = 30
    nme_mat_size: int = 512
    min_samples_for_nmesc: int = 6
    oracle_num_speakers: int = -1
    fixed_thres: float = -1.0
    kmeans_random_trials: int = 1
    kmeans_seed: int = 0


@dataclasses.dataclass
class NmescResult:
    est_num_speakers: int = 1
    p_hat: int = 1
    labels: np.ndarray | None = None


def cosine_affinity(emb: np.ndarray) -> np.ndarray:
    """Row-L2-normalize (eps in denominator), cos-sim, diag=1, min-max scale."""
    emb = np.asarray(emb, np.float64)
    n = emb.shape[0]
    if n <= 1:
        return np.ones((1, 1), np.float32)
    norm = np.sqrt((emb ** 2).sum(axis=1))
    normed = emb / (norm + AFF_EPS)[:, None]
    aff = normed @ normed.T
    np.fill_diagonal(aff, 1.0)
    lo, hi = aff.min(), aff.max()
    if hi > lo:
        aff = (aff - lo) / (hi - lo)
    return aff.astype(np.float32)


def binarize_topk(aff: np.ndarray, p: int) -> np.ndarray:
    """Top-p per row (value desc, index asc tie-break), then (X + X^T)/2."""
    n = aff.shape[0]
    if p <= 0:
        return aff.copy()
    p = min(p, n)
    order = np.lexsort((np.arange(n)[None, :].repeat(n, 0), -aff), axis=1)
    out = np.zeros_like(aff)
    rows = np.repeat(np.arange(n), p)
    out[rows, order[:, :p].reshape(-1)] = 1.0
    return 0.5 * (out + out.T)


def laplacian(a: np.ndarray) -> np.ndarray:
    m = np.asarray(a, np.float64).copy()
    np.fill_diagonal(m, 0.0)
    d = np.abs(m).sum(axis=1)
    lap = -m
    np.fill_diagonal(lap, d)
    return lap


def _fully_connected(x: np.ndarray) -> bool:
    n = x.shape[0]
    if n == 0:
        return True
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    count = 1
    adj = x > 0
    while stack:
        v = stack.pop()
        nbrs = np.nonzero(adj[v] & ~seen)[0]
        for j in nbrs:
            seen[j] = True
            count += 1
            stack.append(int(j))
    return count == n


def _p_value_list(n: int, max_rp: float, volume: int) -> list[int]:
    """torch.linspace(1, max_N, steps).int() with de-dup (order-preserving)."""
    max_n = max(MIN_P_VAL, int(np.floor(n * max_rp)))
    steps = min(max_n, max(2, volume))
    vals = [int(1.0 + i * (max_n - 1.0) / max(1, steps - 1)) for i in range(steps)]
    seen: set[int] = set()
    return [v for v in vals if not (v in seen or seen.add(v))]


def _subsample(aff: np.ndarray, target: int) -> tuple[int, np.ndarray]:
    n = aff.shape[0]
    ratio = max(1, int(np.ceil(n / target)))
    if ratio == 1:
        return 1, aff
    keep = np.arange(0, n, ratio)
    return ratio, aff[np.ix_(keep, keep)]


def _batched_eig_sweep(sub_aff: np.ndarray, p_list: list[int],
                       max_num_speakers: int):
    """Stack one Laplacian per candidate p and eigendecompose them all in a
    single batched eigvalsh. Returns (g_p array, est_num_spk array)."""
    n = sub_aff.shape[0]
    laps = np.stack([laplacian(binarize_topk(sub_aff, p)) for p in p_list])
    # f32 on the host CPU, as the JAX package's CPU-pinned eigvalsh
    lambdas = torch.linalg.eigvalsh(
        torch.from_numpy(laps.astype(np.float32))).numpy()  # [P, N] asc
    gaps = lambdas[:, 1:] - lambdas[:, :-1]                        # [P, N-1]
    k = min(gaps.shape[1], max_num_speakers)
    kbest = np.argmax(gaps[:, :k], axis=1)                        # first max
    est = kbest + 1
    max_gap = gaps[np.arange(len(p_list)), kbest] / (
        lambdas.max(axis=1) + EIG_EPS
    )
    g_p = (np.asarray(p_list, np.float64) / n) / (max_gap + EIG_EPS)
    return g_p, est


def spectral_embedding(aff: np.ndarray, n_spks: int) -> np.ndarray:
    """First n_spks eigenvectors of L (smallest eigenvalues), columns reversed
    (NeMo convention). Returns [N, n_spks]."""
    lam, vec = np.linalg.eigh(laplacian(aff))
    del lam
    emb = vec[:, :n_spks][:, ::-1]
    return np.ascontiguousarray(emb, dtype=np.float32)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator,
               max_iter: int = 300, tol: float = 1e-4):
    n, d = x.shape
    if k <= 1:
        return np.zeros(n, np.int32), 0.0
    centers = np.empty((k, d), np.float64)
    xi = x.astype(np.float64)
    centers[0] = xi[rng.integers(n)]
    dist2 = ((xi - centers[0]) ** 2).sum(axis=1)
    for j in range(1, k):
        total = dist2.sum()
        if total <= 0:
            centers[j] = xi[rng.integers(n)]
            continue
        pick = rng.uniform(0, total)
        idx = int(np.searchsorted(np.cumsum(dist2), pick))
        idx = min(idx, n - 1)
        centers[j] = xi[idx]
        dist2 = np.minimum(dist2, ((xi - centers[j]) ** 2).sum(axis=1))

    prev_inertia = np.inf
    labels = np.zeros(n, np.int32)
    for _ in range(max_iter):
        d2 = ((xi[:, None, :] - centers[None]) ** 2).sum(axis=2)
        labels = d2.argmin(axis=1).astype(np.int32)
        inertia = d2[np.arange(n), labels].sum()
        for j in range(k):
            sel = labels == j
            if sel.any():
                centers[j] = xi[sel].mean(axis=0)
        if abs(prev_inertia - inertia) < tol:
            break
        prev_inertia = inertia
    return labels, prev_inertia


def nmesc_cluster(embeddings: np.ndarray,
                  cfg: NmescConfig | None = None) -> NmescResult:
    cfg = cfg or NmescConfig()
    emb = np.asarray(embeddings, np.float32)
    n = emb.shape[0]
    r = NmescResult()
    if n <= 0:
        r.labels = np.zeros(0, np.int32)
        return r

    aff = cosine_affinity(emb)

    if n <= cfg.min_samples_for_nmesc:
        r.est_num_speakers = (cfg.oracle_num_speakers
                              if cfg.oracle_num_speakers > 0 else 1)
        r.labels = np.zeros(n, np.int32)
        r.p_hat = n - 1
        return r

    ratio, sub_aff = _subsample(aff, cfg.nme_mat_size)
    nsub = sub_aff.shape[0]

    if cfg.fixed_thres > 0:
        p_list = [max(MIN_P_VAL, int(np.floor(nsub * cfg.fixed_thres)))]
    else:
        p_list = _p_value_list(nsub, cfg.max_rp_threshold,
                               cfg.sparse_search_volume)

    g_p, est = _batched_eig_sweep(sub_aff, p_list, cfg.max_num_speakers)
    best = int(np.argmin(g_p))
    est_num_spk = int(est[best])
    p_hat = ratio * p_list[best]

    final_aff = binarize_topk(aff, p_hat)
    if not _fully_connected(final_aff):
        cur_p = 1
        for p in p_list:
            cur_p = ratio * p
            trial = binarize_topk(aff, cur_p)
            final_aff = trial
            if _fully_connected(trial):
                break
        p_hat = cur_p

    n_clusters = (cfg.oracle_num_speakers
                  if cfg.oracle_num_speakers > 0 else est_num_spk)
    n_clusters = max(1, min(n_clusters, cfg.max_num_speakers))

    if n_clusters == 1:
        labels = np.zeros(n, np.int32)
    else:
        se = spectral_embedding(final_aff, n_clusters)
        rng = np.random.default_rng(cfg.kmeans_seed)
        best_labels, best_inertia = None, np.inf
        for _ in range(max(1, cfg.kmeans_random_trials)):
            lab, inertia = _kmeans_pp(se, n_clusters, rng)
            if inertia < best_inertia:
                best_labels, best_inertia = lab, inertia
        labels = best_labels

    r.est_num_speakers = n_clusters
    r.p_hat = p_hat
    r.labels = labels
    return r
