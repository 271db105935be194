"""Table tiers, CDF-preserving subsampling and query sampling
(counterpart of ``repro.data.tables``).

The tier sizes keep the reference's names and key counts (named there
for a TPU's memory levels); on an H100, L4 (128 MiB of keys) is the tier
larger than the 50 MB L2 cache, so its table lives in HBM.

Subsampling follows the paper's supplementary: draw uniform samples,
Kolmogorov–Smirnov-test each against the parent CDF, keep the candidate
with the smallest KL divergence.  Host numpy, operation for operation as
the reference, so the same seed gives the same tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.cdf import as_table

from . import distributions

# tier name -> number of keys
TIERS = {
    "L1": 16_384,
    "L2": 262_144,
    "L3": 2_097_152,
    "L4": 16_777_216,
}


def ks_statistic(sample: np.ndarray, parent: np.ndarray) -> float:
    """Two-sample KS statistic (both arrays sorted uint64)."""
    n, m = len(sample), len(parent)
    grid = np.concatenate([sample, parent])
    grid.sort(kind="mergesort")
    cdf_s = np.searchsorted(sample, grid, side="right") / n
    cdf_p = np.searchsorted(parent, grid, side="right") / m
    return float(np.max(np.abs(cdf_s - cdf_p)))


def kl_divergence(sample: np.ndarray, parent: np.ndarray, bins: int = 256) -> float:
    """KL(PDF_sample || PDF_parent) over a common histogram."""
    lo = min(sample[0], parent[0])
    hi = max(sample[-1], parent[-1])
    edges = np.linspace(np.float64(lo), np.float64(hi), bins + 1)
    ps, _ = np.histogram(sample.astype(np.float64), bins=edges)
    pp, _ = np.histogram(parent.astype(np.float64), bins=edges)
    ps = (ps + 1e-9) / (ps.sum() + bins * 1e-9)
    pp = (pp + 1e-9) / (pp.sum() + bins * 1e-9)
    return float(np.sum(ps * np.log(ps / pp)))


def subsample_preserving_cdf(parent: np.ndarray, n: int, seed: int = 0, tries: int = 8) -> np.ndarray:
    """Paper supp §2: repeat {uniform sample -> KS test}; keep the min-KL
    candidate (a stratified subsample when every candidate fails)."""
    rng = np.random.default_rng(seed)
    ks_crit = 1.63 * np.sqrt((n + len(parent)) / (n * len(parent)))  # alpha = 0.01
    best, best_kl = None, np.inf
    for _ in range(tries):
        cand = as_table(rng.choice(parent, size=int(n * 1.1), replace=False))[:n]
        if len(cand) < n:
            continue
        if ks_statistic(cand, parent) > ks_crit:
            continue  # the KS test says the distributions differ
        kl = kl_divergence(cand, parent)
        if kl < best_kl:
            best, best_kl = cand, kl
    if best is None:
        idx = np.linspace(0, len(parent) - 1, n).astype(np.int64)
        best = parent[idx]
    return best


@dataclass
class BenchTable:
    dataset: str
    tier: str
    table: np.ndarray

    @property
    def name(self) -> str:
        return f"{self.dataset}-{self.tier}"


def make_bench_tables(datasets=distributions.DATASETS, tiers=None, seed: int = 0,
                      scale: float = 1.0):
    """Every (dataset x tier) table: generated at the largest tier, the
    smaller tiers subsampled from it (CDF-preserving), as the paper derives
    its tiers from the full dataset."""
    tiers = tiers or TIERS
    out = []
    max_n = max(tiers.values())
    for ds in datasets:
        parent = distributions.generate(ds, int(max_n * scale) if scale != 1.0 else max_n,
                                        seed=seed)
        for tier, n in tiers.items():
            n_eff = max(16, int(n * scale))
            if n_eff >= len(parent):
                table = parent
            else:
                table = subsample_preserving_cdf(parent, n_eff, seed=seed)
            out.append(BenchTable(dataset=ds, tier=tier, table=table))
    return out


def make_queries(table: np.ndarray, n_queries: int, seed: int = 0) -> np.ndarray:
    """Paper §3.4: uniform with replacement from the table's elements."""
    rng = np.random.default_rng(seed + 7)
    return rng.choice(table, size=n_queries, replace=True)
