"""Graph substrate: synthetic power-law graphs in CSR and a neighbour
sampler (counterpart of ``repro.data.sampler``).

CSR navigation ("which row owns edge e?") is predecessor search over
``row_offsets``, a sorted table whose CDF is the degree distribution: an
RMI serves it (the port's ``RMIModel.predecessor``, tensor ops, on the
graph's device).  The rest is host numpy with the reference's draws, so
one seed gives both packages the same graph and the same samples.  Its
model caller, DimeNet's ``minibatch_lg`` cell, comes with the DimeNet
slice (ROADMAP queue 1, item 13.5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.rmi import build_rmi
from repro_torch.device import resolve_device


@dataclass
class CSRGraph:
    row_offsets: np.ndarray  # (N+1,) int64
    col_idx: np.ndarray  # (E,) int32
    n_nodes: int
    n_edges: int
    feat_dim: int
    rmi: object  # learned index over row_offsets
    device: torch.device

    def row_of_edge(self, edge_ids) -> torch.Tensor:
        """Owning row of each edge id (learned predecessor search): int64
        ranks on the graph's device."""
        table = keymod.encode(self.row_offsets.astype(np.uint64), self.device)
        q = keymod.encode(np.asarray(edge_ids).astype(np.uint64), self.device)
        return self.rmi.predecessor(table, q)

    def src_dst_arrays(self):
        """(src, dst) int32 edge list (host) for segment-sum message passing."""
        degrees = np.diff(self.row_offsets)
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int32), degrees)
        return src, self.col_idx.astype(np.int32)


def synth_powerlaw_graph(n_nodes: int, avg_degree: int, feat_dim: int, seed: int = 0,
                         device=None) -> CSRGraph:
    """Preferential-attachment-flavoured random graph in CSR; its lookups
    run on ``device`` (the card when None)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # power-law target popularity
    pop = rng.pareto(1.5, n_nodes) + 1.0
    pop /= pop.sum()
    dst = rng.choice(n_nodes, size=n_edges, p=pop).astype(np.int32)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    row_offsets = np.searchsorted(src, np.arange(n_nodes + 1)).astype(np.int64)
    rmi = build_rmi(row_offsets.astype(np.uint64), b=max(2, n_nodes // 256))
    return CSRGraph(row_offsets=row_offsets, col_idx=dst, n_nodes=n_nodes, n_edges=n_edges,
                    feat_dim=feat_dim, rmi=rmi, device=dev)


def sample_neighbors(graph: CSRGraph, seeds: np.ndarray, fanouts, seed: int = 0):
    """GraphSAGE fanout sampling -> (nodes, hop_edges) on the host.

    Returns the union of sampled nodes (int32) and per-hop (src, dst)
    edge arrays (dst are parents).  Uniform with replacement over a
    node's neighbours; an isolated node samples itself."""
    rng = np.random.default_rng(seed)
    ro, ci = graph.row_offsets, graph.col_idx
    frontier = np.unique(seeds.astype(np.int64))
    all_nodes = [frontier]
    hop_edges = []
    for fanout in fanouts:
        deg = ro[frontier + 1] - ro[frontier]
        # sample `fanout` slots per frontier node (with replacement pad)
        offs = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(frontier), fanout))
        idx = ro[frontier][:, None] + offs
        nbrs = ci[np.minimum(idx, len(ci) - 1)]
        nbrs = np.where((deg > 0)[:, None], nbrs, frontier[:, None])  # isolated: self-loop
        src = nbrs.reshape(-1).astype(np.int32)
        dst = np.repeat(frontier, fanout).astype(np.int32)
        hop_edges.append((src, dst))
        frontier = np.unique(src.astype(np.int64))
        all_nodes.append(frontier)
    nodes = np.unique(np.concatenate(all_nodes)).astype(np.int32)
    return nodes, hop_edges
