"""Architecture registry (counterpart of ``repro.configs.base``).

Each arch registers ``spec()`` (the full published config and its shape
cells) and ``reduced()`` (the same topology at tiny widths, for CPU
tests).  Shape cells carry the batch and sequence sizes of each serving
or training workload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph_train
    dims: dict


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    config: object
    shapes: tuple  # tuple[ShapeCell, ...]
    notes: str = ""


_REGISTRY: Dict[str, Callable[[], ArchSpec]] = {}
_REDUCED: Dict[str, Callable[[], ArchSpec]] = {}


def register(arch_id: str, spec_fn, reduced_fn):
    _REGISTRY[arch_id] = spec_fn
    _REDUCED[arch_id] = reduced_fn


def get(arch_id: str, reduced: bool = False) -> ArchSpec:
    table = _REDUCED if reduced else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return table[arch_id]()


def list_archs():
    return sorted(_REGISTRY)


LM_SHAPES = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell(
        "long_500k",
        "decode",
        {"seq_len": 524288, "global_batch": 1, "seq_shard": True},
    ),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)


def gnn_shapes(t_max: int = 4):
    # minibatch_lg: fanout 15-10 from 1024 seeds -> fixed padded sizes
    mb_nodes = 1024 + 1024 * 15 + 1024 * 15 * 10
    mb_edges = 1024 * 15 + 1024 * 15 * 10
    return (
        ShapeCell(
            "full_graph_sm",
            "graph_train",
            {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_out": 7, "t_max": t_max},
        ),
        ShapeCell(
            "minibatch_lg",
            "graph_train",
            {"n_nodes": mb_nodes, "n_edges": mb_edges, "d_feat": 602, "n_out": 41, "t_max": t_max},
        ),
        ShapeCell(
            "ogb_products",
            "graph_train",
            {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "n_out": 47, "t_max": 2},
        ),
        ShapeCell(
            "molecule",
            "graph_train",
            {
                "n_nodes": 30 * 128,
                "n_edges": 64 * 128,
                "n_graphs": 128,
                "t_max": t_max,
                "energy": True,
            },
        ),
    )
