"""The assigned architectures, exact published configs (counterpart of
``repro.configs.archs``):

  LM:     granite-3-8b, minitron-8b, qwen2-0.5b,
          moonshot-v1-16b-a3b (MoE 64e top-6), qwen3-moe-235b-a22b (128e top-8)
  GNN:    dimenet
  RecSys: dlrm-mlperf, din, wide-deep, sasrec

Each also has a ``reduced`` variant (same topology, tiny dims) for the
CPU tests.  The decoder serves all five LMs (the MoE configs route each
layer's FFN through ``models/moe.py``); ``models/recsys.py`` scores the
four recsys archs; ``models/dimenet.py`` trains DimeNet's ``graph_train``
cells.
"""

from __future__ import annotations

from dataclasses import replace

from repro_torch.models.dimenet import DimeNetConfig
from repro_torch.models.recsys import CRITEO_VOCABS, RecsysConfig
from repro_torch.models.transformer import LMConfig

from .base import LM_SHAPES, RECSYS_SHAPES, ArchSpec, ShapeCell, gnn_shapes, register

GRANITE_3_8B = LMConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=12800, vocab=49155,
)
MINITRON_8B = LMConfig(
    name="minitron-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=16384, vocab=256000,
)
QWEN2_05B = LMConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    head_dim=64, d_ff=4864, vocab=151936, qkv_bias=True,
)
MOONSHOT_16B_A3B = LMConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=0, vocab=163840,
    moe=True, n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
)
QWEN3_MOE_235B = LMConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, head_dim=128, d_ff=0, vocab=151936,
    moe=True, n_experts=128, top_k=8, n_shared=0, d_ff_expert=1536,
)


def _lm_reduced(cfg: LMConfig) -> LMConfig:
    return replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
        head_dim=16,
        d_ff=0 if cfg.moe else 128,
        vocab=256,
        n_experts=8 if cfg.moe else 0,
        top_k=min(2, cfg.top_k) if cfg.moe else 0,
        d_ff_expert=32 if cfg.moe else 0,
        n_shared=min(1, cfg.n_shared),
        q_chunk=64,
    )


def _lm_spec(cfg):
    def full():
        return ArchSpec(cfg.name, "lm", cfg, LM_SHAPES)

    def reduced():
        shapes = (
            ShapeCell("train_4k", "train", {"seq_len": 64, "global_batch": 4}),
            ShapeCell("prefill_32k", "prefill", {"seq_len": 128, "global_batch": 2}),
            ShapeCell("decode_32k", "decode", {"seq_len": 128, "global_batch": 4}),
            ShapeCell(
                "long_500k", "decode", {"seq_len": 256, "global_batch": 1, "seq_shard": True}
            ),
        )
        return ArchSpec(cfg.name, "lm", _lm_reduced(cfg), shapes)

    return full, reduced


for _cfg in (GRANITE_3_8B, MINITRON_8B, QWEN2_05B, MOONSHOT_16B_A3B, QWEN3_MOE_235B):
    register(_cfg.name, *_lm_spec(_cfg))

# ---------------------------------------------------------------------------
# GNN: DimeNet
# ---------------------------------------------------------------------------

# triplet_layout="padded": every triplet beside its target edge (a row
# sum, no segment sum over triplets); "flat" is the reference's baseline
DIMENET = DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
    n_radial=6, triplet_layout="padded",
)


def _dimenet_full():
    return ArchSpec("dimenet", "gnn", DIMENET, gnn_shapes())


def _dimenet_reduced():
    cfg = replace(DIMENET, n_blocks=2, d_hidden=32, n_bilinear=4, n_spherical=3, n_radial=4)
    shapes = (
        ShapeCell(
            "full_graph_sm",
            "graph_train",
            {"n_nodes": 64, "n_edges": 256, "d_feat": 32, "n_out": 7, "t_max": 3},
        ),
        ShapeCell(
            "minibatch_lg",
            "graph_train",
            {"n_nodes": 124, "n_edges": 240, "d_feat": 16, "n_out": 5, "t_max": 3},
        ),
        ShapeCell(
            "ogb_products",
            "graph_train",
            {"n_nodes": 128, "n_edges": 512, "d_feat": 16, "n_out": 8, "t_max": 2},
        ),
        ShapeCell(
            "molecule",
            "graph_train",
            {"n_nodes": 10 * 4, "n_edges": 20 * 4, "n_graphs": 4, "t_max": 3, "energy": True},
        ),
    )
    return ArchSpec("dimenet", "gnn", cfg, shapes)


register("dimenet", _dimenet_full, _dimenet_reduced)

# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

DLRM_MLPERF = RecsysConfig(
    name="dlrm-mlperf", kind="dlrm", embed_dim=128, vocab_sizes=CRITEO_VOCABS,
    n_dense=13, bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot",
)
DIN = RecsysConfig(
    name="din", kind="din", embed_dim=18, vocab_sizes=(10_000_000, 1_000_000),
    attn_mlp=(80, 40), top_mlp=(200, 80), seq_len=100, interaction="target-attn",
)
WIDE_DEEP = RecsysConfig(
    name="wide-deep", kind="wide_deep", embed_dim=32,
    vocab_sizes=tuple([1_000_000] * 5 + [100_000] * 10 + [10_000] * 10 + [1_000] * 15),
    top_mlp=(1024, 512, 256), interaction="concat",
)
SASREC = RecsysConfig(
    name="sasrec", kind="sasrec", embed_dim=50, vocab_sizes=(1_000_000,),
    n_blocks=2, n_heads=1, seq_len=50, interaction="self-attn-seq",
)


def _recsys_spec(cfg):
    def full():
        return ArchSpec(cfg.name, "recsys", cfg, RECSYS_SHAPES)

    def reduced():
        r = replace(
            cfg,
            vocab_sizes=tuple(min(v, 1000) for v in cfg.vocab_sizes),
            embed_dim=min(cfg.embed_dim, 16),
            bot_mlp=(tuple(min(x, 32) for x in cfg.bot_mlp[:-1]) + (min(cfg.embed_dim, 16),))
            if cfg.bot_mlp else (),
            top_mlp=tuple(min(x, 32) for x in cfg.top_mlp),
            attn_mlp=tuple(min(x, 16) for x in cfg.attn_mlp),
            seq_len=min(cfg.seq_len, 12) if cfg.seq_len else 0,
        )
        shapes = (
            ShapeCell("train_batch", "train", {"batch": 64}),
            ShapeCell("serve_p99", "serve", {"batch": 16}),
            ShapeCell("serve_bulk", "serve", {"batch": 128}),
            ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 512}),
        )
        return ArchSpec(cfg.name, "recsys", r, shapes)

    return full, reduced


for _cfg in (DLRM_MLPERF, DIN, WIDE_DEEP, SASREC):
    register(_cfg.name, *_recsys_spec(_cfg))
