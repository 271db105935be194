"""Models (counterpart of ``repro.models``): the decoder-only LM
(``transformer``, dense and MoE: prefill and decode) over the shared
``layers`` and the one-card MoE block (``moe``); the recsys scorers
(``recsys``) over the embedding substrate (``embedding``: the mega-table
lookup and the learned-keyed embedding)."""

from . import embedding, layers, moe, recsys, transformer

__all__ = ["embedding", "layers", "moe", "recsys", "transformer"]
