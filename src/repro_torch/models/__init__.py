"""Models (counterpart of ``repro.models``): the decoder-only LM
(``transformer``, dense and MoE: prefill and decode) over the shared
``layers`` and the one-card MoE block (``moe``); the recsys scorers
(``recsys``) over the embedding substrate (``embedding``: the mega-table
lookup and the learned-keyed embedding); DimeNet (``dimenet``)."""

from . import dimenet, embedding, layers, moe, recsys, transformer

__all__ = ["dimenet", "embedding", "layers", "moe", "recsys", "transformer"]
