"""LM token pipeline with a learned-index-accelerated packed corpus
(counterpart of ``repro.data.pipeline``).

Documents of varying length are packed into one flat token stream; the
question "which document owns global token offset t?" (attention-boundary
resets, provenance) is predecessor search over the sorted doc-boundary
table, served by a PGM index: the port's ``PGMModel.predecessor``
(tensor ops, no kernel, as in the reference) over the sign-flipped int64
keys of :mod:`repro_torch.core.keys`, on the corpus's device.

The pipeline is deterministic, seedable, shard-aware (each data-parallel
host slices its own batch rows) and restartable from a step counter.  It
makes the reference's numpy draws, so one seed gives both packages the
same tokens, document starts, PGM leaves and batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.pgm import build_pgm
from repro_torch.device import resolve_device


@dataclass
class PackedCorpus:
    tokens: np.ndarray  # (T,) int32 flat packed stream
    doc_starts: np.ndarray  # (D,) int64 sorted boundary table
    vocab_size: int
    pgm: object  # PGM index over doc_starts
    device: torch.device
    table: torch.Tensor  # doc_starts as encoded keys on ``device``

    def doc_of(self, offsets) -> torch.Tensor:
        """Owning document of each global token offset (learned lookup):
        int64 ranks on the corpus's device.  ``offsets``: non-negative
        ints (numpy, a list, or an int64 tensor)."""
        if torch.is_tensor(offsets):
            q = offsets.to(device=self.device, dtype=torch.int64) ^ keymod.SIGN
        else:
            q = keymod.encode(np.asarray(offsets).astype(np.uint64), self.device)
        return self.pgm.predecessor(self.table, q)


def synth_corpus(
    vocab_size: int = 32_000,
    n_docs: int = 2_000,
    mean_len: int = 512,
    seed: int = 0,
    device=None,
) -> PackedCorpus:
    """Synthetic Zipf-token corpus with lognormal doc lengths; its lookups
    run on ``device`` (the card when None)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lengths = np.maximum(8, rng.lognormal(np.log(mean_len), 0.8, n_docs).astype(np.int64))
    total = int(lengths.sum())
    # Zipf-ish unigram stream (fast approximate via pareto)
    ranks = (rng.pareto(1.1, total) * 10).astype(np.int64) % vocab_size
    tokens = ranks.astype(np.int32)
    doc_starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    keys = doc_starts.astype(np.uint64)
    return PackedCorpus(tokens=tokens, doc_starts=doc_starts, vocab_size=vocab_size,
                        pgm=build_pgm(keys, eps=16), device=dev,
                        table=keymod.encode(keys, dev))


class TokenBatcher:
    """Deterministic, restartable next-token-prediction batches on the
    corpus's device.

    ``batch_at(step)`` is a pure function of (corpus, seed, step): a
    restart after failure replays the same data order (a checkpoint needs
    only the step counter).  ``shard``/``num_shards`` slice batch rows
    for data-parallel hosts.
    """

    def __init__(
        self,
        corpus: PackedCorpus,
        batch_size: int,
        seq_len: int,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
    ):
        if batch_size % num_shards:
            raise ValueError(f"batch {batch_size} does not split into {num_shards} shards")
        self.corpus = corpus
        self.batch = batch_size
        self.local_batch = batch_size // num_shards
        self.seq = seq_len
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self._t = len(corpus.tokens)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        starts = rng.integers(0, self._t - self.seq - 1, size=self.batch)
        starts = starts[self.shard * self.local_batch:(self.shard + 1) * self.local_batch]
        idx = starts[:, None] + np.arange(self.seq + 1)[None, :]
        window = self.corpus.tokens[idx]
        dev = self.corpus.device
        return {"tokens": torch.from_numpy(window[:, :-1].astype(np.int32)).to(dev),
                "labels": torch.from_numpy(window[:, 1:].astype(np.int32)).to(dev)}
