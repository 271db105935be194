"""repro_torch — the learned static indexes of :mod:`repro`, in PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``index/``, ``kernels/``, ``data/``) so every module
has a counterpart there:

* ``core`` — host (numpy) model builds, copied operation for operation
  so every fitted leaf equals the reference's bit for bit, and the key
  encoding (:mod:`repro_torch.core.keys`): uint64 keys live on the
  device as int64 with the sign bit flipped, which keeps their order
  under signed compares.
* ``index`` — specs, registry and the :class:`~repro_torch.index.Index`
  of torch tensors; ``Index.lookup(table, queries, backend="kernel")``
  answers predecessor queries through the hand-written CUDA kernels.
* ``kernels`` — the CUDA search kernels (sources in ``csrc/``), each
  with a wrapper that launches it on CUDA tensors and a plain PyTorch
  twin that does the same arithmetic on CPU tensors.
* ``data`` — the seeded synthetic datasets and query sampling.
* ``dist`` and ``tune`` — leaf-wise stacking of same-spec indexes and
  ``tune.build_many``, whose :class:`~repro_torch.tune.BatchedIndexes`
  answers a query batch against many tables with one batched kernel
  launch.
* ``configs``, ``models`` and ``serve`` — the LM serving path: the LM
  architecture configs, the dense decoder's ``decode_step`` (its
  attention is the hand-written decode-attention kernel) and the
  continuous-batching :class:`~repro_torch.serve.DecodeEngine`.
* ``train`` and ``tree`` — training (optimizers, the train step,
  checkpoints, the loop) over nests of tensors walked in
  ``jax.tree_util``'s order.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from . import configs, core, data, dist, index, kernels, models, serve, train, tree, tune

__all__ = ["configs", "core", "data", "dist", "index", "kernels", "models", "serve", "train",
           "tree", "tune"]
