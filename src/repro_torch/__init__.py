"""Pangolin graph pattern mining on PyTorch and CUDA (the port of ``repro``).

The package mirrors the JAX package ``repro`` module by module, so each
counterpart is easy to find: ``graph/`` (CSR storage, DAG orientation,
generators), ``sparse/`` (ragged primitives), ``core/`` (app API, embedding
lists, phase backends, plan and engine), ``models/`` and ``configs/`` (the
transformer that ``launch/serve.py`` serves) and ``kernels/``
(hand-written CUDA kernels for Hopper with a plain PyTorch version of
each).

It imports ``torch`` and never ``jax`` nor anything of ``repro``.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
