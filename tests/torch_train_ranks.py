"""A rank function for ``tests/test_torch_train.py``'s four ``gloo``
ranks: ``launch.mesh.spawn`` imports it by name in each new process, and
this module imports neither JAX nor the JAX package, so the ranks start
in a fraction of the test module's import time."""
import numpy as np
import torch

from repro_torch.train import compression

SHARDS = np.linspace(-1, 1, 4 * 32, dtype=np.float32).reshape(4, 32)


def psum_rank(rank, group, device):
    """Rank ``rank``'s shard ``x`` (``SHARDS[rank]`` times ``rank + 1``):
    its int8 sum, and the exact and int8 sums of ``{"a": x, "b": [x[:8] *
    3]}``."""
    x = torch.from_numpy(SHARDS[rank] * (rank + 1)).to(device)
    grads = {"a": x, "b": [x[:8] * 3.0]}
    return (compression.compressed_psum(x, group),
            compression.psum_grads(grads, group),
            compression.psum_grads(grads, group, compression="int8"))
