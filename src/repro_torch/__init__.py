"""PyTorch/CUDA port of the (alpha, k)-minimal sorting system.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and imports nothing of it.  Its entry points
run on the CUDA device unless the caller passes ``device="cpu"``; there
every kernel runs as its plain PyTorch version.

    from repro_torch import cluster
    (keys, values), report = cluster.sort(x, algorithm="smms", values=v)
    (keys, _), report = cluster.sort(x, algorithm="terasort", seed=0)
    out, report = cluster.join(sk, sr, tk, tr, algorithm="statjoin",
                               t_machines=8)
    out, report = cluster.join(sk, sr, tk, tr, algorithm="randjoin",
                               t_machines=8, seed=0)
"""
from . import cluster, core, data, kernels

__all__ = ["cluster", "core", "data", "kernels"]
