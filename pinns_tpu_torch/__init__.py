"""PyTorch + CUDA port of pinns_tpu (the JAX package beside it is the reference).

Slice 1 is the Burgers serving path: the domain-normalized tanh MLP
(``models.mlp``), its Taylor-2 derivative streams (``ops.taylor``, with the
fused pass as a hand-written Hopper kernel in ``csrc/taylor2.cu``), the Burgers
residual (``ops.residuals``), prediction (``train.evaluate``), and the
artifact / HTTP / CLI serving layer (``serve``, ``cli``).

The package imports torch and never jax or ``pinns_tpu``. Parameters keep the
JAX layout: a list of ``{"W": (din, dout), "b": (1, dout)}`` with the forward
``x @ W + b``, so ``interop`` converts between the two without transposes.
"""

__version__ = "0.1.0"
