"""Shared inputs for the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages, since
jax.random and torch generators give different numbers from one seed.
"""

import contextlib
import math
import os

import numpy as np
import pytest
import torch

LB, UB = (-1.0, 0.0), (1.0, 0.99)
SMALL = (2, 16, 16, 16, 1)  # 2 -> 16x3 -> 1
NARROW = (2,) + (20,) * 8 + (1,)  # burgers_forward's net at full width
FIXTURE = os.path.join(
    os.path.dirname(__file__), "fixtures", "torch_port", "burgers_forward_8x20.npz"
)

# rtol, and atol as a multiple of max|reference|, per output. u_xx sums eight
# layers of products in another order, so it gets ten times the absolute room;
# f contains lambda2 * u_xx and gets the same.
TOL = {"u": (1e-5, 1e-5), "u_x": (1e-5, 1e-5), "u_t": (1e-5, 1e-5),
       "u_xx": (1e-5, 1e-4), "f": (1e-5, 1e-4)}


def assert_close(name, got, want):
    rtol, atol_rel = TOL[name]
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()),
        err_msg=name,
    )


def numpy_params(layers, seed):
    """JAX-layout params with init-like scale and nonzero biases."""
    rng = np.random.default_rng(seed)
    out = []
    for din, dout in zip(layers[:-1], layers[1:]):
        std = math.sqrt(2.0 / (din + dout))
        out.append({
            "W": (std * np.clip(rng.standard_normal((din, dout)), -2, 2)).astype(np.float32),
            "b": (0.1 * rng.standard_normal((1, dout))).astype(np.float32),
        })
    return out


def numpy_points(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(LB, UB, size=(n, 2)).astype(np.float32)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from pinns_tpu_torch.device import resolve_device

    return resolve_device("cuda")


HOST_READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__float__", "__int__")


@contextlib.contextmanager
def no_host_reads():
    """Inside, every Tensor method that reads a value to the host raises: a
    host read inside an evaluation captured into a CUDA graph would bake the
    first evaluation's value into the graph."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"a host read (Tensor.{name}) inside the evaluation")
        return read

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
