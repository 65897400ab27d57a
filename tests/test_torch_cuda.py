"""The port on the card: the fused Taylor-2 kernel and the served slice.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda``, and skips
where ``torch.cuda.is_available()`` is False. The file imports no jax (the
GPU machine has none), so it also runs without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.ops.taylor import mlp_taylor_2, mlp_taylor_2_reference
from pinns_tpu_torch.serve import ServedModel, export_predict
from pinns_tpu_torch.train.evaluate import relative_l2
from torch_port_util import FIXTURE, LB, UB, assert_close, cuda_device, numpy_points  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("layers,n", [((2,) + (20,) * 8 + (1,), 1000),
                                      ((2, 256, 256, 3), 777),
                                      ((2, 64, 1), 3)])
def test_kernel_matches_reference_on_card(cuda_device, layers, n):  # noqa: F811
    spec = MLPSpec(layers=layers, lb=LB, ub=UB)
    params = init_mlp(spec, torch.Generator().manual_seed(1), cuda_device)
    x = torch.from_numpy(numpy_points(n, seed=12)).to(cuda_device)
    before = k_taylor2.LAUNCHES
    got = mlp_taylor_2(spec, params, x)
    torch.cuda.synchronize()
    assert k_taylor2.LAUNCHES == before + 1
    # float64 oracle: the kernel is as accurate as the plain float32 recurrence
    # (random deep nets cancel too much for a max|.|-relative tolerance)
    spec64 = MLPSpec(layers=layers, lb=LB, ub=UB, dtype=torch.float64)
    exact = mlp_taylor_2_reference(
        spec64, [{k: v.double() for k, v in p.items()} for p in params], x.double()
    )
    plain = mlp_taylor_2_reference(spec, params, x)
    for g, p, e in zip(got, plain, exact):
        assert g.shape == (n, layers[-1])
        err = float((g.double() - e).abs().max())
        plain_err = float((p.double() - e).abs().max())
        assert err <= 4.0 * plain_err + 1e-6 * float(e.abs().max())


def test_served_model_on_card(cuda_device, tmp_path):  # noqa: F811
    loaded = load_params_npz(FIXTURE)
    art = export_predict(loaded["spec"], loaded["params"], str(tmp_path / "m"),
                         lambda1=loaded["lambda1"], lambda2=loaded["lambda2"])
    with np.load(FIXTURE, allow_pickle=False) as z:
        fx = {k: z[k] for k in ("X_star", "u_star", "u_jax", "f_jax", "rel_l2_jax")}
    served = ServedModel(art, device=cuda_device)
    before = k_taylor2.LAUNCHES
    out = served.predict(fx["X_star"], pad_to_bucket=True)
    assert k_taylor2.LAUNCHES > before
    for k in ("u", "f"):
        assert_close(k, out[k], fx[f"{k}_jax"])
    assert abs(relative_l2(out["u"], fx["u_star"]) - float(fx["rel_l2_jax"])) <= 1e-5
