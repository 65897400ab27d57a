"""The wide design of the fused Adam epoch (K3 above width 32) on the CPU: its
algorithm written out in plain PyTorch (``wide_loss_and_grad_reference``:
the stacked batch of collocation and data points, the data rows' zero
derivative seeds, dW as split partials, db and the loss as per-tile sums,
the reductions in a fixed order with the ``l1_sq_norm`` scaling after them)
held against the fused step's reverse mode and torch.autograd in float64,
and against JAX's ``value_and_grad`` of the loss in float32; and the plan
(``step_plan``) at the presets' widths.

Net 2 -> 40x3 -> 1 at ragged N_f 77 and N_u 13 (inputs from numpy with a
seed). Tolerances: float64 to 1e-10 relative (the same sums in other
orders); float32 against JAX rtol 1e-4 and atol 1e-5 max|g| per leaf, as
``tests/test_torch_train.py`` holds the plain loss.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.losses.admm import ADMMState as JADMM
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import NARROW, numpy_params, numpy_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
NET = (2, 40, 40, 40, 1)
WIDE = (2,) + (200,) * 8 + (1,)
N_F, N_U = 77, 13
LAM1, LAM2, RHO = 1.0, 0.01 / math.pi, 10.0
KINDS = [("admm", False), ("admm", True), ("mean_sq", False), ("l2_sq_norm", False),
         ("l1_sq_norm", False)]
KIND_IDS = ["admm", "admm-explicit", "mean_sq", "l2_sq_norm", "l1_sq_norm"]


def _updates(kind, explicit_inner):
    return {"model.layers": NET, "sampling.n_f": N_F, "data.n_u": N_U, "pde.lambda2": LAM2,
            "optimizer.kind": "adam", "loss.residual_kind": kind,
            "loss.explicit_inner": explicit_inner}


def _port_problem(kind, explicit_inner, dtype):
    exp = override(get_preset("abgrall_admm"),
                   dict(_updates(kind, explicit_inner), **{"model.dtype": dtype}))
    return ttrainer.build_problem(exp, "cpu", dataset=GRID)


def _inputs(seed=51):
    rng = np.random.default_rng(seed)
    return {"net": numpy_params(NET, seed), "colloc": numpy_points(N_F, seed + 1),
            "z": (0.1 * rng.standard_normal((N_F, 1))).astype(np.float32),
            "dual": (1.0 + 0.1 * rng.standard_normal((N_F, 1))).astype(np.float32)}


def _wide(tp, inp, kind, explicit_inner, dt):
    net = [{k: torch.tensor(v, dtype=dt) for k, v in layer.items()} for layer in inp["net"]]
    t = lambda a: torch.tensor(a, dtype=dt)  # noqa: E731
    z, dual = (t(inp["z"]), t(inp["dual"])) if kind == "admm" else (None, None)
    args = (tp.spec, net, tp.x_data, tp.targets["u"], t(inp["colloc"]), z, dual)
    cfg = dict(kind=kind, lam1=LAM1, lam2=LAM2, rho=RHO, explicit_inner=explicit_inner)
    return net, args, cfg


@pytest.mark.parametrize("kind,explicit_inner", KINDS, ids=KIND_IDS)
def test_wide_algorithm_matches_the_reverse_mode_and_autograd_in_f64(kind, explicit_inner):
    tp = _port_problem(kind, explicit_inner, "float64")
    assert k_fused.design(tp.spec.layers) == "wide"
    inp = _inputs()
    net, args, cfg = _wide(tp, inp, kind, explicit_inner, torch.float64)
    got = k_fused.wide_loss_and_grad_reference(*args, **cfg)
    ref = k_fused.loss_and_grad_reference(*args, **cfg)
    params = {"net": [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in net],
              "coeffs": {"lambda1": torch.full((1,), LAM1, dtype=torch.float64),
                         "lambda2": torch.full((1,), LAM2, dtype=torch.float64)}}
    leaves = [t for layer in params["net"] for t in (layer["W"], layer["b"])]
    admm = ADMMState(z=args[5], dual=args[6]) if kind == "admm" else None
    loss, aux = ttrainer.make_loss_fn(tp)(params, args[4], admm)
    auto = torch.autograd.grad(loss, leaves)
    for name, a, b, c in zip(("loss", "data_term", "res_term"), got[:3], ref[:3],
                             (loss, aux["data_term"], aux["res_term"])):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-10, err_msg=name)
        np.testing.assert_allclose(float(a), float(c.detach()), rtol=1e-10, err_msg=name)
    for i, (g, r, w) in enumerate(zip(got[3], ref[3], auto)):
        assert g.shape == w.shape and g.dtype == torch.float64
        for want, what in ((r, "reverse mode"), (w, "autograd")):
            scale = float(want.abs().max())
            np.testing.assert_allclose(g.numpy(), want.detach().numpy(), rtol=1e-10,
                                       atol=1e-10 * scale, err_msg=f"leaf {i} vs {what}")


@pytest.mark.parametrize("kind,explicit_inner", KINDS, ids=KIND_IDS)
def test_wide_algorithm_matches_jax_in_f32(kind, explicit_inner):
    tp = _port_problem(kind, explicit_inner, "float32")
    inp = _inputs()
    _, args, cfg = _wide(tp, inp, kind, explicit_inner, torch.float32)
    loss, data_term, res_term, grads = k_fused.wide_loss_and_grad_reference(*args, **cfg)

    exp = joverride(JPRESETS["abgrall_admm"], _updates(kind, explicit_inner))
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    np.testing.assert_array_equal(x_data, tp.x_data.numpy())
    jp = jtrainer.Problem(exp=exp, dataset=ds, spec=JSpec(layers=NET, lb=tuple(map(float, ds.lb)),
                                                          ub=tuple(map(float, ds.ub))),
                          x_data=jnp.asarray(x_data),
                          targets={k: jnp.asarray(v) for k, v in targets.items()})
    jparams = {"net": [{k: jnp.asarray(v) for k, v in layer.items()} for layer in inp["net"]],
               "coeffs": {"lambda1": jnp.full((1,), LAM1, jnp.float32),
                          "lambda2": jnp.full((1,), LAM2, jnp.float32)}}
    jadmm = JADMM(z=jnp.asarray(inp["z"]), dual=jnp.asarray(inp["dual"])) \
        if kind == "admm" else None
    (jloss, jaux), jgrad = jax.value_and_grad(jtrainer.make_loss_fn(jp), has_aux=True)(
        jparams, jnp.asarray(inp["colloc"]), jadmm, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(data_term), float(jaux["data_term"]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(res_term), float(jaux["res_term"]), rtol=1e-4, atol=1e-7)
    jflat = [jgrad["net"][i][k] for i in range(len(NET) - 1) for k in ("W", "b")]
    for i, (g, w) in enumerate(zip(grads, jflat)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


def test_step_plan_at_the_presets_widths():
    """abgrall_l1/l2/visc's 8x200 at N_f 1,000 and N_u 100 takes the wide
    design on 32 x 32 tiles that give a product 1,008 blocks; 8x20 keeps the
    narrow design and its launch configuration."""
    for name in ("abgrall_l1", "abgrall_l2", "abgrall_visc"):
        exp = get_preset(name)
        assert exp.model.layers == WIDE
        assert k_fused.step_plan(WIDE, exp.sampling.n_f, exp.data.n_u) \
            == k_fused.step_plan(WIDE, 1_000, 100)
    plan = k_fused.step_plan(WIDE, 1_000, 100)
    assert (plan.design, plan.tile, plan.nf_pad, plan.nu_pad) == ("wide", 32, 1_024, 128)
    assert (plan.split_rows, plan.splits, plan.rows) == (128, 36, 4_608)
    assert plan.scratch_bytes == 83_000_992  # 29.5 MB of it the hidden layers' P
    assert plan.pstore == 4_608 * 1_600 and plan.partials == 10_159_236
    assert k_fused.product_blocks(plan, WIDE) == 144 * 7 >= 132
    # the widest dW takes 49 tiles a split
    assert 49 * plan.splits >= k_fused.SPLIT_BLOCKS
    assert plan.rows * 204 < 2 ** 31 and plan.splits < 65_536  # the kernel's 32-bit offsets
    narrow = k_fused.step_plan(NARROW, 1_000, 100)
    assert narrow.design == "narrow"
    assert (narrow.tile, narrow.tail_tile) == k_fused.launch_config(NARROW) == (8, 7)
    # 125 collocation and 13 data tiles, 143 tail tiles: both fill the 132 SMs
    assert (narrow.blocks, narrow.tail_blocks) == (138, 143)
    # shared memory a block: the params, 19 (2) planes of 20 x (8 + 1)
    # (7 + 1) float4, the tile's loss terms
    assert (narrow.smem, narrow.tail_smem) == (66_848, 17_248)
    # a member's scratch (PERF.md): 138 rows of 3,021 + 1 floats, 143 floats
    assert (narrow.partials, narrow.tail_part) == (138 * 3_022, 143)
    assert narrow.scratch_floats == 417_179
    assert k_fused.step_plan(get_preset("abgrall_admm").model.layers, 1_000, 100).design == "narrow"


NARROW_NETS = [NARROW, (2, 16, 16, 16, 1), (2,) + (32,) * 16 + (1,), (2,) + (32,) * 17 + (1,),
               (2,) + (32,) * 31 + (1,)]


@pytest.mark.parametrize("layers", NARROW_NETS,
                         ids=["8x20", "3x16", "16x32", "17x32", "31x32"])
def test_narrow_tiles_fit_a_block(layers):
    """A narrow block runs one thread a (point, unit) of a layer and keeps the
    params and every layer's streams in shared memory: its tile is the
    first of 8, 4, 2 points whose block fits 227 KB, the tail's always 7;
    the 8x20 nets and every net of up to 17 layers of width 32 keep 8 points
    (18 layers take 4, 32 layers 2), and every narrow net's tail block fits."""
    tile, tail_tile = k_fused.launch_config(layers)
    assert tile in k_fused.NARROW_TILES and tail_tile == k_fused.TAIL_TILE == 7
    for t, planes in ((tile, 2 * (len(layers) - 1) + 1), (tail_tile, 2)):
        assert t * max(layers) <= k_fused.NARROW_THREADS
        assert k_fused.narrow_smem(layers, t, planes) <= 227 * 1024
    if tile < k_fused.NARROW_TILES[0]:
        assert k_fused.narrow_smem(layers, 2 * tile, 2 * (len(layers) - 1) + 1) > 227 * 1024
    assert tile == {18: 4, 32: 2}.get(len(layers) - 1, 8)


@pytest.mark.parametrize("n_f,n_u", [(1, 1), (77, 13), (1_000, 100), (4_000, 100)])
def test_narrow_plan_fills_the_card(n_f, n_u):
    """The narrow plan at abgrall_admm's 8x20: a tile for every 8 points,
    collocation tiles then data tiles, so that a solo grad launch and its
    tail launch each run at least 132 blocks from N_f 1,000 on; the plan, and
    so each member's scratch and arithmetic, does not depend on the member
    count (K8's member m equals a solo call bit for bit)."""
    plan = k_fused.step_plan(NARROW, n_f, n_u)
    assert (plan.tile, plan.tail_tile) == (8, 7)
    assert plan.blocks == math.ceil(n_f / plan.tile) + math.ceil(n_u / plan.tile)
    assert plan.tail_blocks == math.ceil(n_f / plan.tail_tile)
    if n_f >= 1_000:
        assert plan.blocks >= 132 and plan.tail_blocks >= 132
    assert plan.smem <= 227 * 1024 and plan.tail_smem <= 227 * 1024
    spec = MLPSpec(layers=NARROW, lb=(-1.0, 0.0), ub=(1.0, 0.99))
    one = k_fused._scratch(plan, spec, 1, "cpu")
    for members in (3, 32):
        many = k_fused._scratch(plan, spec, members, "cpu")
        assert one["scratch"] is None and many["scratch"] is None
        for name in ("partials", "tail_partials"):
            assert many[name].shape == (members,) + one[name].shape[1:]
    assert one["partials"].shape == (1, plan.blocks, spec.n_params + 1)
    assert one["partials"][0].numel() == plan.partials
    assert one["tail_partials"][0].numel() == plan.tail_part


@pytest.mark.parametrize("n_f,n_u", [(1, 1), (77, 13), (1_000, 100), (4_000, 100),
                                     (16_384, 100), (65_536, 1_000)])
def test_step_plan_splits_never_straddle_the_segments(n_f, n_u):
    """dW's split chunks cover the stacked rows exactly, every chunk lies in
    one segment (collocation or data), every N takes the 32 x 32 tile, and
    from the presets' 1,000 points on a product fills the card's 132 SMs."""
    plan = k_fused.step_plan(WIDE, n_f, n_u)
    assert plan.nf_pad >= n_f and plan.nu_pad >= n_u
    assert plan.nf_pad % k_fused.EW_TILE == 0 and plan.nu_pad % k_fused.EW_TILE == 0
    assert (4 * plan.nf_pad) % plan.split_rows == 0 and plan.split_rows in k_fused.SPLIT_ROWS
    assert plan.splits * plan.split_rows >= plan.rows > (plan.splits - 1) * plan.split_rows
    assert plan.tile == k_fused.TILE == 32
    assert k_fused.product_blocks(plan, WIDE) >= (132 if n_f >= 1_000 else 1)
