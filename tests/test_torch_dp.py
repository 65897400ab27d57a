"""Port parity for collocation data parallelism (slice 6,
``pinns_tpu_torch.parallel.sharding``), on the CPU over gloo with 2 and 4
ranks, one process each (``tests/torch_dp_worker.py``; every spawn has a
timeout):

- the port's data-parallel Adam step on D ranks against JAX's sharded step
  (``shard_trainer`` + ``place_state`` on JAX's 8-device CPU mesh) from the
  same params (JAX's, converted with ``interop``), each step fed JAX's next
  batch, for 'admm' and 'l1_sq_norm'. Tolerance: JAX's own sharded-vs-
  unsharded limits (``tests/test_parallel.py:50-74``): rtol 2e-4 on the loss
  (atol 1e-6), rtol 5e-4 / atol 1e-5 on the weights;
- the union of the ranks' batches (the initial draw, later draws, a fixed
  set) equal to the one-process batch bit for bit, and the row offset of
  ``philox_uniform`` and of K11's plain version;
- a non-divisible ``n_f`` raising JAX's ``ValueError``, and the features
  left to a later slice refusing by name;
- whole runs: the ranks' losses equal exactly, through the hybrid schedule's
  L-BFGS phase and through ``burgers_scale``'s microbatches, and within 1e-5
  of the one-process run at the end of the Adam phase; ``train --mesh-data
  2 --device cpu`` under ``python -m torch.distributed.run`` through the
  whole schedule of abgrall_admm (L-BFGS phase included) and of a cut
  burgers_scale, both ranks printing the same loss;
- a data-parallel checkpoint (whole, written by rank 0) resumed on 2 ranks
  bit-equal to the uninterrupted run, and on 1 rank within the Adam
  tolerance of it;
- K3's data-parallel modes in plain PyTorch (``dp_reduce_reference``,
  ``dp_apply_reference``): the ranks' summed sums give the one-card
  gradient (rtol 1e-5 of max|g|) and loss (rtol 1e-5).

Tiny abgrall_admm runs (net 2 -> 8x2 -> 1, N_f 64, N_u 16) on the committed
TwoSin grid, native data only.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.parallel.mesh import make_mesh as jmake_mesh
from pinns_tpu.parallel.sharding import place_state as jplace_state
from pinns_tpu.parallel.sharding import shard_trainer as jshard_trainer
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch.config import override
from pinns_tpu_torch.data.sampling import philox_uniform
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import train_state_from_jax
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.ops.kernels.sampling import philox_draw_reference
from pinns_tpu_torch.ops.kernels.taylor2 import pack_params
from pinns_tpu_torch.parallel import mesh as tmesh
from pinns_tpu_torch.parallel import sharding
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import schedule
from pinns_tpu_torch.train import trainer as ttrainer
from torch_dp_worker import GRID, REPO, free_port, rank_env, spawn

UPDATES = {"model.layers": (2, 8, 8, 1), "sampling.n_f": 64, "data.n_u": 16,
           "optimizer.kind": "adam", "train.log_every": 0}
N_STEPS = 3
HYBRID = {"optimizer.kind": "hybrid", "optimizer.switch_epoch": 30, "train.epochs": 34,
          "train.chunk": 10, "optimizer.lbfgs.max_iters": 15}


def _updates(kind: str, **extra) -> dict:
    return dict(UPDATES, **{"loss.residual_kind": kind}, **extra)


def _jax_trainer(updates):
    exp = joverride(JPRESETS["abgrall_admm"], updates)
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    problem = jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                               targets={k: jnp.asarray(v) for k, v in targets.items()})
    return jtrainer.Trainer(exp, problem=problem)


def _jax_tree(state) -> dict:
    adam = state.opt_state[0]
    out = {"params": jax.device_get(state.params), "count": np.asarray(adam.count),
           "mu": jax.device_get(adam.mu), "nu": jax.device_get(adam.nu),
           "colloc": np.asarray(state.colloc), "epoch": np.asarray(state.epoch), "key": 5}
    if state.admm is not None:
        out["z"], out["dual"] = np.asarray(state.admm.z), np.asarray(state.admm.dual)
    return out


def _flat_net(net) -> np.ndarray:
    return np.concatenate([np.asarray(a).ravel() for layer in net for a in layer.values()])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's sharded step on the 8-device mesh, N_STEPS steps for each kind:
    the initial state as a port checkpoint, the batches JAX draws, its
    metrics and its final weights."""
    root = tmp_path_factory.mktemp("jax_dp")
    runs = {}
    for kind in ("admm", "l1_sq_norm"):
        jt = _jax_trainer(_updates(kind))
        mesh = jmake_mesh()
        jshard_trainer(jt, mesh)
        state = jplace_state(jt.init_state(), mesh)
        ckpt = str(root / f"{kind}.ckpt")
        ckpt_io.save_checkpoint(ckpt, train_state_from_jax(_jax_tree(state), torch.device("cpu")))
        step = jax.jit(jt._adam_step)
        feed, metrics = [], []
        for _ in range(N_STEPS):
            state, m = step(state)
            feed.append(np.asarray(state.colloc))
            metrics.append({k: float(v) for k, v in m.items()})
        np.save(str(root / f"{kind}_feed.npy"), np.stack(feed))
        runs[kind] = {"ckpt": ckpt, "feed": str(root / f"{kind}_feed.npy"), "metrics": metrics,
                      "params": _flat_net(jax.device_get(state.params["net"])),
                      "sharded": len(state.colloc.sharding.device_set)}
    return runs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["admm", "l1_sq_norm"])
def test_dp_step_matches_jax_sharded_step(jax_runs, tmp_path, kind, world):
    """The port's step on `world` ranks from JAX's state, fed JAX's batches:
    every metric within JAX's sharded-step tolerance, the weights too, the
    ranks' metrics equal, and one flat all-reduce of the gradients a step
    (plus 'l1_sq_norm''s S and 'admm''s misfit)."""
    run = jax_runs[kind]
    assert run["sharded"] == 8
    args = {"out": str(tmp_path / "steps"), "ckpt": run["ckpt"], "feed": run["feed"],
            "n_steps": N_STEPS, "updates": _updates(kind)}
    results = spawn("steps", args, world)
    for _, info in results[1:]:
        assert info["metrics"] == results[0][1]["metrics"]
    got = results[0][1]["metrics"]
    for k in range(N_STEPS):
        for name in ("loss", "data_term", "res_term", "admm_misfit"):
            np.testing.assert_allclose(got[k][name], run["metrics"][k][name], rtol=2e-4,
                                       atol=1e-6, err_msg=f"step {k} {name}")
    np.testing.assert_allclose(results[0][0]["params"], run["params"], rtol=5e-4, atol=1e-5)
    assert results[0][1]["counts"] == {"all_reduce": 2 * N_STEPS}


def _draws_one_process(problem, key=1234):
    return {f"draw{d}": ttrainer._resample(problem, key, d).numpy() for d in range(4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("strategy", ["resample_uniform", "fixed_lhs"])
def test_union_of_rank_draws_is_the_one_card_batch(tmp_path, strategy, world):
    """Each rank draws its rows of the batch at its row offset: the ranks'
    rows, stacked in rank order, are the one-process batch bit for bit (the
    Philox draws and a fixed set alike)."""
    upd = dict(UPDATES, **{"sampling.strategy": strategy})
    results = spawn("draws", {"out": str(tmp_path / "draws"), "updates": upd}, world)
    exp = override(get_preset("abgrall_admm"), upd)
    problem = ttrainer.build_problem(exp, "cpu", dataset=GRID)
    want = _draws_one_process(problem)
    want["init"] = ttrainer.init_collocation(problem, 1234).numpy()
    for name, w in want.items():
        got = np.concatenate([arrays[name] for arrays, _ in results])
        np.testing.assert_array_equal(got, w, err_msg=name)


def test_philox_row_offset():
    """philox_uniform and K11's plain version at a row offset give those rows
    of the whole draw, bit for bit."""
    whole = philox_uniform(99, 7, 1000, (-1.0, 0.0), (1.0, 0.99))
    for row0, n in ((0, 250), (250, 250), (999, 1), (400, 600)):
        torch.testing.assert_close(philox_uniform(99, 7, n, (-1.0, 0.0), (1.0, 0.99), row0=row0),
                                   whole[row0:row0 + n], rtol=0, atol=0)
    rows = schedule.schedule_rows(99, 0, 6, 1, 0.0, lambda e: ((-1.0, 0.0), (1.0, 0.99)))
    sched, cursor = schedule.to_device(rows, torch.device("cpu")), torch.zeros(1, dtype=torch.int64)
    torch.testing.assert_close(philox_draw_reference(sched, cursor, 300, torch.float32, 500),
                               whole[500:800], rtol=0, atol=0)
    with pytest.raises(ValueError, match="32-bit counter"):
        philox_uniform(99, 7, 10, (-1.0, 0.0), (1.0, 0.99), row0=-1)


def test_non_divisible_n_f_raises_as_jax():
    """shard_trainer refuses a data axis that does not divide n_f, with
    JAX's message (a layout-only mesh: no process group)."""
    exp = override(get_preset("abgrall_admm"), dict(UPDATES, **{"sampling.n_f": 100}))
    tr = ttrainer.Trainer(exp, device="cpu", dataset=GRID)
    with pytest.raises(ValueError) as terr:
        sharding.shard_trainer(tr, tmesh.make_mesh(data=8, ranks=range(8)))
    jt = _jax_trainer(dict(UPDATES, **{"sampling.n_f": 100}))
    with pytest.raises(ValueError) as jerr:
        jshard_trainer(jt, jmake_mesh())
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.DataShard(rank=0, size=3).rows(64)


@pytest.mark.parametrize("feature,updates", [
    ("causal", {"loss.causal_eps": 1.0, "loss.residual_kind": "mean_sq"}),
    ("rad", {"sampling.strategy": "rad"}),
])
def test_later_dp_features_refuse_by_name(feature, updates):
    """check_slice takes data parallelism itself; the two features whose
    sums are not split yet refuse by name, naming slice 6b."""
    base = override(get_preset("abgrall_admm"), UPDATES)
    ttrainer.check_slice(override(base, {"mesh.data_parallel": 2}))
    exp = override(base, dict(updates, **{"mesh.data_parallel": 2}))
    with pytest.raises(NotImplementedError, match="slice 6b") as err:
        ttrainer.check_slice(exp)
    assert {"causal": "causal", "rad": "RAD"}[feature] in str(err.value)
    ttrainer.check_slice(override(base, updates))  # without the mesh: inside the port


def test_dp_trajectory_equals_one_process_in_float64(tmp_path):
    """A whole data-parallel run in float64 (burgers_forward's recipe, cut:
    a fixed LHS batch, mean_sq, the cosine lr; 300 epochs) on 2 ranks tracks
    the one-process run to 1e-10 (measured 1.4e-12): the data-parallel loss
    and gradient are the one-process ones up to rounding, so the float32
    runs' drift apart (8e-4 on the params after 300 epochs on the CPU, a 2%
    u rel-L2 gap on the card early in training) is float32's order of sums
    amplified by the trajectory, not a different function."""
    upd = {"train.epochs": 300, "train.chunk": 100, "train.log_every": 0,
           "sampling.strategy": "fixed_lhs", "sampling.n_f": 2000, "model.dtype": "float64"}
    results = spawn("train", {"out": str(tmp_path / "f64"), "updates": upd,
                              "preset": "burgers_forward"}, 2, timeout=400)
    assert results[0][1]["summary"]["loss"] == results[1][1]["summary"]["loss"]
    tr = ttrainer.Trainer(override(get_preset("burgers_forward"), upd), device="cpu",
                          dataset=GRID)
    state, summary = tr.train()
    wp = np.concatenate([t.detach().numpy().ravel() for layer in state.params["net"]
                         for t in layer.values()])
    np.testing.assert_allclose(results[0][0]["params"], wp, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(results[0][1]["summary"]["rel_l2_u"], summary["rel_l2_u"],
                               rtol=1e-10)


@pytest.mark.parametrize("case", ["hybrid", "burgers_scale"])
def test_dp_training_ranks_agree(tmp_path, case):
    """Trainer.train on 2 ranks: the ranks' losses equal exactly, the
    gathered batch equals the one-process run's bit for bit, the loss within
    1e-5 of it (the hybrid run through its L-BFGS phase: the objective's
    value and gradient all-reduced, every rank's decisions the same), and
    every epoch all-reduces."""
    if case == "hybrid":
        preset, upd = "abgrall_admm", dict(UPDATES, **HYBRID)
    else:
        preset, upd = "burgers_scale", {"sampling.n_f": 1024, "sampling.microbatch": 4,
                                        "model.layers": (2, 16, 16, 1), "train.epochs": 4,
                                        "train.chunk": 2, "train.log_every": 0}
    results = spawn("train", {"out": str(tmp_path / "t"), "updates": upd, "preset": preset}, 2)
    losses = [info["summary"]["loss"] for _, info in results]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert results[0][1]["counts"]["all_reduce"] >= upd["train.epochs"]
    exp = override(get_preset(preset), upd)
    if case == "hybrid":  # the Adam phase alone, held to the one-process run
        exp = override(exp, {"train.epochs": HYBRID["optimizer.switch_epoch"]})
        adam = spawn("train", {"out": str(tmp_path / "a"), "preset": preset,
                               "updates": dict(upd, **{"train.epochs": 30})}, 2)
    else:
        adam = results
    tr = ttrainer.Trainer(exp, device="cpu", dataset=GRID)
    state, summary = tr.train()
    np.testing.assert_array_equal(adam[0][0]["colloc"], state.colloc.numpy())
    np.testing.assert_allclose(adam[0][1]["summary"]["rel_l2_u"], summary["rel_l2_u"],
                               rtol=1e-5)
    gp = adam[0][0]["params"]
    wp = np.concatenate([t.detach().numpy().ravel() for layer in state.params["net"]
                         for t in layer.values()])
    np.testing.assert_allclose(gp, wp, rtol=5e-4, atol=1e-5)


CLI_CASES = {
    # the hybrid schedule: 30 Adam epochs, then 4 L-BFGS outer epochs
    "abgrall_admm": (GRID, 34, ["model.layers=(2,8,8,1)", "sampling.n_f=64", "data.n_u=16",
                                "optimizer.switch_epoch=30", "optimizer.lbfgs.max_iters=15"]),
    # the scale preset cut to 1,024 points in 4 microbatches a rank
    "burgers_scale": (os.path.join(REPO, "tests", "fixtures", "torch_port", "burgers_shock.npz"),
                      6, ["model.layers=(2,16,16,1)", "sampling.n_f=2048",
                          "sampling.microbatch=4"]),
}


@pytest.mark.parametrize("preset", sorted(CLI_CASES))
def test_cli_mesh_data_two_ranks(tmp_path, preset):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    pinns_tpu_torch train --mesh-data 2 --device cpu`` through the preset's
    whole schedule (abgrall_admm's L-BFGS phase included): both ranks print
    a summary line with the same loss, rank 0's with the evaluation, and
    rank 0 writes the whole final checkpoint."""
    grid, epochs, sets = CLI_CASES[preset]
    port = free_port()
    env = rank_env(0, 1, port)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(port), "-m", "pinns_tpu_torch", "train",
           "--preset", preset, "--mesh-data", "2", "--device", "cpu", "--data", grid,
           "--out-dir", str(tmp_path), "--epochs", str(epochs), "--chunk", "10"]
    for kv in sets:
        cmd += ["--set", kv]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    by_rank = {ln["rank"]: ln for ln in lines}
    assert sorted(by_rank) == [0, 1]
    assert by_rank[0]["loss"] == by_rank[1]["loss"] and np.isfinite(by_rank[0]["loss"])
    assert "rel_l2_u" in by_rank[0] and "rel_l2_u" not in by_rank[1]
    assert by_rank[0]["epochs"] == epochs
    state = ckpt_io.load_checkpoint(str(tmp_path / f"{preset}_final.ckpt"), "cpu")
    n_f = 64 if preset == "abgrall_admm" else 2048
    assert state.colloc.shape == (n_f, 2) and state.epoch == epochs


def test_dp_checkpoint_resumes_on_two_and_one_ranks(tmp_path):
    """A 2-rank run writes whole checkpoints (rank 0, the rows gathered):
    resumed from its epoch-20 checkpoint on 2 ranks it ends bit-equal to the
    uninterrupted run; on 1 rank (the one-card trainer) within the Adam
    tolerance of it."""
    upd = dict(UPDATES, **{"train.epochs": 40, "train.chunk": 10,
                           "train.checkpoint_every": 20, "train.out_dir": str(tmp_path)})
    full = spawn("train", {"out": str(tmp_path / "full"), "updates": upd}, 2)
    ckpt = str(tmp_path / "abgrall_admm_e20.ckpt")
    whole = ckpt_io.load_checkpoint(ckpt, "cpu")
    assert whole.colloc.shape == (64, 2) and whole.epoch == 20
    res2 = spawn("train", {"out": str(tmp_path / "res2"), "resume": ckpt,
                           "updates": dict(upd, **{"train.out_dir": str(tmp_path / "r2")})}, 2)
    for key in ("params", "colloc", "z", "dual", "mu", "nu"):
        np.testing.assert_array_equal(res2[0][0][key], full[0][0][key], err_msg=key)
    exp = override(get_preset("abgrall_admm"), dict(upd, **{"train.out_dir": ""}))
    tr = ttrainer.Trainer(exp, device="cpu", dataset=GRID)
    state, _ = tr.train(tr.load_checkpoint(ckpt))
    np.testing.assert_array_equal(state.colloc.numpy(), full[0][0]["colloc"])
    wp = np.concatenate([t.detach().numpy().ravel() for layer in state.params["net"]
                         for t in layer.values()])
    np.testing.assert_allclose(full[0][0]["params"], wp, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["admm", "l1_sq_norm", "mean_sq"])
def test_dp_mode_plain_versions_sum_to_the_one_card_step(kind):
    """K3's reduce mode in plain PyTorch over two ranks' rows (the data
    term on the first), summed, then the apply mode: the gradient of the
    one-card algorithm (loss_and_grad_reference) within rtol 1e-5 of max|g|
    and its loss terms within rtol 1e-5, and so do the value-and-grad
    mode's reduce and apply (K10's evaluation under data parallelism)."""
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.opt.adam import bias_corrections

    spec = MLPSpec(layers=(2, 8, 8, 1), lb=(-1.0, 0.0), ub=(1.0, 1.0))
    net = init_mlp(spec, torch.Generator().manual_seed(3), "cpu")
    params = pack_params(net)
    rng = np.random.default_rng(4)
    colloc = torch.from_numpy(rng.uniform((-1, 0), (1, 1), (64, 2)).astype(np.float32))
    x_data = torch.from_numpy(rng.uniform((-1, 0), (1, 1), (16, 2)).astype(np.float32))
    u_data = torch.sin(3.0 * x_data[:, :1])
    z = torch.from_numpy((0.1 * rng.standard_normal((64, 1))).astype(np.float32))
    dual = torch.ones_like(z)
    admm = kind == "admm"
    cfg = dict(kind=kind, lam1=1.0, lam2=0.01, rho=10.0)
    parts = [k_fused.dp_reduce_reference(spec, params, x_data, u_data, colloc[rows],
                                         z[rows] if admm else None, dual[rows] if admm else None,
                                         n_f_all=64, data_tiles=r == 0, **cfg)
             for r, rows in enumerate((slice(0, 32), slice(32, 64)))]
    sums = torch.cat([parts[0] + parts[1], torch.zeros(1, dtype=torch.float64)])
    loss, data_term, res_term, grads = k_fused.loss_and_grad_reference(
        spec, net, x_data, u_data, colloc, z if admm else None, dual if admm else None, **cfg)
    want = torch.cat([g.reshape(-1) for g in grads])
    bc1, bc2 = bias_corrections(0)
    mu, nu = torch.zeros_like(params), torch.zeros_like(params)
    new, m, v, metrics = k_fused.dp_apply_reference(sums, params, mu, nu, kind=kind, lr=1e-3,
                                                    bc1=bc1, bc2=bc2, n_u=16, n_f_all=64,
                                                    lam1=1.0, lam2=0.01)
    g = m / torch.tensor(1.0 - 0.9, dtype=torch.float32)  # Adam's first moment from zero
    torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(float(metrics[5]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics[1]), float(data_term), rtol=1e-5)
    np.testing.assert_allclose(float(metrics[6]), float(res_term), rtol=1e-5)
    assert torch.isfinite(new).all() and torch.isfinite(v).all()
    assert float(k_fused.dp_finalize_reference(torch.tensor(6.4, dtype=torch.float64), 64)) \
        == pytest.approx(0.1)
    # the value-and-grad mode's split (K10's evaluation under data
    # parallelism): the ranks' reduce calls summed, then apply
    vsums = torch.zeros(2 * spec.n_params + 3, dtype=torch.float64)
    total = torch.zeros_like(vsums)
    grad, loss_out = torch.zeros_like(params), torch.zeros(1)
    for r, rows in enumerate((slice(0, 32), slice(32, 64))):
        k_fused.fused_value_and_grad(
            spec, params, grad, loss_out, x_data, u_data, colloc[rows],
            z[rows] if admm else None, dual[rows] if admm else None, explicit_inner=False,
            dp={"mode": "reduce", "sums": vsums, "n_f_all": 64, "row0": rows.start,
                "data_tiles": int(r == 0)}, **cfg)
        total += vsums
    k_fused.fused_value_and_grad(
        spec, params, grad, loss_out, x_data, u_data, colloc[:32], z[:32] if admm else None,
        dual[:32] if admm else None, explicit_inner=False,
        dp={"mode": "apply", "sums": total, "n_f_all": 64, "row0": 0, "data_tiles": 1}, **cfg)
    torch.testing.assert_close(grad, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(float(loss_out[0]), float(loss), rtol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_fused._epoch(spec, 1, params[None], mu[None], nu[None], 0, x_data, u_data,
                       colloc[None], z[None] if admm else None, dual[None] if admm else None,
                       rho=10.0, seed=1, epoch=1, lr=1e-3, explicit_inner=False,
                       kind=kind, lam1=1.0, lam2=0.01,
                       dp={"mode": "reduce", "sums": torch.zeros(2 * spec.n_params + 3,
                                                                 dtype=torch.float64),
                           "n_f_all": 64, "row0": 0, "data_tiles": 1})
