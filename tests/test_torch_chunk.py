"""K9 on the CPU: the chunk of the port's trainer (``train.trainer.make_chunked``,
the port of JAX's ``make_chunked``) and the host half of its graphed runner
(``ops.kernels.fused_step``: the chunk's schedule, the replay plan, the
hand-back of the state).

On the CPU ``make_chunked`` is the per-epoch loop (``run_chunk``) and builds no
CUDA graph; on the card the fused step's chunk replays captured graphs, held
against the per-epoch loop bit for bit by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``. Here the schedule rows must equal the per-epoch step's
words bit for bit (the graphed chunk's epochs read them), the replay plan
must run every epoch once, and the CPU chunk must equal the per-epoch loop
bit for bit and stay within ``test_plain_steps_track_jax``'s tolerance of
JAX's states (the committed fixture ``abgrall_admm_steps.npz``: 5 JAX steps
of abgrall_admm at 8x20, N_f 1,000, each fed JAX's next batch).
"""

import math
import os

import numpy as np
import pytest
import torch

from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.ops.kernels import fused_step as k_fused
from pinns_tpu_torch.opt.adam import AdamState, bias_corrections
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import numpy_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
STEPS = os.path.join(REPO, "tests", "fixtures", "torch_port", "abgrall_admm_steps.npz")
TINY = (2, 20, 20, 1)


@pytest.mark.parametrize("count", [0, 1, 9_999, 199_999])
def test_schedule_rows_are_the_per_epoch_words(count):
    """Row i of a chunk's schedule holds what the per-epoch call passes by
    value for its i-th epoch: the Philox epoch's two words, Adam's bias
    corrections at count + i as the float32 the call rounds them to."""
    epoch = count + (2**32 - 3 if count == 199_999 else 0)  # a high word too
    length = 7
    tab = k_fused.chunk_schedule(count, epoch, length)
    assert tab.shape == (length, 4) and tab.dtype == np.int32
    words = tab.view(np.uint32)
    for i in range(length):
        e = epoch + 1 + i
        assert (int(words[i, 0]), int(words[i, 1])) == (e & 0xFFFFFFFF, e >> 32)
        bc1, bc2 = bias_corrections(count + i)
        assert words[i, 2] == np.float32(bc1).view(np.uint32)
        assert words[i, 3] == np.float32(bc2).view(np.uint32)
        assert words[i, 2:].view(np.float32).tolist() == [float(np.float32(bc1)),
                                                          float(np.float32(bc2))]


@pytest.mark.parametrize("length", [1, 2, 7, 1_000])
def test_replay_plan_runs_every_epoch_once(length):
    """The replays of a chunk run ``length`` epochs, each from the buffer the
    one before wrote, starting in A; the state ends in the buffer the
    runner hands back (B for an odd length)."""
    plan = k_fused.replay_plan(length)
    epochs = [e for name in plan for e in k_fused.GRAPH_EPOCH_BUFFERS[name]]
    assert len(epochs) == length
    assert epochs[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(epochs, epochs[1:]))
    assert all(src != dst for src, dst in epochs)
    assert epochs[-1][1] == length % 2
    assert plan.count("single") == length % 2 and plan[-1] == ("single" if length % 2 else "pair")


def _fixture():
    with np.load(STEPS, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _fixture_state(problem, fx):
    layers = problem.spec.layers
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    unpack = lambda name: k_fused.unpack_params(t(fx[name]), layers)  # noqa: E731
    coeffs = {n: torch.full((1,), float(fx[n])) for n in ("lambda1", "lambda2")}
    return ttrainer.TrainState(
        params={"net": unpack("params_0"), "coeffs": coeffs},
        opt_state=AdamState(count=int(fx["count_0"]), mu={"net": unpack("mu_0"), "coeffs": {
            k: torch.zeros_like(v) for k, v in coeffs.items()}}, nu={"net": unpack("nu_0"),
                                                                     "coeffs": {
            k: torch.zeros_like(v) for k, v in coeffs.items()}}),
        admm=ADMMState(z=t(fx["z_0"]), dual=t(fx["dual_0"])), colloc=t(fx["colloc_0"]),
        key=int(fx["seed"]), epoch=0, rho=None)


def _leaves(state):
    """The state's tensors, the nets flat (a member axis first when stacked)."""
    opt = state.opt_state
    flat = lambda net: k_fused.flat_net(net, sum(  # noqa: E731
        layer["W"].shape[-2] * layer["W"].shape[-1] + layer["b"].shape[-1] for layer in net))
    return {"params": flat(state.params["net"]), "mu": flat(opt.mu["net"]),
            "nu": flat(opt.nu["net"]), "colloc": state.colloc,
            "z": state.admm.z, "dual": state.admm.dual}


def test_cpu_chunk_equals_the_loop_and_tracks_jax():
    """abgrall_admm at 8x20 from the fixture's JAX state, 5 epochs fed JAX's
    batches: make_chunked equals run_chunk bit for bit on every tensor and
    metric, and the state after the chunk is within the plain step's
    tolerance of JAX's (test_plain_steps_track_jax; the dual's atol scaled by
    the terms its update cancels, as phase 8 of chip_smoke.py scales it)."""
    fx = _fixture()
    n = sum(k.startswith("metrics_") for k in fx)
    exp = get_preset("abgrall_admm")
    problem = ttrainer.build_problem(exp, "cpu")
    assert tuple(int(w) for w in fx["layers"]) == problem.spec.layers
    assert np.array_equal(problem.x_data.numpy(), fx["x_data"])
    assert np.array_equal(problem.targets["u"].numpy(), fx["u_data"])
    lr = exp.optimizer.learning_rate
    step = ttrainer.make_adam_step(problem, lr)
    feed = torch.from_numpy(np.stack([fx[f"colloc_{k + 1}"] for k in range(n)]))
    run = ttrainer.make_chunked(step, n)
    got, gm = run(_fixture_state(problem, fx), new_colloc=feed)
    want, wm = ttrainer.run_chunk(step, _fixture_state(problem, fx), n, new_colloc=feed)
    assert (got.epoch, got.opt_state.count) == (want.epoch, want.opt_state.count) == (n, n)
    for k, v in _leaves(want).items():
        assert torch.equal(_leaves(got)[k], v), k
    for k in ttrainer.METRIC_KEYS:
        assert gm[k].shape == (n,) and torch.equal(gm[k], wm[k]), k
    # against JAX: each step's metrics, then the state after the chunk
    for k in range(n):
        jm = dict(zip(ttrainer.METRIC_KEYS, fx[f"metrics_{k + 1}"]))
        for name, v in jm.items():
            np.testing.assert_allclose(float(gm[name][k]), float(v), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {k} {name}")
    leaves = {k: v.numpy() for k, v in _leaves(got).items()}
    np.testing.assert_array_equal(leaves["colloc"], fx[f"colloc_{n}"])
    diff = np.abs(leaves["params"].astype(np.float64) - fx[f"params_{n}"])
    assert diff.max() <= 2 * lr * n * (1 + 1e-3)
    assert np.mean(diff > 1e-6) <= 0.01, np.sort(diff)[-10:]
    for key in ("mu", "nu", "z", "dual"):
        w = fx[f"{key}_{n}"]
        # dual + rho (f - z) cancels terms of size rho max|z| (about 4 here,
        # for a dual near 1e-3): its rounding scales with them, as
        # chip_smoke.py's phase 8 holds it on this fixture
        scale = (np.abs(fx[f"dual_{n - 1}"]).max() + exp.loss.rho * np.abs(fx[f"z_{n}"]).max()
                 if key == "dual" else np.abs(w).max())
        np.testing.assert_allclose(leaves[key], w, rtol=1e-4, atol=1e-5 * scale, err_msg=key)


def _tiny_trainer(tmp_path=None, **extra):
    exp = override(get_preset("abgrall_admm"), {
        "model.layers": TINY, "sampling.n_f": 48, "data.n_u": 12,
        "pde.lambda2": 0.01 / math.pi, "optimizer.kind": "adam", "train.epochs": 6,
        "train.chunk": 3, "train.log_every": 3,
        "train.out_dir": str(tmp_path) if tmp_path is not None else "", **extra})
    return ttrainer.Trainer(exp, device="cpu", dataset=GRID)


def test_two_chunks_equal_one():
    """Two chunks of 3 epochs, each with its own Philox draws, end where one
    chunk of 6 does, bit for bit, metrics included."""
    trainer = _tiny_trainer()
    run = ttrainer.make_chunked(trainer._adam_step, 6)
    state = trainer.init_state()
    a, ma = run(state, 3)
    a, mb = run(a, 3)
    b, m = run(state, 6)
    assert (a.epoch, a.opt_state.count) == (b.epoch, b.opt_state.count) == (6, 6)
    for k, v in _leaves(b).items():
        assert torch.equal(_leaves(a)[k], v), k
    for k in ttrainer.METRIC_KEYS:
        assert torch.equal(torch.cat([ma[k], mb[k]]), m[k]), k


@pytest.mark.parametrize("stacked", [False, True], ids=["solo", "stacked"])
def test_returned_state_is_the_callers(stacked):
    """The graphed runner's hand-back: the state and metrics it returns are
    copies, so writing into them leaves the runner's buffers (which the next
    replay writes) as they were; Adam's count and the epoch move on by the
    chunk's length."""
    e, f, rows, length = (3 if stacked else 1), 48, 10, 4
    spec_layers = TINY
    p = sum(a * b + b for a, b in zip(spec_layers[:-1], spec_layers[1:]))
    rng = np.random.default_rng(0)
    r = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    final = {"params": r(e, p), "mu": r(e, p), "nu": r(e, p), "colloc": r(e, f, 2),
             "z": r(e, f, 1), "dual": r(e, f, 1)}
    metrics = r(rows, e, 7)
    saved = {k: v.clone() for k, v in final.items()}
    saved_metrics = metrics.clone()
    lead = (e,) if stacked else ()
    net = k_fused.unpack_params(torch.zeros(*lead, p), spec_layers)
    state = ttrainer.TrainState(
        params={"net": net}, opt_state=AdamState(count=5, mu={"net": net}, nu={"net": net}),
        admm=ADMMState(z=torch.zeros(*lead, f, 1), dual=torch.zeros(*lead, f, 1)),
        colloc=torch.zeros(*lead, f, 2), key=(1, 2, 3) if stacked else 1, epoch=7, rho=None)
    new, m = k_fused.hand_back(state, final, metrics, length, spec_layers, stacked)
    assert (new.epoch, new.opt_state.count) == (7 + length, 5 + length)
    assert m["loss"].shape == ((length, e) if stacked else (length,))
    assert torch.equal(m["loss"], metrics[:length, :, 5] if stacked else metrics[:length, 0, 5])
    got = _leaves(new)
    for k, v in got.items():
        want = saved[k] if stacked else saved[k][0]
        assert torch.equal(v.reshape(want.shape), want), k
        v.add_(1.0)
    for leaf in new.params["net"]:
        leaf["W"].mul_(2.0)
    for v in m.values():
        v.fill_(-1.0)
    assert all(torch.equal(final[k], saved[k]) for k in final)
    assert torch.equal(metrics, saved_metrics)


def test_cpu_trainer_builds_no_graph(tmp_path, monkeypatch):
    """A CPU trainer runs the per-epoch loop: it never constructs a CUDA
    graph, counts no replay, and its chunks log and checkpoint as before."""

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU trainer constructed torch.cuda.CUDAGraph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    before = (k_fused.GRAPH_REPLAYS, k_fused.GRAPH_EPOCHS, k_fused.LAUNCHES)
    trainer = _tiny_trainer(tmp_path)
    state, summary = trainer.train()
    assert state.epoch == 6 and math.isfinite(summary["rel_l2_u"])
    assert getattr(trainer._get_chunk("adam"), "runner", None) is None
    assert (k_fused.GRAPH_REPLAYS, k_fused.GRAPH_EPOCHS, k_fused.LAUNCHES) == before
    assert os.path.exists(tmp_path / "abgrall_admm_final.ckpt")


def test_graphed_runner_needs_the_card():
    """K9's runner refuses a CPU problem, and K8's a net of the wide design
    (its ensembles run the member loop)."""
    trainer = _tiny_trainer()
    with pytest.raises(ValueError, match="CUDA"):
        k_fused.FusedChunk(trainer.problem, 1e-3)
    wide = _tiny_trainer(**{"model.layers": (2, 40, 40, 1)})
    with pytest.raises(NotImplementedError, match="wide design"):
        k_fused.FusedChunk(wide.problem, 1e-3, n_members=2)


def test_chunk_feed_rows_match_the_loop():
    """make_chunked with given points at a length below its chunk (a hybrid
    schedule's clipped chunk) equals run_chunk fed the same rows."""
    trainer = _tiny_trainer()
    step = trainer._adam_step
    state = trainer.init_state()
    feed = torch.from_numpy(np.stack([numpy_points(48, seed=s) for s in range(4)]))
    got, gm = ttrainer.make_chunked(step, 6)(state, 4, new_colloc=feed)
    want, wm = ttrainer.run_chunk(step, state, 4, new_colloc=feed)
    assert torch.equal(got.colloc, feed[-1])
    for k, v in _leaves(want).items():
        assert torch.equal(_leaves(got)[k], v), k
    assert all(torch.equal(gm[k], wm[k]) for k in ttrainer.METRIC_KEYS)
