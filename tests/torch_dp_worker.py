"""One rank of the port's data-parallel CPU tests (``tests/test_torch_dp.py``,
``tests/test_torch_mesh.py``): ``python tests/torch_dp_worker.py TASK ARGS``
with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) set by the test, ARGS a JSON object. It joins a gloo process
group through ``parallel.mesh.multihost_init``, runs TASK on the committed
TwoSin grid and writes ``<out>.rank<r>.npz`` and ``<out>.rank<r>.json``.
It imports the port alone (no JAX), so a rank starts in a few seconds.
:func:`spawn` starts the ranks from a test and reads their results back.

Tasks:
  steps     the Adam step (the trainer's) from the whole state of the
            checkpoint ``ckpt``, ``n_steps`` epochs each fed this rank's
            rows of ``feed`` (n_steps, N_f, 2), data-parallel over the world;
            the metrics per step and the gathered final state
  draws     this rank's rows of the initial batch and of the draws 1..3
  train     Trainer.train data-parallel over the world with ``updates``,
            the collective counts per kind and the summary; with ``resume``
            the whole checkpoint cut to the ranks' rows first; the final
            state gathered
  ensemble  run_ensemble of ``members`` seeds over the mesh (data axis
            ``data``, the rest on the ensemble axis); the counts and the
            summaries
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank on this host, one torch thread."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return env


def spawn(task: str, args: dict, world: int, timeout: float = 240.0) -> list:
    """Run ``task`` on ``world`` ranks (one process each, gloo); returns
    [(arrays, info)] in rank order. Raises with a rank's output if one
    fails or the ranks outlive ``timeout`` seconds (they are killed)."""
    port = free_port()
    logs = [open(f"{args['out']}.rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, task, json.dumps(args)],
                              stdout=log, stderr=subprocess.STDOUT, env=rank_env(r, world, port),
                              cwd=REPO)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"{args['out']}.rank{r}.log") as fh:
                out = fh.read()
            raise RuntimeError(f"rank {r} of {world} failed ({p.returncode}):\n{out[-4000:]}")
    results = []
    for r in range(world):
        with np.load(f"{args['out']}.rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(f"{args['out']}.rank{r}.json") as fh:
            results.append((arrays, json.load(fh)))
    return results


def _exp(args):
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset

    return override(get_preset(args.get("preset", "abgrall_admm")), args["updates"])


def _flat(state) -> dict:
    from pinns_tpu_torch.interop import train_state_to_numpy

    tree = train_state_to_numpy(state)
    out = {"colloc": tree["colloc"]}
    out["params"] = np.concatenate([a.ravel() for layer in tree["params"]["net"]
                                    for a in layer.values()])
    for k in ("mu", "nu"):
        if k in tree:
            out[k] = np.concatenate([a.ravel() for layer in tree[k]["net"]
                                     for a in layer.values()])
    if "z" in tree:
        out["z"], out["dual"] = tree["z"], tree["dual"]
    return out


def main() -> int:
    task, args = sys.argv[1], json.loads(sys.argv[2])
    torch.set_num_threads(1)
    from pinns_tpu_torch.parallel import sharding
    from pinns_tpu_torch.parallel.mesh import make_mesh, multihost_init
    from pinns_tpu_torch.train import trainer as ttrainer

    rank, size, device = multihost_init("cpu")
    out = f"{args['out']}.rank{rank}"
    arrays, info = {}, {"rank": rank, "world": size}
    if task == "ensemble":
        from pinns_tpu_torch.parallel.ensemble import run_ensemble

        trainer = ttrainer.Trainer(_exp(args), device=device, dataset=GRID)
        mesh = make_mesh(data=args["data"], ensemble=size // args["data"])
        seeds = [trainer.exp.train.seed + i for i in range(args["members"])]
        sharding.reset_collectives()
        stacked, summaries = run_ensemble(trainer, seeds, mesh=mesh)
        info.update(summaries=summaries, counts=sharding.collective_counts(),
                    coords=list(mesh.coords))
    else:
        trainer = ttrainer.Trainer(_exp(args), device=device, dataset=GRID)
        mesh = make_mesh(data=size, ensemble=1)
        sharding.shard_trainer(trainer, mesh)
        problem = trainer.problem
        if task == "draws":
            for d in range(4):
                arrays[f"draw{d}"] = ttrainer._resample(problem, 1234, d).numpy()
            arrays["init"] = ttrainer.init_collocation(problem, 1234).numpy()
        elif task == "steps":
            state = sharding.place_state(trainer.load_checkpoint(args["ckpt"]), mesh)
            feed = np.load(args["feed"])
            rows = problem.shard.rows(feed.shape[1])
            metrics = []
            sharding.reset_collectives()
            for k in range(args["n_steps"]):
                state, m = trainer._adam_step(state, new_colloc=torch.from_numpy(feed[k][rows]))
                metrics.append({name: float(v) for name, v in m.items()})
            info.update(metrics=metrics, counts=sharding.collective_counts())
            arrays.update(_flat(sharding.gather_state(state, problem.shard)))
        elif task == "train":
            state = None
            if args.get("resume"):
                state = sharding.place_state(trainer.load_checkpoint(args["resume"]), mesh)
            sharding.reset_collectives()
            state, summary = trainer.train(state)
            info.update(summary=summary, counts=sharding.collective_counts())
            arrays.update(_flat(sharding.gather_state(state, problem.shard)))
        else:
            raise SystemExit(f"unknown task {task!r}")
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(info, fh)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
