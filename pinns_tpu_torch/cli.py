"""Command line of the port: ``python -m pinns_tpu_torch <command>``.

  train    --preset NAME [--set KEY=VALUE ...] [--epochs N] [--chunk C] [--data GRID]
           [--device cuda|cpu] [--out-dir D] [--seed S] [--resume CKPT]
                                                  train; prints the JSON summary
  train    --preset NAME --ensemble E [--select] [--resume PREFIX] [...]
                                                  E members, seeds S .. S + E - 1
  sweep    --preset NAME --grid KEY=V1,V2,... [--grid ...] [--retries R] [--out F.jsonl]
           [--epochs N] [--serial] [--set ...] [--device cuda|cpu]
                                                  the cartesian grid; one line a config
  export   --params P.npz --out D                 write a serving artifact
  export   --preset NAME [--set ...] --checkpoint CKPT --out D [--device cuda|cpu]
                                                  the same artifact from a checkpoint
  eval     --preset NAME [--set ...] --checkpoint CKPT [--device cuda|cpu]
  eval     --artifact D [--preset NAME] [--device cuda|cpu]
                                                  rel-L2 per field on the preset's grid
  serve    --artifact D --port N --device cuda    HTTP server (GET /meta, POST /predict)
  predict  --artifact D --points P.npz --out O.npz --device cuda
                                                  batch inference, npz/csv in and out

``train`` runs the preset's schedule (on cuda, an Adam epoch inside the fused
step's scope is one call of K3, any other goes through the kernels under
autograd: K5 and K1/K2, K7a for the Euler presets, K7b around K7a or K5 for
the weak-form presets) and prints the summary keys of the JAX CLI
(``rel_l2_u``, or ``rel_l2_rho`` / ``rel_l2_u`` / ``rel_l2_E`` for Euler,
``lambda1``, ``lambda2`` (the effective coefficients: the identified
viscosity of ``euler_inverse``), ``truth``, ``epochs``). ``--resume CKPT``
continues a checkpoint (``train.out_dir`` writes them) from its epoch to the
schedule's end. ``--set`` overrides any config field by its dotted key, as
the JAX CLI's does: the value is a Python literal, else a string, e.g. the
bf16 stream policy of ``burgers_scale``:

  --set model.compute_dtype=bfloat16 --set "model.keep_streams=('xx',)"

``train --ensemble E`` (default ``mesh.ensemble``) trains E members, seeds
``train.seed`` to ``train.seed + E - 1``, through the whole schedule
(``parallel.ensemble.run_ensemble``: on the card an Adam epoch of a preset
inside the fused step's narrow scope is one call of K8 for all members, any
other runs each member's solo step in turn); each member prints its summary
line, and ``--select`` prints the member that the ground-truth-free score
picks. ``--resume PREFIX`` continues the ``PREFIX_m<i>.ckpt`` set that
``train.checkpoint_every`` wrote. ``sweep`` runs the cartesian product of the
``--grid`` lists (``parallel.sweep.run_sweep``): configurations that differ
only in ``train.seed`` and ``loss.rho`` train as one ensemble; it exits 1 if
any configuration failed.

``export`` takes a params file (``pinns_tpu_torch.interop`` format, e.g.
written from a JAX run by ``scripts/make_torch_port_fixture.py``; its ``pde``
key makes a Burgers or an Euler artifact) or a checkpoint of the port's own
training with its preset. ``eval`` prints ``Trainer.evaluate``'s JSON for a
checkpoint, or grades an artifact against its dataset's grid. Ensemble
artifacts (several checkpoints, ``--select``, ``--calibrate``) and band
coverage come with slice 4b. ``--device`` defaults to cuda and raises when no
card is visible; pass ``--device cpu`` for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys

import numpy as np


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_sets(pairs) -> dict:
    """``--set key=value`` pairs as overrides: a Python literal, else a string."""
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        out[key] = _parse_value(value)
    return out


def _build_exp(args):
    """The preset with ``--set`` and the command's own overrides applied."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset

    updates = parse_sets(args.set)
    for key, attr in (("train.epochs", "epochs"), ("train.chunk", "chunk"),
                      ("train.out_dir", "out_dir"), ("train.seed", "seed")):
        value = getattr(args, attr, None)
        if value is not None:
            updates[key] = value
    return override(get_preset(args.preset), updates)


def cmd_train(args) -> int:
    from pinns_tpu_torch.train.trainer import Trainer

    exp = _build_exp(args)
    n = exp.mesh.ensemble if args.ensemble is None else args.ensemble
    if n < 1:
        raise SystemExit(f"--ensemble takes a member count of at least 1, got {n}")
    trainer = Trainer(exp, device=args.device, dataset=args.data)
    if n == 1:
        if args.select:
            raise SystemExit("--select picks a member of an ensemble: pass --ensemble E > 1")
        state = trainer.load_checkpoint(args.resume) if args.resume else None
        _, summary = trainer.train(state)
        print(json.dumps(summary), flush=True)
        return 0
    return _train_ensemble(args, exp, trainer, n)


def _train_ensemble(args, exp, trainer, n: int) -> int:
    """``train --ensemble n``: members of seeds train.seed + i, each one's
    summary line, then the pick of ``--select``."""
    import os

    from pinns_tpu_torch.parallel.ensemble import (
        run_ensemble,
        select_member,
        selection_scores,
        stack_states,
    )

    seeds = [exp.train.seed + i for i in range(n)]
    stacked = None
    if args.resume:
        members = []
        for i in range(n):
            path = f"{args.resume}_m{i}.ckpt"
            if not os.path.exists(path):
                raise SystemExit(f"ensemble resume: missing member checkpoint {path} "
                                 "(--resume takes the prefix of the _m<i>.ckpt set)")
            members.append(trainer.load_checkpoint(path))
        stacked = stack_states(members)
    stacked, summaries = run_ensemble(trainer, seeds, stacked=stacked)
    for seed, summary in zip(seeds, summaries):
        print(json.dumps(dict(summary, seed=seed)), flush=True)
    if args.select:
        scores = selection_scores(trainer, stacked, n)
        pick = select_member(scores)
        print(json.dumps({"selected_member": pick, "seed": seeds[pick],
                          "checkpoint": f"{exp.name}_final_m{pick}.ckpt",
                          "scores": scores}), flush=True)
    return 0


def _split_top_level(text: str):
    """Split on commas outside (), [] and {}: tuple values such as
    model.layers=(2,8,1),(2,16,1) stay whole."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in parts if p]


def cmd_sweep(args) -> int:
    from pinns_tpu_torch.parallel.sweep import cartesian_grid, run_sweep

    exp = _build_exp(args)
    lists = {}
    for spec in args.grid:
        if "=" not in spec:
            raise SystemExit(f"--grid expects KEY=V1,V2,..., got {spec!r}")
        key, values = spec.split("=", 1)
        lists[key] = [_parse_value(v) for v in _split_top_level(values)]
    grid = cartesian_grid(lists)
    results = run_sweep(exp, grid, retries=args.retries, out_path=args.out, epochs=args.epochs,
                        concurrent=False if args.serial else None, device=args.device,
                        dataset=args.data)
    ok = sum(1 for r in results if r.status == "ok")
    print(f"{ok}/{len(results)} configurations succeeded", flush=True)
    for r in results:
        line = {"overrides": r.overrides, "status": r.status}
        if r.summary:
            line.update({k: v for k, v in r.summary.items() if k.startswith("rel_l2")})
        if r.error:
            line["error"] = r.error.strip().splitlines()[-1]
        print(json.dumps(line), flush=True)
    return 0 if ok == len(results) else 1


ENSEMBLE_SLICE = "slice 4b (ensemble serving)"


def cmd_export(args) -> int:
    from pinns_tpu_torch.serve import export_predict

    if args.params:
        from pinns_tpu_torch.interop import load_params_npz

        if args.checkpoint or args.preset:
            raise SystemExit("export takes --params, or --preset with --checkpoint")
        loaded = load_params_npz(args.params)
        path = export_predict(
            loaded["spec"], loaded["params"], args.out,
            lambda1=loaded["lambda1"], lambda2=loaded["lambda2"],
            experiment=loaded["experiment"], pde=loaded["pde"], gamma=loaded["gamma"],
        )
        print(path)
        return 0
    if not (args.preset and args.checkpoint):
        raise SystemExit("export needs --params, or --preset with --checkpoint")
    if len(args.checkpoint) > 1 or args.select or args.calibrate:
        raise SystemExit("ensemble artifacts (several checkpoints, --select, --calibrate) "
                         f"come with {ENSEMBLE_SLICE}")
    from pinns_tpu_torch.train import checkpoint as ckpt_io
    from pinns_tpu_torch.train.trainer import build_problem

    exp = _build_exp(args)
    problem = build_problem(exp, args.device, args.data)
    state = ckpt_io.load_checkpoint(args.checkpoint[0], problem.device)
    lam1, lam2 = problem.effective_coeffs(state.params)
    path = export_predict(
        problem.spec, state.params["net"], args.out,
        lambda1=float(lam1.reshape(-1)[0]), lambda2=float(lam2.reshape(-1)[0]),
        experiment=exp.name, pde=exp.pde.kind, gamma=exp.pde.gamma,
    )
    print(path)
    return 0


def cmd_eval(args) -> int:
    if args.artifact:
        return _eval_artifact(args)
    if not (args.checkpoint and args.preset):
        raise SystemExit("eval needs --artifact, or --preset with --checkpoint")
    from pinns_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_build_exp(args), device=args.device, dataset=args.data)
    state = trainer.load_checkpoint(args.checkpoint)
    print(json.dumps(trainer.evaluate(state)), flush=True)
    return 0


def _eval_artifact(args) -> int:
    """Grade a serving artifact against its dataset's exact grid: the rel-L2
    of each served field there (the preset defaults to the artifact's own
    experiment)."""
    from pinns_tpu_torch.serve import load_exported
    from pinns_tpu_torch.train.evaluate import relative_l2
    from pinns_tpu_torch.train.trainer import build_problem

    served = load_exported(args.artifact, device=args.device)
    if not args.preset:
        args.preset = served.meta.get("experiment")
        if not args.preset:
            raise SystemExit("the artifact names no experiment: pass --preset")
    exp = _build_exp(args)
    ds = build_problem(exp, args.device, args.data).dataset
    preds = served.predict(ds.X_star)
    out = {"artifact": args.artifact, "experiment": exp.name,
           "truth": getattr(ds, "provenance", "unknown")}
    for name in sorted(ds.star):
        if name in preds:
            out[f"rel_l2_{name}"] = relative_l2(preds[name], ds.star[name])
    print(json.dumps(out), flush=True)
    return 0


def cmd_serve(args) -> int:
    from pinns_tpu_torch.serve import make_http_server

    server = make_http_server(args.artifact, host=args.host, port=args.port,
                              device=args.device)
    host, port = server.server_address[:2]
    print(f"serving {args.artifact} on {args.device} at http://{host}:{port} "
          f"(GET /meta, POST /predict)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def _read_points(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return np.asarray(z["x"])
    with open(path) as f:
        first = f.readline()
    return np.loadtxt(
        path, delimiter="," if "," in first else None,
        skiprows=1 if any(c.isalpha() for c in first) else 0,
    )


def cmd_predict(args) -> int:
    from pinns_tpu_torch.serve import load_exported

    served = load_exported(args.artifact, device=args.device)
    x = np.atleast_2d(np.asarray(_read_points(args.points), np.float32))
    out = served.predict(x)
    if args.out.endswith(".npz"):
        np.savez(args.out, x=x, **{k: np.asarray(v, np.float32) for k, v in out.items()})
    else:
        names = sorted(out)
        cols = [x[:, 0], x[:, 1]] + [np.asarray(out[k], np.float32).ravel() for k in names]
        np.savetxt(args.out, np.column_stack(cols), delimiter=",",
                   header="x,t," + ",".join(names), comments="")
    print(args.out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pinns_tpu_torch",
                                 description="PyTorch port of pinns_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_common(p, preset_required=True):
        p.add_argument("--preset", required=preset_required)
        p.add_argument("--set", action="append", metavar="KEY=VALUE",
                       help="override a config field, e.g. sampling.n_f=4000 (repeatable)")
        p.add_argument("--data", help="grid .mat/.npz in place of the preset's dataset")
        p.add_argument("--device", default="cuda")

    p = sub.add_parser("train", help="train a preset")
    add_common(p)
    p.add_argument("--epochs", type=int)
    p.add_argument("--chunk", type=int, help="epochs per chunk (metrics stay on the device)")
    p.add_argument("--out-dir", help="metrics JSONL and checkpoints go here")
    p.add_argument("--seed", type=int)
    p.add_argument("--resume", metavar="CKPT",
                   help="continue this checkpoint from its epoch to the schedule's end; "
                        "with --ensemble, the PREFIX of the <prefix>_m<i>.ckpt set")
    p.add_argument("--ensemble", type=int, default=None, metavar="E",
                   help="train E members, seeds train.seed .. train.seed + E - 1 "
                        "(default: mesh.ensemble)")
    p.add_argument("--select", action="store_true",
                   help="after an --ensemble run, score the members without ground truth "
                        "(training-data misfit + fresh-batch residual) and print the pick")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("sweep", help="hyperparameter sweep over a cartesian grid")
    add_common(p)
    p.add_argument("--grid", action="append", required=True, metavar="KEY=V1,V2,...")
    p.add_argument("--epochs", type=int)
    p.add_argument("--retries", type=int, default=1)
    p.add_argument("--out", default=None, help="JSONL results path")
    p.add_argument("--serial", action="store_true",
                   help="run the units in turn (the only way on one card)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("export", help="write a serving artifact from a params file or a "
                                      "checkpoint")
    add_common(p, preset_required=False)
    p.add_argument("--params", help="params .npz (interop format)")
    p.add_argument("--checkpoint", nargs="+", help="a checkpoint of the preset's training")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--select", help="ensemble member selection (slice 4b)")
    p.add_argument("--calibrate", action="store_true", help="ensemble bands (slice 4b)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("eval", help="evaluate a checkpoint, or grade a serving artifact")
    add_common(p, preset_required=False)
    p.add_argument("--checkpoint")
    p.add_argument("--artifact", help="artifact directory (from export); the preset "
                                      "defaults to its experiment")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("serve", help="HTTP prediction server over an artifact")
    p.add_argument("--artifact", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("predict", help="batch inference from an artifact")
    p.add_argument("--artifact", required=True)
    p.add_argument("--points", required=True, help=".npz with key 'x', or a 2-column csv")
    p.add_argument("--out", required=True, help=".npz or .csv")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_predict)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
