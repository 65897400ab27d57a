"""Command line of the port: ``python -m pinns_tpu_torch <command>``.

  export   --params P.npz --out D                 write a serving artifact
  serve    --artifact D --port N --device cuda    HTTP server (GET /meta, POST /predict)
  predict  --artifact D --points P.npz --out O.npz --device cuda
                                                  batch inference, npz/csv in and out

``export`` takes a params file (``pinns_tpu_torch.interop`` format, e.g.
written from a JAX run by ``scripts/make_torch_port_fixture.py``): the port
has no trainer or checkpoints yet. ``--device`` defaults to cuda and raises
when no card is visible; pass ``--device cpu`` for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_export(args) -> int:
    from pinns_tpu_torch.interop import load_params_npz
    from pinns_tpu_torch.serve import export_predict

    loaded = load_params_npz(args.params)
    path = export_predict(
        loaded["spec"], loaded["params"], args.out,
        lambda1=loaded["lambda1"], lambda2=loaded["lambda2"],
        experiment=loaded["experiment"],
    )
    print(path)
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
                                 description="PyTorch port of pinns_tpu: serving")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("export", help="write a serving artifact from a params file")
    p.add_argument("--params", required=True, help="params .npz (interop format)")
    p.add_argument("--out", required=True, help="artifact directory")
    p.set_defaults(fn=cmd_export)

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
