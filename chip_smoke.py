"""Drive the PyTorch port's Burgers serving path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:
  1 device  CUDA present, card name and power limit, TF32 off
  2 build   nvcc builds the fused Taylor-2 kernel from pinns_tpu_torch/csrc
  3 kernel  kernel vs the plain PyTorch recurrence on the card: the served
            8x20 model within TOL; a seeded random 8x200 net against the
            float64 recurrence (see compare_f64)
  4 slice   committed JAX fixture -> export -> ServedModel(device="cuda")
            -> predict(25,600 points); u, f and rel-L2 against JAX's, and the
            kernel launch count of that run
  5 http    the HTTP server on an ephemeral port: /meta, JSON and npy bodies,
            a malformed body
  6 times   CUDA-event medians of kernel vs plain, host-clock medians of
            served predict
Then a {"kernels": [...]} summary line and, last, the result line.
The script imports neither jax nor pinns_tpu (the JAX package).
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port", "burgers_forward_8x20.npz")
NARROW = (2,) + (20,) * 8 + (1,)  # burgers_forward / abgrall_admm
WIDE = (2,) + (200,) * 8 + (1,)  # abgrall_visc
LB, UB = (-1.0, 0.0), (1.0, 0.99)
# (layers, N): the served shapes of the main path (25,600 grid points, padded
# to the 32,768 bucket), a small request, a 1M-point batch, and the wide net
KERNEL_SHAPES = [(NARROW, 64), (NARROW, 25_600), (NARROW, 32_768),
                 (NARROW, 1_048_576), (WIDE, 65_536)]
MAIN_SHAPE = (NARROW, 32_768)
STREAMS = ("u", "u_x", "u_t", "u_xx")
# rtol and atol (as a multiple of max|reference|) per stream: u_xx sums eight
# layers of products in another order, so it gets ten times the absolute room
TOL = {"u": (1e-5, 1e-5), "u_x": (1e-5, 1e-5), "u_t": (1e-5, 1e-5),
       "u_xx": (1e-5, 1e-4), "f": (1e-5, 1e-4)}
F64_FACTOR = 4.0
REPS = 20


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(card: str, **fields) -> None:
    print(json.dumps({**fields, "card": card}), flush=True)


def compare(name: str, got: np.ndarray, want: np.ndarray) -> dict:
    """Max abs error of ``got`` against ``want`` beside TOL[name]; raises if over."""
    rtol, atol_rel = TOL[name]
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    atol = atol_rel * float(np.abs(want).max())
    err = np.abs(got - want)
    ok = bool((err <= atol + rtol * np.abs(want)).all())
    row = {"max_abs_err": float(err.max()), "atol": atol, "rtol": rtol, "ok": ok}
    check(ok, f"{name}: {row}")
    return row


def compare_f64(name: str, got, plain, exact) -> dict:
    """The kernel against the float64 recurrence, beside the plain float32
    recurrence's own error: the kernel passes when its error is at most
    F64_FACTOR times the plain version's plus 1e-6 max|exact|. (For a deep
    random net the outputs come out of sums of much larger terms, and float32
    itself misses 1e-5 max|.|, whatever order it sums in.)"""
    got, plain, exact = (np.asarray(a, np.float64) for a in (got, plain, exact))
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values")
    err = float(np.abs(got - exact).max())
    plain_err = float(np.abs(plain - exact).max())
    bound = F64_FACTOR * plain_err + 1e-6 * float(np.abs(exact).max())
    row = {"max_abs_err_vs_plain": float(np.abs(got - plain).max()),
           "max_abs_err_vs_f64": err, "plain_err_vs_f64": plain_err,
           "bound": bound, "ok": err <= bound}
    check(row["ok"], f"{name}: {row}")
    return row


def points(n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.uniform(LB, UB, size=(n, 2)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def event_ms(fn) -> float:
    """Median milliseconds of ``fn`` over REPS runs, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn) -> float:
    """Median wall milliseconds of ``fn`` (which ends in a device->host copy)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def http(url: str, body: bytes = None, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def main() -> int:
    # -- 1 device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pinns_tpu_torch.device import resolve_device
    from pinns_tpu_torch.interop import load_params_npz, params_from_jax
    from pinns_tpu_torch.models.mlp import MLPSpec, init_mlp
    from pinns_tpu_torch.ops.kernels import build
    from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
    from pinns_tpu_torch.ops.taylor import mlp_taylor_2_reference
    from pinns_tpu_torch.serve import ServedModel, export_predict, make_http_server
    from pinns_tpu_torch.train.evaluate import relative_l2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    device = resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    check(torch.get_float32_matmul_precision() == "highest", "fp32 matmul precision not highest")
    emit(card, phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=False)

    # -- 2 build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("taylor2")
    ptxas = [ln.strip() for ln in build.build_log("taylor2").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(card, phase="build", kernel="taylor2", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.BUILD_SECONDS.get("taylor2"),
         library=os.path.relpath(str(build.library_path("taylor2")), ROOT), ptxas=ptxas)

    # -- 3 kernel vs plain -----------------------------------------------
    # the 8x20 net is the served model (the trained JAX fixture); the 8x200
    # net has random weights from a seed
    fx = np.load(FIXTURE, allow_pickle=False)
    loaded = load_params_npz(FIXTURE)
    check(loaded["spec"].layers == NARROW, f"fixture widths {loaded['spec'].layers}")
    wide = MLPSpec(layers=WIDE, lb=LB, ub=UB)
    nets = {
        NARROW: (loaded["spec"], params_from_jax(loaded["params"], device)),
        WIDE: (wide, init_mlp(wide, torch.Generator().manual_seed(200), device)),
    }
    main_err = None
    for layers, n in KERNEL_SHAPES:
        spec, params = nets[layers]
        x = points(n, seed=n, device=device)
        with torch.inference_mode():
            got = k_taylor2.taylor2(spec, params, x)
            want = mlp_taylor_2_reference(spec, params, x)
            if layers == WIDE:
                spec64 = dataclasses.replace(spec, dtype=torch.float64)
                params64 = [{k: v.double() for k, v in p.items()} for p in params]
                exact = mlp_taylor_2_reference(spec64, params64, x.double())
            torch.cuda.synchronize()
        host = lambda ts: [t.cpu().numpy() for t in ts]  # noqa: E731
        if layers == WIDE:
            rows = {s: compare_f64(s, g, w, e)
                    for s, g, w, e in zip(STREAMS, host(got), host(want), host(exact))}
        else:
            rows = {s: compare(s, g, w)
                    for s, g, w in zip(STREAMS, host(got), host(want))}
        if (layers, n) == MAIN_SHAPE:
            main_err = max(r["max_abs_err"] for r in rows.values())
        emit(card, phase="kernel", net=f"{len(layers) - 2}x{max(layers)}", n=n,
             criterion="f64_oracle" if layers == WIDE else "tol_vs_plain",
             tile_threads=list(k_taylor2.launch_config(layers)), streams=rows)

    # -- 4 the slice against JAX ----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        art = export_predict(loaded["spec"], loaded["params"], os.path.join(tmp, "artifact"),
                             lambda1=loaded["lambda1"], lambda2=loaded["lambda2"],
                             experiment=loaded["experiment"])
        served = ServedModel(art, device="cuda")
        x_star = fx["X_star"]
        k_taylor2.LAUNCHES = 0
        out = served.predict(x_star, pad_to_bucket=True)
        launches = k_taylor2.LAUNCHES
        check(launches > 0, "the served predict never launched the taylor2 kernel")
        rows = {k: compare(k, out[k], fx[f"{k}_jax"]) for k in ("u", "f")}
        rel = relative_l2(out["u"], fx["u_star"])
        rel_jax = float(fx["rel_l2_jax"])
        check(abs(rel - rel_jax) <= 1e-5, f"rel-L2 {rel} vs JAX {rel_jax}")
        emit(card, phase="slice", experiment=loaded["experiment"], n=int(x_star.shape[0]),
             bucket=served.bucket_size(x_star.shape[0]), fields=rows,
             rel_l2_u=rel, rel_l2_u_jax=rel_jax, taylor2_launches=launches)

        # -- 5 HTTP -----------------------------------------------------
        server = make_http_server(art, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://127.0.0.1:%d" % server.server_address[1]
            code, _, body = http(base + "/meta")
            check(code == 200 and json.loads(body) == served.meta, "GET /meta")
            x8 = x_star[:8]
            code, _, body = http(base + "/predict", json.dumps({"x": x8.tolist()}).encode())
            check(code == 200, f"JSON POST answered {code}: {body[:200]!r}")
            want8 = served.predict(x8, pad_to_bucket=True)
            got8 = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
            check(all(np.array_equal(got8[k], want8[k]) for k in want8), "JSON predict differs")
            x64k = points(65_536, seed=7, device="cpu").numpy()
            buf = io.BytesIO()
            np.save(buf, x64k)
            code, ctype, body = http(base + "/predict", buf.getvalue(), "application/x-npy")
            check(code == 200 and ctype == "application/x-npz", f"npy POST answered {code}")
            want64k = served.predict(x64k, pad_to_bucket=True)
            with np.load(io.BytesIO(body)) as z:
                check(all(np.array_equal(z[k], want64k[k]) for k in want64k),
                      "npy predict differs")
            code, _, body = http(base + "/predict", b"{not json")
            check(code == 400 and "error" in json.loads(body), f"malformed body answered {code}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "HTTP server thread did not stop")
        emit(card, phase="http", meta=True, json_points=8, npy_points=65_536,
             malformed_status=400)

        # -- 6 times ----------------------------------------------------
        main_ms = main_plain_ms = None
        for layers, n in KERNEL_SHAPES:
            spec, params = nets[layers]
            x = points(n, seed=n, device=device)
            with torch.inference_mode():
                ms = event_ms(lambda: k_taylor2.taylor2(spec, params, x))
                plain = event_ms(lambda: mlp_taylor_2_reference(spec, params, x))
            if (layers, n) == MAIN_SHAPE:
                main_ms, main_plain_ms = ms, plain
            emit(card, phase="times", what="taylor2", net=f"{len(layers) - 2}x{max(layers)}",
                 n=n, kernel_ms=ms, plain_ms=plain, reps=REPS, clock="cuda_events")
        for n in (25_600, 1_048_576):
            xs = np.resize(x_star, (n, 2)) if n > x_star.shape[0] else x_star[:n]
            ms = host_ms(lambda: served.predict(xs, pad_to_bucket=True))
            emit(card, phase="times", what="served_predict", net="8x20", n=n,
                 ms=ms, points_per_s=n / (ms / 1e3), reps=REPS, clock="host")

    check(main_err is not None and math.isfinite(main_ms), "main-shape numbers missing")
    print(json.dumps({"kernels": [{
        "name": "taylor2",
        "route": "cuda",
        "source": "pinns_tpu_torch/csrc/taylor2.cu",
        "replaces": "89afc4b^:pinns_tpu/ops/pallas/fused_mlp.py:420",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
