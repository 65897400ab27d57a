"""Serving artifacts, the served model and its HTTP server (port of
``pinns_tpu/serve.py``).

The JAX artifact is a StableHLO program that only jax can load, so the port
has its own artifact: a directory with

  ``meta.json``   the keys of the JAX artifact's meta (``experiment``,
                  ``fields``, ``input``, ``pde``, ``provenance``);
  ``params.npz``  the weights, widths, bounds and PDE coefficients in the
                  params-file format of ``pinns_tpu_torch.interop``.

``ServedModel(path, device=...)`` puts the weights on its device once and
answers ``predict(x)`` through ``train.evaluate.predict_fields`` — on a CUDA
device, the fused Taylor-2 kernel. Ensemble artifacts and calibrated bands
come with slice 4.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pinns_tpu_torch import __version__
from pinns_tpu_torch.device import resolve_device
from pinns_tpu_torch.interop import load_params_npz, params_from_jax, save_params_npz
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.train.evaluate import predict_fields

_META_NAME = "meta.json"
_PARAMS_NAME = "params.npz"


def export_predict(
    spec: MLPSpec,
    params,
    path: str,
    lambda1: float,
    lambda2: float,
    experiment: Optional[str] = None,
) -> str:
    """Write a serving artifact for the Burgers prediction function
    (fields + residual) with the given params (port tensors or JAX-layout
    numpy). Returns ``path``. Euler artifacts come with slice 2."""
    os.makedirs(path, exist_ok=True)
    save_params_npz(
        os.path.join(path, _PARAMS_NAME), spec, params, lambda1, lambda2,
        experiment=experiment,
    )
    meta = {
        "experiment": experiment,
        "fields": ["f", "u"],
        "input": {"shape": ["b", 2], "dtype": "float32"},
        "pde": "burgers",
        "provenance": {
            "framework": f"pinns_tpu_torch {__version__}",
            "exported_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "export_backend": f"torch {torch.__version__}",
            "config": {
                "layers": list(spec.layers),
                "lb": list(spec.lb),
                "ub": list(spec.ub),
                "lambda1": float(lambda1),
                "lambda2": float(lambda2),
            },
        },
    }
    with open(os.path.join(path, _META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return path


class ServedModel:
    """A loaded artifact: ``predict(x) -> {field: (N, 1) np.ndarray}``.

    The weights and PDE coefficients are moved to ``device`` once, here.
    """

    def __init__(self, path: str, device="cpu"):
        self.device = resolve_device(device)
        with open(os.path.join(path, _META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta.get("pde", "burgers") != "burgers":
            raise NotImplementedError(
                f"pde {self.meta['pde']!r}: Euler artifacts come with slice 2"
            )
        loaded = load_params_npz(os.path.join(path, _PARAMS_NAME))
        self.spec: MLPSpec = loaded["spec"]
        self.params = params_from_jax(loaded["params"], self.device)
        self.lambda1 = torch.tensor(loaded["lambda1"], dtype=torch.float32, device=self.device)
        self.lambda2 = torch.tensor(loaded["lambda2"], dtype=torch.float32, device=self.device)

    @property
    def fields(self):
        return self.meta["fields"]

    @staticmethod
    def bucket_size(n: int, floor: int = 64) -> int:
        """Padded batch size: ``floor`` for small requests, else the next
        power of two, so a server sees at most ~log2(max_n) batch shapes."""
        if n <= floor:
            return floor
        return 1 << (n - 1).bit_length()

    def predict(self, x, pad_to_bucket: bool = False) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != 2:
            raise ValueError(f"x must be (N, 2), got {x.shape}")
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch: x must have at least one row")
        if pad_to_bucket:
            # every output is pointwise in the batch row, so padding with a
            # repeated row and slicing back is exact for the real rows
            b = self.bucket_size(n)
            if b != n:
                x = np.concatenate([x, np.repeat(x[-1:], b - n, axis=0)], axis=0)
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            out = predict_fields(self.spec, self.params, xt, self.lambda1, self.lambda2)
            return {k: v[:n].cpu().numpy() for k, v in out.items()}


def load_exported(path: str, device="cpu") -> ServedModel:
    return ServedModel(path, device=device)


def make_http_server(path: str, host: str = "127.0.0.1", port: int = 8080, device="cpu"):
    """Minimal stdlib prediction server over an artifact, on ``device``.

    Endpoints:
      GET  /meta     -> the artifact's meta.json
      POST /predict  -> JSON body {"x": [[x, t], ...]} returns
                        {field: [[...], ...]} for every field.
      POST /predict with Content-Type application/x-npy and a raw .npy (N, 2)
                        float array body returns an application/x-npz body
                        holding one float32 array per field.
    Bands (``"bands": true`` or ``?bands=1``) need a calibrated ensemble
    artifact, which the port cannot export yet: such a request gets a 400, as
    the JAX server answers on an uncalibrated artifact. Every error is a JSON
    400 with a diagnostic. Requests are padded to power-of-two buckets
    (``ServedModel.bucket_size``).

    Returns the unstarted ThreadingHTTPServer; call ``serve_forever()``.
    """
    import http.server
    import io
    import urllib.parse

    served = ServedModel(path, device=device)

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            if self.path == "/meta":
                self._send_json(200, served.meta)
            else:
                self._send_json(404, {"error": "unknown path; use /meta or POST /predict"})

        def do_POST(self):
            url = urllib.parse.urlsplit(self.path)
            if url.path != "/predict":
                self._send_json(404, {"error": "unknown path; use POST /predict"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                ctype = (self.headers.get("Content-Type")
                         or "application/json").split(";")[0].strip()
                binary = ctype in ("application/x-npy", "application/octet-stream")
                body = self.rfile.read(n)
                if binary:
                    x = np.load(io.BytesIO(body), allow_pickle=False)
                    query = urllib.parse.parse_qs(url.query)
                    want_bands = query.get("bands", ["0"])[0] not in ("0", "", "false")
                else:
                    req = json.loads(body)
                    x = req["x"]
                    want_bands = bool(req.get("bands"))
                x = np.asarray(x, np.float32)
                if want_bands:
                    raise ValueError(
                        "artifact carries no calibration metadata; calibrated "
                        "bands need an ensemble artifact (port slice 4)"
                    )
                out = served.predict(x, pad_to_bucket=True)
                if binary:
                    buf = io.BytesIO()
                    np.savez(buf, **{k: np.asarray(v, np.float32) for k, v in out.items()})
                    self._send(200, buf.getvalue(), "application/x-npz")
                else:
                    self._send_json(
                        200, {k: np.asarray(v, np.float32).tolist() for k, v in out.items()}
                    )
            except Exception as e:  # malformed request -> diagnostic, not a crash
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet by default
            pass

    return http.server.ThreadingHTTPServer((host, port), Handler)
