"""Serving artifacts, the served model and its HTTP server (port of
``pinns_tpu/serve.py``).

The JAX artifact is a StableHLO program that only jax can load, so the port
has its own artifact: a directory with

  ``meta.json``   the keys of the JAX artifact's meta (``experiment``,
                  ``fields``, ``input``, ``pde``, ``provenance``);
  ``params.npz``  the weights (a shock-path net's path leaves and spec
                  fields included), widths, bounds and PDE coefficients in
                  the params-file format of ``pinns_tpu_torch.interop``.

``ServedModel(path, device=...)`` puts the weights on its device once and
answers ``predict(x)`` through ``train.evaluate.burgers_fields`` ({f, u}) or,
for an artifact whose ``pde`` is 'euler', ``euler_fields`` ({rho, u, E, f1,
f2, f3}) — on a CUDA device, the fused Taylor-2 kernel (K1) or the Taylor-1
kernel (K7a).

An ensemble artifact (:func:`export_ensemble`, JAX's ``export_ensemble``)
serves each field's member mean ``{name}`` and std ``{name}_std`` and, when
its calibration bins on the front feature, ``{name}_dx`` (|mean d/dx|); its
``params.npz`` holds the E members with a leading member axis
(``interop.save_ensemble_npz``) and its ``meta.json`` JAX's keys, the
``calibration`` block (split-conformal ``k_conf95`` and the Mondrian
``mond_edges`` / ``mond_k``) included. ``ServedModel.predict`` answers it
through ``parallel.ensemble.ensemble_stats`` (on the card the member-batched
K1 or K7a, and the member reduction K8s), and ``band_ks`` gives the
calibrated per-point band factors that the HTTP server and ``predict
--bands`` multiply by the std.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pinns_tpu_torch import __version__
from pinns_tpu_torch.device import pin_numerics, resolve_device
from pinns_tpu_torch.interop import (
    load_params_npz,
    params_from_jax,
    save_ensemble_npz,
    save_params_npz,
    unstack_params,
)
from pinns_tpu_torch.models.mlp import MLPSpec
from pinns_tpu_torch.train.evaluate import DX_FIELDS, burgers_fields, euler_fields

_META_NAME = "meta.json"
_PARAMS_NAME = "params.npz"
# the artifact's output names per PDE, sorted as the JAX export lists them
FIELDS = {"burgers": ["f", "u"], "euler": ["E", "f1", "f2", "f3", "rho", "u"]}


def export_predict(
    spec: MLPSpec,
    params,
    path: str,
    lambda1: float,
    lambda2: float,
    experiment: Optional[str] = None,
    pde: str = "burgers",
    gamma: float = 1.4,
) -> str:
    """Write a serving artifact for the prediction function (fields and
    residuals) of ``pde`` ('burgers' or 'euler', whose net has the 3 outputs
    rho, u, E) with the given params (port tensors or JAX-layout numpy).
    Returns ``path``."""
    _check_pde(pde)
    os.makedirs(path, exist_ok=True)
    save_params_npz(
        os.path.join(path, _PARAMS_NAME), spec, params, lambda1, lambda2,
        experiment=experiment, pde=pde, gamma=gamma,
    )
    meta = _meta(spec, experiment, pde, gamma, FIELDS[pde],
                 {"lambda1": float(lambda1), "lambda2": float(lambda2)})
    _write_meta(path, meta)
    return path


# the calibration keys an ensemble artifact keeps per field (JAX's export_ensemble)
CALIBRATION_KEYS = ("k_conf95", "cov_conf95", "cov2s", "k95", "mond_edges", "mond_k",
                    "cov_mond95", "cov_mond95_shock")


def export_ensemble(
    spec: MLPSpec,
    members,
    path: str,
    lambda1s,
    lambda2s,
    experiment: Optional[str] = None,
    pde: str = "burgers",
    gamma: float = 1.4,
    calibration: Optional[dict] = None,
) -> str:
    """Write an ensemble artifact (JAX's ``export_ensemble``) of the E member
    nets ``members`` (port tensors or JAX-layout numpy), each with its
    Burgers coefficients: outputs ``{name}`` (the members' mean) and
    ``{name}_std`` per field. ``calibration`` is ``parallel.ensemble.
    uq_calibration``'s output: its kept keys (``CALIBRATION_KEYS`` and
    ``mond_feature``) go into ``meta.json`` under ``calibration``; a row that
    bins on 'dx' adds the ``{name}_dx`` outputs of the front feature.
    Returns ``path``."""
    _check_pde(pde)
    want_dx = bool(calibration) and any(
        row.get("mond_feature") == "dx" for row in calibration.values())
    fields = [f for name in FIELDS[pde] for f in (name, f"{name}_std")]
    if want_dx:
        fields += [f"{name}_dx" for name in DX_FIELDS[pde]]
    os.makedirs(path, exist_ok=True)
    save_ensemble_npz(os.path.join(path, _PARAMS_NAME), spec, list(members), list(lambda1s),
                      list(lambda2s), experiment=experiment, pde=pde, gamma=gamma)
    meta = _meta(spec, experiment, pde, gamma, sorted(fields),
                 {"lambda1": [float(v) for v in lambda1s],
                  "lambda2": [float(v) for v in lambda2s]})
    meta["ensemble_members"] = len(members)
    if calibration:
        meta["calibration"] = {
            f: {**{k: ([float(v) for v in row[k]] if isinstance(row[k], list) else float(row[k]))
                   for k in CALIBRATION_KEYS if k in row},
                **({"mond_feature": row["mond_feature"]} if "mond_feature" in row else {})}
            for f, row in calibration.items()
        }
    _write_meta(path, meta)
    return path


def _check_pde(pde: str) -> None:
    if pde not in FIELDS:
        raise ValueError(f"unknown pde {pde!r}: expected one of {sorted(FIELDS)}")


def _meta(spec: MLPSpec, experiment, pde: str, gamma: float, fields, coeffs: dict) -> dict:
    config = {"layers": list(spec.layers), "lb": list(spec.lb), "ub": list(spec.ub), **coeffs}
    if pde == "euler":
        config["gamma"] = float(gamma)
    return {
        "experiment": experiment,
        "fields": list(fields),
        "input": {"shape": ["b", 2], "dtype": "float32"},
        "pde": pde,
        "provenance": {
            "framework": f"pinns_tpu_torch {__version__}",
            "exported_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "export_backend": f"torch {torch.__version__}",
            "config": config,
        },
    }


def _write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, _META_NAME), "w") as f:
        json.dump(meta, f, indent=1)


class ServedModel:
    """A loaded artifact: ``predict(x) -> {field: (N, 1) np.ndarray}``.

    The weights and PDE coefficients are moved to ``device`` once, here:
    the card unless the caller asks for the CPU (raises without one). An
    ensemble artifact's members go into one (E, S) buffer
    (``parallel.ensemble.pack_members``) and its coefficients into (E, 1, 1)
    tensors.
    """

    def __init__(self, path: str, device="cuda"):
        from pinns_tpu_torch.parallel.ensemble import pack_members

        self.device = resolve_device(device)
        with open(os.path.join(path, _META_NAME)) as f:
            self.meta = json.load(f)
        self.pde = self.meta.get("pde", "burgers")
        if self.pde not in FIELDS:
            raise ValueError(f"artifact pde {self.pde!r}: expected one of {sorted(FIELDS)}")
        loaded = load_params_npz(os.path.join(path, _PARAMS_NAME))
        self.spec: MLPSpec = loaded["spec"]
        self.gamma = loaded["gamma"]
        self.members = loaded["members"]
        coeff = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        if self.members is None:
            self.params = params_from_jax(loaded["params"], self.device)
            self.lambda1, self.lambda2 = coeff(loaded["lambda1"]), coeff(loaded["lambda2"])
        else:
            nets = [params_from_jax(p, self.device)
                    for p in unstack_params(loaded["params"], self.members)]
            self.flat = pack_members(nets)
            self.lambda1, self.lambda2 = (coeff(loaded[k]).view(-1, 1, 1)
                                          for k in ("lambda1", "lambda2"))
            self.want_dx = any(k.endswith("_dx") for k in self.fields)

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
        pin_numerics()  # another caller in this process may have lowered them
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            if self.members is not None:
                out = self._ensemble(xt)
            elif self.pde == "euler":
                out = euler_fields(self.spec, self.params, xt, self.gamma)
            else:
                out = burgers_fields(self.spec, self.params, xt, self.lambda1, self.lambda2)
            return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def _ensemble(self, xt: torch.Tensor) -> Dict[str, torch.Tensor]:
        from pinns_tpu_torch.parallel.ensemble import ensemble_stats

        stats = ensemble_stats(self.spec, self.pde, self.flat, xt, self.lambda1, self.lambda2,
                               self.gamma, self.want_dx)
        out = {}
        for name, row in stats.items():
            out[name], out[f"{name}_std"] = row["mean"], row["std"]
            if "dx" in row:
                out[f"{name}_dx"] = row["dx"]
        return out

    def band_k(self, field: str, default: float = 2.0) -> float:
        """The calibrated global factor of ``mean +- k std`` (the conformal
        ``k_conf95``), ``default`` when the artifact carries none."""
        cal = self.meta.get("calibration") or {}
        return float(cal.get(field, {}).get("k_conf95", default))

    def band_ks(self, field: str, std, default: float = 2.0, feature=None) -> np.ndarray:
        """Per-point band factors, as JAX's ``ServedModel.band_ks``: the
        Mondrian factor of each point's bin (its value of the baked
        ``mond_feature`` over ``mond_edges``: the std, or the front feature
        ``{field}_dx`` passed as ``feature`` for a 'dx' calibration), else a
        constant array of :meth:`band_k`. A 'dx' calibration without a
        feature takes the constant rather than binning the wrong feature."""
        from pinns_tpu_torch.parallel.ensemble import mond_band_factors

        cal = (self.meta.get("calibration") or {}).get(field, {})
        return mond_band_factors(cal, std, default, feature)

    def add_bands(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """``out`` with ``{name}_band`` = band_ks(name, std, {name}_dx) std,
        the calibrated ~95% half-width, for every calibrated field of a
        predict's output. Raises ValueError on an artifact without
        calibration: a 2 std band would be silently overconfident at fronts."""
        cal = self.meta.get("calibration") or {}
        if not cal:
            raise ValueError("artifact carries no calibration metadata; export with "
                             "--calibrate to serve bands")
        for k in list(out):
            if k.endswith("_std") and k[:-len("_std")] in cal:
                name = k[:-len("_std")]
                out[f"{name}_band"] = self.band_ks(
                    name, out[k], feature=out.get(f"{name}_dx")) * np.asarray(out[k], np.float64)
        return out


def load_exported(path: str, device="cuda") -> ServedModel:
    return ServedModel(path, device=device)


def make_http_server(path: str, host: str = "127.0.0.1", port: int = 8080, device="cuda"):
    """Minimal stdlib prediction server over an artifact, on ``device``.

    Endpoints:
      GET  /meta     -> the artifact's meta.json
      POST /predict  -> JSON body {"x": [[x, t], ...]} returns
                        {field: [[...], ...]} for every field.
      POST /predict with Content-Type application/x-npy and a raw .npy (N, 2)
                        float array body returns an application/x-npz body
                        holding one float32 array per field.
    On an ensemble artifact every field comes with ``{name}_std`` (and
    ``{name}_dx`` for a 'dx' calibration). Bands (``"bands": true`` in JSON,
    ``?bands=1`` with npy) add ``{name}_band`` = ``band_ks(name, std,
    feature={name}_dx) * std`` for each calibrated field
    (``ServedModel.add_bands``); an artifact without calibration gets a 400,
    as the JAX server answers. Every error is a JSON 400 with a diagnostic.
    Requests are padded to power-of-two buckets (``ServedModel.bucket_size``).

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
                out = served.predict(x, pad_to_bucket=True)
                if want_bands:
                    out = served.add_bands(out)
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
