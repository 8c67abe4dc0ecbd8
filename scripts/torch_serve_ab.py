#!/usr/bin/env python3
"""Run chip_smoke.py's phase 7 (the serve entry point) from one checkout on
one GPU.

    python3 scripts/torch_serve_ab.py [ROOT]

Imports chip_smoke.py and sagemaker_xgboost_container_tpu_torch from ROOT
(a checkout of the repository; default: the one holding this script) and
runs its `run_serve` alone: train the served model, serve it with
`serving_entrypoint`, and measure the latency loads. Then it times the app
that `serving_entrypoint` serves in process, without HTTP or threads: 1-row
csv `/invocations` and `/ping` calls, one at a time, on a 100-round depth-8
model trained on 20,000 rows, which isolates the host cost a request pays in
the app and its middleware. Prints phase 7's lines, each prefixed with
ROOT, then one JSON line with the p50 / p95 / p99 ms and requests/s of each
load and the in-process microseconds a call (median and p90).

To compare two checkouts on one card, run it in turns in one command: A, B,
B, A. Needs one CUDA GPU.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile
import time
from wsgiref.util import setup_testing_defaults

import numpy as np

LOAD_LINE = re.compile(
    r"serve (\d+) rows, (\d+) client thread\(s\) x (\d+) requests \(([^)]*)\): p50 ([\d.]+) ms, "
    r"p95 ([\d.]+) ms, p99 ([\d.]+) ms; ([\d.]+) requests/s")


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), os.pardir))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import sagemaker_xgboost_container_tpu_torch as pkg
    from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist

    tag = smoke.card_tag()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        smoke.run_serve(torch, pkg, hist, tag)
    loads = []
    for line in out.getvalue().splitlines():
        print("{}: {}".format(root, line))
        m = LOAD_LINE.search(line)
        if m:
            loads.append({"rows": int(m.group(1)), "threads": int(m.group(2)),
                          "requests": int(m.group(3)), "clients": m.group(4),
                          "p50_ms": float(m.group(5)), "p95_ms": float(m.group(6)),
                          "p99_ms": float(m.group(7)), "requests_per_s": float(m.group(8))})
    in_process = wsgi_cost(torch, pkg, smoke)
    print(json.dumps({"root": root, "card": tag, "loads": loads, "in_process_us": in_process}))
    return 0


def _call(app, method, path, body=b""):
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "CONTENT_TYPE": "text/csv",
               "HTTP_ACCEPT": "text/csv", "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    setup_testing_defaults(environ)
    status = []
    result = app(environ, lambda s, headers, exc_info=None: status.append(s))
    try:
        out = b"".join(result)
    finally:
        close = getattr(result, "close", None)
        if close is not None:
            close()
    return status[0], out


def wsgi_cost(torch, pkg, smoke, calls=3000, warm=300, device="cuda"):
    """Median and p90 microseconds of one in-process call of the app that
    `serving_entrypoint` serves (its lifecycle and middleware included, as
    the checkout has them): 1-row csv /invocations, then /ping."""
    from sagemaker_xgboost_container_tpu_torch.data.matrix import DataMatrix
    from sagemaker_xgboost_container_tpu_torch.serving import server

    X, y = smoke.make_data(20_000, smoke.N_FEATURES, seed=3)
    forest = pkg.train(smoke.MAIN_PARAMS, DataMatrix(X, y), 100, device=device,
                       verbose_eval=False)
    out = {}
    with tempfile.TemporaryDirectory(prefix="serve_ab_") as tmp:
        forest.save_model(os.path.join(tmp, "xgboost-model"))
        os.environ["SM_MODEL_DIR"] = tmp
        httpd = server.serving_entrypoint(port=0, block=False, device=device)
        try:
            app = httpd.get_app()
            if app.service.warmup is not None:
                app.service.warmup.join(60)
            body = smoke._csv_body(X[:1])
            for name, method, path, payload in (("invocations_1row", "POST", "/invocations",
                                                 body), ("ping", "GET", "/ping", b"")):
                lat = []
                for i in range(warm + calls):
                    t = time.perf_counter()
                    status, _ = _call(app, method, path, payload)
                    if i >= warm:
                        lat.append((time.perf_counter() - t) * 1e6)
                    if not status.startswith("200"):
                        raise RuntimeError("{} answered {}".format(path, status))
                p50, p90 = np.percentile(lat, [50, 90])
                out[name] = {"p50": round(float(p50), 2), "p90": round(float(p90), 2)}
        finally:
            httpd.server_close()
            try:
                from sagemaker_xgboost_container_tpu_torch.serving import lifecycle
            except ImportError:  # a checkout from before the serving lifecycle
                lifecycle = None
            if lifecycle is not None:
                lifecycle.uninstall()
    return out


if __name__ == "__main__":
    sys.exit(main())
