#!/usr/bin/env python3
"""The port's ``/segment`` and ``/labels`` latency in two checkouts, timed in
turns on one CUDA card.

    python tools/serve_ab.py --base DIR [--presets fcn8s_kitti,segnet_kitti] \
        [--requests 10] [--out build/serve_ab.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), this one is the change. Each
checkout runs in a process of its own (its own kernel and segio builds
under its ``build/``), in turns base, change, change, base. In each, for
every preset, the port's server (``scripts/serve.make_server``, seeded random
weights, warmed up) answers ``--requests`` POSTs of one generated KITTI-like
PNG (375x1242) on each endpoint over one keep-alive connection; the number is
the median client wall per request (PNG decode, forward, packed-label fetch,
host blend, PNG encode, the HTTP round trip). Each response is checked: its
pixels equal the Predictor's answer for the image. Then the in-process
Predictor's own host ms (median of 20 calls after a warm-up, each ending in
the device->host copy): its label fetch (``predictor_labels``) and its
overlay call (``predictor_overlay``). Prints a table with the card's name
and power limit and writes JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_HW = (375, 1242)
ENDPOINTS = ("/segment", "/labels")


def kitti_like_png(seed: int = 0) -> bytes:
    """A 375x1242 RGB PNG: smooth structure plus noise (so the labels are
    not all one class), saved by PIL at its default level as a camera
    frame would be."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // w), (yy * 255 // h),
                     ((xx + yy) * 255 // (h + w))], -1)
    img = np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def worker(root: str, presets: list[str], requests: int) -> dict:
    """Median ms per request of each endpoint of each preset, served by the
    checkout at ``root``."""
    sys.path.insert(0, root)
    import http.client

    import numpy as np
    import torch
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import serve

    assert os.path.abspath(serve.__file__).startswith(os.path.abspath(root))
    body = kitti_like_png()
    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    res = {}
    for preset in presets:
        server, _ = serve.make_server(["--preset", preset, "--device", "cuda",
                                       "--port", "0"])
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            pred = server.predictor
            labels = pred._fetch_labels(img[None])[0]
            want = {"/segment": host_overlay(img, labels, pred._palette,
                                             pred._alpha),
                    "/labels": np.repeat(labels[..., None], 3, -1)}
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.server_address[1], timeout=300)
            for path in ENDPOINTS:
                ts, size = [], 0
                for _ in range(requests + 1):       # the first is a warm-up
                    t0 = time.perf_counter()
                    conn.request("POST", path, body=body)
                    r = conn.getresponse()
                    data = r.read()
                    ts.append((time.perf_counter() - t0) * 1e3)
                    if r.status != 200:
                        raise AssertionError(f"{preset} {path}: HTTP {r.status}")
                    size = len(data)
                got = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                if not np.array_equal(got, want[path]):
                    raise AssertionError(f"{preset} {path}: response differs "
                                         "from the Predictor's answer")
                res[f"{preset} {path}"] = {"ms": statistics.median(ts[1:]),
                                           "ms_all": ts[1:], "bytes": size}
            conn.close()
            for key, fn in (("predictor_labels", lambda: pred._fetch_labels(img[None])),
                            ("predictor_overlay", lambda: pred(img))):
                fn()
                ts = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    fn()
                    ts.append((time.perf_counter() - t0) * 1e3)
                res[f"{preset} {key}"] = {"ms": statistics.median(ts), "ms_all": ts,
                                          "bytes": 0}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        del pred, server
        torch.cuda.empty_cache()
    return res


def run_worker(root: str, presets: list[str], requests: int) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                          root, "--presets", ",".join(presets), "--requests",
                          str(requests)], cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"worker for {root} failed:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout (the parent)")
    ap.add_argument("--presets", default="fcn8s_kitti,segnet_kitti")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "serve_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    presets = args.presets.split(",")
    if args.worker:
        print(json.dumps(worker(args.worker, presets, args.requests)))
        return 0
    import torch

    if not args.base:
        ap.error("--base is required")
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    order = ["base", "change", "change", "base"]
    runs = {"base": [], "change": []}
    for who in order:
        root = os.path.abspath(args.base) if who == "base" else REPO
        runs[who].append(run_worker(root, presets, args.requests))
    print(f"/segment and /labels, change {REPO} vs base "
          f"{os.path.abspath(args.base)} ({smi}); turns {' '.join(order)}; "
          f"median client ms of {args.requests} requests a turn")
    rows = {}
    for key in runs["base"][0]:
        rows[key] = {who: {"turns": [r[key]["ms"] for r in rs],
                           "bytes": rs[0][key]["bytes"]}
                     for who, rs in runs.items()}
        b, c = rows[key]["base"], rows[key]["change"]
        print(f"  {key}: base " + " ".join(f"{t:.2f}" for t in b["turns"])
              + f" ms ({b['bytes']} bytes), change "
              + " ".join(f"{t:.2f}" for t in c["turns"])
              + f" ms ({c['bytes']} bytes)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "turns": order, "requests": args.requests,
                   "runs": runs, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
