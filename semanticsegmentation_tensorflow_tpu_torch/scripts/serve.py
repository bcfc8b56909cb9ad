"""Inference server of the PyTorch port: HTTP image in -> overlay PNG (or
label map) out. Same request contract as the JAX package's scripts/serve.py.

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.serve \
        --preset fcn8s_kitti --weights fcn8s.pt --port 8500

    curl -s -X POST --data-binary @image.png localhost:8500/segment > out.png
    curl -s -X POST --data-binary @image.png localhost:8500/labels > labels.png
    curl -s localhost:8500/healthz
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time


def encode_png(arr) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (PIL, fastest deflate level)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def make_handler(predictor, stats):
    from http.server import BaseHTTPRequestHandler

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
        host_overlay,
    )

    stats_lock = threading.Lock()  # += on a dict value is not atomic

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # an idle keep-alive client must not hold a worker forever
        timeout = 60

        def log_message(self, fmt, *a):  # quiet; stats carry the signal
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = dict(stats, status="ok")
                self._send(200, json.dumps(payload).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            if self.path not in ("/segment", "/labels"):
                if n:  # drain, or the keep-alive connection desyncs
                    self.rfile.read(n)
                self._send(404, b"not found", "text/plain")
                return
            if not n:
                self._send(400, b"empty body", "text/plain")
                return
            raw = self.rfile.read(n)
            try:
                img = Image.open(io.BytesIO(raw)).convert("RGB")
            except Exception as e:  # noqa: BLE001 - client error
                self._send(400, f"bad image: {e}".encode(), "text/plain")
                return
            # the pipeline runs at the preset size; resize like the loader
            hs, ws = predictor.image_size
            if img.size != (ws, hs):
                img = img.resize((ws, hs), Image.BILINEAR)
            t0 = time.perf_counter()
            # fetch only the packed label map and composite on the host
            img_np = np.asarray(img, np.uint8)
            labels = predictor._fetch_labels(img_np[None])[0]
            dt = time.perf_counter() - t0
            with stats_lock:
                stats["requests"] += 1
                stats["last_ms"] = round(dt * 1e3, 2)
            if self.path == "/segment":
                overlay = host_overlay(img_np, labels, predictor._palette,
                                       predictor._alpha)
                self._send(200, encode_png(overlay), "image/png")
            else:
                lab3 = np.repeat(labels.astype(np.uint8)[..., None], 3, -1)
                self._send(200, encode_png(lab3), "image/png")

    return Handler


def make_server(argv=None):
    """Parse the CLI, build the predictor (warming it up unless
    ``--no-warmup``) and bind the server, which carries ``predictor`` and
    ``stats``. Returns (server, args); the caller runs
    ``server.serve_forever()`` and closes it."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor, check_unported, resolve_device,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run one request's pipeline before accepting requests")
    args = p.parse_args(argv)
    check_unported(args)
    device = resolve_device(args.device)

    import numpy as np
    from http.server import ThreadingHTTPServer

    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
        host_overlay,
    )

    predictor = build_predictor(args, device)
    if args.warmup:  # pay the kernel build and cuDNN setup before serving
        hs, ws = predictor.image_size
        dummy = np.zeros((hs, ws, 3), np.uint8)
        labels = predictor._fetch_labels(dummy[None])[0]
        encode_png(host_overlay(dummy, labels, predictor._palette,
                                predictor._alpha))
    stats = {"requests": 0, "last_ms": None}
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(predictor, stats))
    server.predictor, server.stats = predictor, stats
    return server, args


def main(argv=None) -> int:
    server, args = make_server(argv)
    host, port = server.server_address[:2]
    print(f"serving {args.preset} on http://{host}:{port} "
          "(POST /segment | /labels, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
