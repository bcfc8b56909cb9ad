#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``semanticsegmentation_tensorflow_tpu_torch/csrc``
into ``build/kernels/``, checks each against its plain PyTorch version on the
card at the shapes the inference path gives it, then drives that path at the
full width of the ``fcn8s_kitti`` preset (seeded random weights, full KITTI
resolution): ``infer_image`` on a generated PNG, the ``serve`` handler
answering requests, and one forward at ``fcn8s_kitti_parity`` (fc 4096). It
reads the kernels' launch counters around that run, compares the whole
forward with the kernels against the same forward on plain PyTorch, and
prints timings. Any failure exits non-zero. The last three lines are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "semanticsegmentation_tensorflow_tpu_torch"
IMAGE_HW = (375, 1242)      # KITTI road; the model sees it padded to 384x1248
PADDED_HW = (384, 1248)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one ``fn()`` in ms, by CUDA events around ``iters``
    calls back to back. Where a call's host work (Python, launches) takes
    longer than its device work, this is the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, int]:
    """Device time of one ``fn()`` in ms: the summed duration of every GPU
    op it launches (kernels, copies), from torch.profiler, mean over
    ``iters`` calls; host launch cost excluded. Also the ops per call."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore")  # "clears events at each cycle"
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise AssertionError("the profiler saw no device op")
    return (sum(e.self_device_time_total for e in ops) / 1e3 / iters,
            len(ops) // iters)


def ab_ms(plain, kernel) -> dict:
    """Kernel against plain, in turns (plain, kernel, kernel, plain): device
    time per call (the reported number) and event-timed wall per call."""
    p1, k1, k2, p2 = (device_ms(f)[0] for f in (plain, kernel, kernel, plain))
    w = [cuda_ms(f) for f in (plain, kernel, kernel, plain)]
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "wall_ms": (w[1] + w[2]) / 2, "plain_wall_ms": (w[0] + w[3]) / 2}


def show_ab(what: str, t: dict) -> None:
    log(f"{what}: device kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; "
        f"wall per call {t['wall_ms']:.4f} ms, plain {t['plain_wall_ms']:.4f} ms")


def check_stage1(torch, gen) -> dict:
    """Kernel A against its plain version: the slice's shape, small ragged
    shapes (odd batch, partial tiles, narrow channels) and an exact tie case.

    Tolerance (random cases): both versions accumulate in f32 and round the
    conv to bf16, in another order, so a conv value may differ by one bf16
    ulp (<= 2^-7 relative); the bf16 bias add may add one more. Bound:
    |kernel - plain| <= 2^-6 * (|plain| + |b2|) + 1e-6, element-wise."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        stage1_tail, stage1_tail_plain,
    )

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    def compare(n, h, w, c, what):
        z1 = rand((n, h, w, c), 1.0)
        # channels_last, as the Predictor's cast leaves the model's weights
        k2 = rand((c, c, 3, 3), (1.0 / (9 * c)) ** 0.5).contiguous(
            memory_format=torch.channels_last)
        b2 = rand((c,), 0.1)
        got = stage1_tail(z1, k2, b2).float()
        want = stage1_tail_plain(z1, k2, b2).float()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"stage1 {what}: bad output {tuple(got.shape)}")
        err = (got - want).abs()
        bound = 2 ** -6 * (want.abs() + b2.float().abs()) + 1e-6
        bad = int((err > bound).sum())
        log(f"stage1 {what} [{n},{h},{w},{c}]: max_abs_err {err.max().item():.6g}"
            f" (max |plain| {want.abs().max().item():.4g}), {bad} outside the bound")
        if bad:
            raise AssertionError(f"stage1 {what}: {bad} elements outside the bound")
        return z1, k2, b2, err.max().item()

    z1, k2, b2, main_err = compare(1, *PADDED_HW, 64, "main")
    compare(3, 12, 40, 64, "odd batch, partial tiles")
    compare(1, 6, 34, 16, "C=16")
    compare(1, 8, 64, 32, "C=32")
    compare(2, 10, 66, 48, "C=48")

    # integer-valued inputs: every sum is exact in f32 and in bf16's integer
    # range, so both versions must agree bit for bit, ties included
    ig = torch.Generator().manual_seed(1)
    zi = torch.randint(-2, 3, (2, 16, 48, 64), generator=ig).to("cuda", torch.bfloat16)
    ki = torch.randint(-1, 2, (64, 64, 3, 3), generator=ig)
    ki[:, :, 1] = ki[:, :, 0]          # repeated taps -> many pooling ties
    ki = ki.to("cuda", torch.bfloat16)
    bi = torch.randint(-1, 2, (64,), generator=ig).to("cuda", torch.bfloat16)
    got, want = stage1_tail(zi, ki, bi), stage1_tail_plain(zi, ki, bi)
    if not torch.equal(got, want):
        raise AssertionError("stage1 tie case: kernel != plain "
                             f"({int((got != want).sum())} elements)")
    log("stage1 integer tie case: exact")

    t = ab_ms(lambda: stage1_tail_plain(z1, k2, b2),
              lambda: stage1_tail(z1, k2, b2))
    show_ab(f"stage1 at [1,{PADDED_HW[0]},{PADDED_HW[1]},64]", t)
    return {"max_abs_err": main_err, "ms": t["ms"], "plain_ms": t["plain_ms"]}


def check_overlay(torch, gen) -> dict:
    """Kernel B against its plain version: exact labels and exact bytes
    (the kernel rounds the blend like the plain version, without FMA)."""
    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_cuda, argmax_colormap_overlay_plain,
    )

    h, w = IMAGE_HW
    result = {}
    for c, palette, alpha, blend0 in ((2, KITTI_OVERLAY_PALETTE, 0.5, False),
                                      (5, CITYSCAPES_PALETTE[:5], 0.7, True)):
        img = torch.randint(0, 256, (1, h, w, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
        logits = torch.randn((1, *PADDED_HW, c), generator=gen, device="cuda")
        tie = torch.rand((1, *PADDED_HW), generator=gen, device="cuda") < 0.1
        logits[..., 1] = torch.where(tie, logits[..., 0], logits[..., 1])
        pal = torch.as_tensor(palette, device="cuda")
        ov_k, lab_k = argmax_colormap_overlay_cuda(img, logits, pal, alpha, blend0)
        ov_p, lab_p = argmax_colormap_overlay_plain(
            img, logits[:, :h, :w], pal, alpha, blend0)
        torch.cuda.synchronize()
        if not torch.equal(lab_k, lab_p):
            raise AssertionError(f"overlay C={c}: labels differ at "
                                 f"{int((lab_k != lab_p).sum())} pixels")
        err = (ov_k.int() - ov_p.int()).abs().max().item()
        if err:
            raise AssertionError(f"overlay C={c}: bytes differ (max {err})")
        log(f"overlay C={c} [1,{h},{w}] from padded logits: labels and bytes "
            f"exact ({int(tie.sum())} tied pixels injected)")
        if c == 2:
            t = ab_ms(
                lambda: argmax_colormap_overlay_plain(
                    img, logits[:, :h, :w], pal, alpha, blend0),
                lambda: argmax_colormap_overlay_cuda(img, logits, pal, alpha, blend0))
            show_ab(f"overlay at [1,{h},{w}], C=2", t)
            result = {"max_abs_err": float(err), "ms": t["ms"],
                      "plain_ms": t["plain_ms"]}
    return result


def write_png(path: str, seed: int) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    # smooth structure plus noise, so the labels are not all one class
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // w), (yy * 255 // h),
                     ((xx + yy) * 255 // (h + w))], -1)
    noise = rng.integers(-40, 41, (h, w, 3))
    Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8)).save(path)


def drive_slice(torch, tmp: str) -> dict:
    """The main path through the user's entry points. Returns timings."""
    import http.client

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image, serve
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    times = {}
    png = os.path.join(tmp, "kitti_like.png")
    out = os.path.join(tmp, "overlay.png")
    write_png(png, seed=0)

    # 1. infer_image, as a user runs it (random weights, fcn8s_kitti)
    t0 = time.perf_counter()
    rc = infer_image.main(["--image", png, "--out", out, "--device", "cuda"])
    torch.cuda.synchronize()
    times["infer_image_main_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"infer_image returned {rc}")
    ov = np.asarray(Image.open(out))
    if ov.shape != (*IMAGE_HW, 3) or ov.dtype != np.uint8:
        raise AssertionError(f"infer_image wrote {ov.shape} {ov.dtype}")
    log(f"infer_image: wrote {ov.shape} overlay in "
        f"{times['infer_image_main_s']:.3f} s (model build, random init, "
        "decode, forward, encode)")

    # 2. the server, in a thread, answering real HTTP requests
    server, _ = serve.make_server(["--device", "cuda", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        pred = server.predictor
        body = open(png, "rb").read()
        img = np.asarray(Image.open(png).convert("RGB"))
        want_labels = pred._fetch_labels(img[None])[0]
        want_overlay = host_overlay(img, want_labels, pred._palette, pred._alpha)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=300)
        req_ms = {"/segment": [], "/labels": []}
        for path in ["/segment"] * 3 + ["/labels"] * 2:
            t0 = time.perf_counter()
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            data = r.read()
            req_ms[path].append((time.perf_counter() - t0) * 1e3)
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status}")
            got = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            want = (want_overlay if path == "/segment"
                    else np.repeat(want_labels[..., None], 3, -1))
            if not np.array_equal(got, want):
                raise AssertionError(f"{path}: response differs from the "
                                     "Predictor's answer")
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        conn.close()
        if r.status != 200 or health.get("status") != "ok" \
                or health.get("requests") != 5:
            raise AssertionError(f"/healthz: {r.status} {health}")
        log(f"serve: 3x /segment {['%.2f' % t for t in req_ms['/segment']]} ms, "
            f"2x /labels {['%.2f' % t for t in req_ms['/labels']]} ms "
            f"(client wall, PNG decode + forward + label fetch + host blend + "
            f"PNG encode); /healthz {health}")
        times["segment_ms"] = float(np.median(req_ms["/segment"]))
        times["labels_ms"] = float(np.median(req_ms["/labels"]))

        # steady-state Predictor calls on the same model (host clock around
        # work that ends in a device->host copy)
        for name, fn in (("predictor_overlay_ms", lambda: pred(img)),
                         ("predictor_labels_ms",
                          lambda: pred._fetch_labels(img[None]))):
            fn()
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            times[name] = float(np.median(ts))
        dev, ops = device_ms(lambda: pred(img), iters=10)
        times["predictor_overlay_device_ms"] = dev
        log(f"Predictor fcn8s_kitti, 1x{IMAGE_HW[0]}x{IMAGE_HW[1]}: overlay "
            f"{times['predictor_overlay_ms']:.3f} ms/image, packed labels "
            f"{times['predictor_labels_ms']:.3f} ms/image (host clock, median "
            f"of 10); overlay call on the device {dev:.3f} ms in {ops} ops, "
            f"idle share {1 - dev / times['predictor_overlay_ms']:.2f}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # 3. the reference-exact width (fc 4096), one Predictor forward
    from argparse import ArgumentParser

    p = ArgumentParser()
    add_model_args(p)
    args = p.parse_args(["--preset", "fcn8s_kitti_parity", "--device", "cuda"])
    pred = build_predictor(args, torch.device("cuda"))
    overlay, labels = pred(img)
    if overlay.shape != (*IMAGE_HW, 3) or labels.shape != IMAGE_HW:
        raise AssertionError("fcn8s_kitti_parity: bad output shapes")
    t0 = time.perf_counter()
    pred(img)
    times["parity_overlay_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"Predictor fcn8s_kitti_parity (fc 4096): overlay "
        f"{times['parity_overlay_ms']:.3f} ms/image (second call)")
    del pred
    return times


def check_end_to_end(torch) -> None:
    """The full fcn8s_kitti forward with the kernels against the same
    forward on plain PyTorch (stage1 as a PooledConvBlock of cuDNN convs and
    max_pool, overlay by the plain version), same weights, same image, bf16
    on the card.

    Tolerance: the two differ only where a stage1 conv value rounds to the
    neighbouring bf16 value; that one-ulp change then passes through 13 more
    bf16 layers. Bound: max |dlogits| <= 0.03 * max |logits|, and labels
    agreeing on >= 99.5 % of pixels (a pixel whose two logits are nearly
    equal may flip)."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_plain,
    )

    dev = torch.device("cuda")
    fused = build_model("fcn8s", 2, device=dev)
    init_params(fused, torch.Generator(device=dev).manual_seed(3))
    plain = build_model("fcn8s", 2, device=dev, packed_stage1=False)
    plain.load_state_dict(fused.state_dict())
    pk = Predictor(fused, IMAGE_HW, device=dev)
    pp = Predictor(plain, IMAGE_HW, device=dev)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1, *IMAGE_HW, 3), np.uint8)
    x = pk._to_device(img)
    lk = pk._padded_logits(x)
    lp = pp._padded_logits(x)
    if lk.shape != (1, *PADDED_HW, 2) or not torch.isfinite(lk).all():
        raise AssertionError(f"logits {tuple(lk.shape)} not finite/expected")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    ov_k, lab_k = pk._fwd(x)
    h, w = IMAGE_HW
    ov_p, lab_p = argmax_colormap_overlay_plain(x, lp[:, :h, :w], pp._palette_dev,
                                                pp._alpha)
    agree = (lab_k == lab_p).float().mean().item()
    log(f"end to end fcn8s_kitti, kernels vs plain: max |dlogits| / max |logits| "
        f"= {rel:.4g} (bound 0.03), labels agree on {100 * agree:.4f} % "
        f"(bound 99.5 %), road fraction {lab_k.float().mean().item():.3f}")
    if rel > 0.03 or agree < 0.995:
        raise AssertionError("end-to-end check failed")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
            argmax_colormap_overlay_cuda,
        )
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
            stage1_tail,
        )
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    if not os.path.abspath(build.__file__).startswith(os.path.join(REPO, PKG)):
        print(f"chip_smoke: the port package was imported from {build.__file__},"
              " not from this checkout", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.lib()
    log(f"kernels built from {[s.name for s in build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s -> {build.library_path()}")
    for line in build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    stage1 = check_stage1(torch, gen)
    overlay = check_overlay(torch, gen)

    stage1_tail.launches = 0
    argmax_colormap_overlay_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        times = drive_slice(torch, tmp)
    launches = {"stage1_tail": stage1_tail.launches,
                "overlay": argmax_colormap_overlay_cuda.launches}
    log(f"kernel launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")

    check_end_to_end(torch)
    log("timings (s or ms as named): " + json.dumps(times))

    kernels = [
        dict(name="stage1_tail", route="cuda",
             source=f"{PKG}/csrc/stage1_tail.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:155",
             launches=launches["stage1_tail"], **stage1),
        dict(name="argmax_colormap_overlay", route="cuda",
             source=f"{PKG}/csrc/overlay.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/overlay.py:29",
             launches=launches["overlay"], **overlay),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
