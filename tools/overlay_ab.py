#!/usr/bin/env python3
"""Kernel 2 (the overlay, ``csrc/overlay.cu``) of two checkouts of the port,
and of kernel variants, timed in turns on one CUDA card.

    python tools/overlay_ab.py --base DIR [--variant NAME=FILE.cu ...] \
        [--out build/overlay_ab.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), this one is the change. Each
``--variant`` is one overlay source with the same C entry
(``seg_overlay``): it is built alone with ``csrc/common.cu`` into
``build/kernels/`` and called through this checkout's wrapper, which is how
a scratch variant of the kernel (one suspect switched off or changed) is
timed without building the whole library again.

At the rows of ``ROWS`` (one KITTI image and a batch of 8 with two classes,
from the padded [N,384,1248,2] logits the FCN Predictor gives the kernel,
and one image with 19 classes, the Cityscapes palette and
``blend_class0=True``), on seeded inputs with tied logits, each version
gives the device time per call (torch.profiler, 50 calls after one
warm-up), the wall per call of 200 launches back to back (CUDA events; the
wrapper's host work included) and whether its labels and bytes equal the
plain version's. Each version runs in a process of its own (a checkout
with its own kernel build under its ``build/``), in turns base, change,
variants, variants reversed, change, base; a version's time is the mean of
its turns. Beside them, in this process: the plain version
(``ops/overlay.py``) and a yardstick, a device-to-device ``copy_`` of half
the kernel's bytes (it reads and writes as many bytes as the kernel moves,
but computes nothing: there is no one PyTorch call for the overlay), both
by torch.profiler, and the bound (``work``: each input byte read once, each
output byte written once, over 3.35 TB/s). Prints a table and writes JSON.
Imports nothing of JAX. ``work`` is also what ``chip_smoke.py`` reckons the
overlay's bound with.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_HW = (375, 1242)      # KITTI road
PADDED_HW = (384, 1248)     # the FCN's logits, padded to a multiple of 32
# name: (batch, classes, palette, alpha, blend_class0)
ROWS = {"b1_c2": (1, 2, "kitti", 0.5, False),
        "b8_c2": (8, 2, "kitti", 0.5, False),
        "b1_c19": (1, 19, "cityscapes", 0.5, True)}


def work(n: int, h: int, w: int, c: int) -> int:
    """Bytes the overlay moves at [n,h,w] with c classes: the f32 logits of
    the [h,w] window and the u8 image read once, the u8 overlay and the
    int32 labels written once (4c + 3 + 3 + 4 bytes a pixel)."""
    return n * h * w * (4 * c + 10)


def row_bound(n: int, h: int, w: int, c: int) -> dict:
    """``chip_smoke.bound`` of the overlay's bytes (it does no work worth
    counting against the card's peak rates)."""
    sys.path.insert(0, REPO)
    from chip_smoke import bound

    return bound(work(n, h, w, c))


def inputs(torch, n: int, c: int, palette: str):
    """Seeded image, padded logits (class 1 tied with class 0 at a tenth of
    the pixels) and palette on the card."""
    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE,
    )

    gen = torch.Generator(device="cuda").manual_seed(n * 100 + c)
    img = torch.randint(0, 256, (n, *IMAGE_HW, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    logits = torch.randn((n, *PADDED_HW, c), generator=gen, device="cuda")
    tie = torch.rand((n, *PADDED_HW), generator=gen, device="cuda") < 0.1
    logits[..., 1] = torch.where(tie, logits[..., 0], logits[..., 1])
    pal = KITTI_OVERLAY_PALETTE if palette == "kitti" else CITYSCAPES_PALETTE[:c]
    return img, logits, torch.as_tensor(pal, device="cuda")


def events_ms(torch, fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean time of one ``fn()`` in ms by CUDA events around ``iters``
    calls back to back (the host's time per call where it is the longer)."""
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


def install_variant(src: str) -> str:
    """Build the overlay source ``src`` alone (with ``csrc/common.cu``) and
    make it the library the wrapper calls; returns ptxas's report."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    srcs = [os.path.abspath(src), str(build.CSRC / "common.cu")]
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = build.BUILD_DIR / f"overlay_variant_{h.hexdigest()[:16]}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), *srcs],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in ("seg_overlay", "seg_error_string"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build._SIGNATURES[name]
    build._lib = lib
    return r.stdout + r.stderr


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register and spill lines for the overlay kernels."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "overlay" in entry and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out


def worker(root: str, kernel: str | None) -> dict:
    """The overlay rows of the checkout at ``root`` (ms), with the variant
    source ``kernel`` in place of its ``csrc/overlay.cu`` if given."""
    sys.path[:0] = [root, os.path.join(REPO, "tools")]
    import torch

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import overlay as ov

    # after the port: profile_train puts this checkout first on the path
    from profile_train import profile_device

    assert os.path.abspath(ov.__file__).startswith(os.path.abspath(root))
    if kernel:
        log = install_variant(kernel)
    else:
        build.lib()
        log = build.build_log()
    res = {"ptxas": ptxas_lines(log)}
    for name, (n, c, palette, alpha, blend0) in ROWS.items():
        img, logits, pal = inputs(torch, n, c, palette)
        h, w = IMAGE_HW
        fn = lambda: ov.argmax_colormap_overlay_cuda(img, logits, pal, alpha, blend0)
        got, lab = fn()
        want, want_lab = ov.argmax_colormap_overlay_plain(
            img, logits[:, :h, :w], pal, alpha, blend0)
        res[f"{name}_exact"] = bool(torch.equal(got, want) and torch.equal(lab, want_lab))
        res[name] = profile_device(torch, fn, 50)["device_ms"]
        res[f"{name}_wall"] = events_ms(torch, fn)
    return res


def library(torch) -> dict:
    """In this process: the plain version and the copy yardstick of each
    row, device ms by torch.profiler."""
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    from profile_train import profile_device

    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
        argmax_colormap_overlay,
    )

    res = {}
    h, w = IMAGE_HW
    for name, (n, c, palette, alpha, blend0) in ROWS.items():
        img, logits, pal = inputs(torch, n, c, palette)
        crop = logits[:, :h, :w]
        res[f"{name}_plain"] = profile_device(
            torch, lambda: argmax_colormap_overlay(img, crop, pal, alpha, blend0),
            20)["device_ms"]
        src = torch.empty(work(n, h, w, c) // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        res[f"{name}_copy"] = profile_device(torch, lambda: dst.copy_(src),
                                             50)["device_ms"]
    return res


def turns(variants: list[str]) -> list[str]:
    """The order of the workers: base, change, the variants, the variants
    reversed, change, base (each version twice, in mirrored turns)."""
    return ["base", "change", *variants, *variants[::-1], "change", "base"]


def run_worker(root: str, kernel: str | None) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root]
                         + (["--kernel", kernel] if kernel else []),
                         cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"worker for {root} {kernel or ''} failed:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout (the parent)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=FILE.cu",
                    help="an overlay source timed through this checkout's wrapper")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "overlay_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--kernel", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.kernel)))
        return 0
    import torch

    if not args.base:
        ap.error("--base is required")
    if not torch.cuda.is_available():
        print("overlay_ab: no CUDA device", file=sys.stderr)
        return 2
    variants = dict(v.split("=", 1) for v in args.variant)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    order = turns(list(variants))
    runs = {who: [] for who in dict.fromkeys(order)}
    for who in order:
        if who in ("base", "change"):
            root = os.path.abspath(args.base) if who == "base" else REPO
            runs[who].append(run_worker(root, None))
        else:
            runs[who].append(run_worker(REPO, os.path.abspath(variants[who])))
    lib = library(torch)
    h, w = IMAGE_HW
    rows = {}
    print(f"overlay (kernel 2), change {REPO} vs base {os.path.abspath(args.base)} "
          f"({smi}); turns {' '.join(order)}; device ms by torch.profiler, "
          "wall per call by CUDA events")
    for who, rs in runs.items():
        print(f"  {who} ptxas: {'; '.join(rs[0]['ptxas']) or 'not reported'}")
    for name, (n, c, _, _, blend0) in ROWS.items():
        b = row_bound(n, h, w, c)
        rows[name] = {who: {"ms": sum(r[name] for r in rs) / len(rs),
                            "wall_ms": sum(r[f"{name}_wall"] for r in rs) / len(rs),
                            "exact": all(r[f"{name}_exact"] for r in rs),
                            "turns": [r[name] for r in rs]}
                      for who, rs in runs.items()}
        rows[name].update(bound=b, plain_ms=lib[f"{name}_plain"],
                          copy_ms=lib[f"{name}_copy"])
        print(f"  [{n},{h},{w}] C={c}{' blend_class0' if blend0 else ''}: bound "
              f"{b['bound_ms']:.4f} ({work(n, h, w, c) / 1e6:.2f} MB); copy_ of "
              f"{work(n, h, w, c) / 2e6:.2f} MB {lib[f'{name}_copy']:.4f}; plain "
              f"{lib[f'{name}_plain']:.4f}")
        for who in runs:
            r = rows[name][who]
            print(f"    {who}: {r['ms']:.4f} (turns "
                  + " ".join(f"{t:.4f}" for t in r["turns"])
                  + f"), {100 * b['bound_ms'] / r['ms']:.1f} % of the bound, wall "
                  f"{r['wall_ms']:.4f}, {'exact' if r['exact'] else 'NOT EXACT'}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "turns": order, "variants": variants, "runs": runs,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
