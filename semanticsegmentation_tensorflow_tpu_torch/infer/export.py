"""Serving artifacts: ``torch.export`` programs and their metadata in one file
(counterpart of the JAX package's ``infer/export.py``).

The serving host loads the programs and calls them: it needs no model code,
only the registrations of the kernel ops the programs call (the wrappers'
modules under ``ops/cuda/``, ``ops/cuda/library.py``), which import no
model.

Artifact layout (a zip, extension ``.segx``):

    meta.json             format ``segx-torch-1``, image size, classes,
                          platforms, batch mode and size, the entries'
                          files, the overlay palette and alpha
    labels_<platform>.pt2 ``torch.export`` program: u8 images [N,H,W,3] ->
                          the label map [N,H,W] (u8 up to 256 classes)
    overlay_<platform>.pt2 the same images -> (overlay u8 [N,H,W,3], labels
                          i32 [N,H,W]); palette and alpha baked in

Both entries run the in-process Predictor's pipeline (``predict.py``
``padded_logits`` and ``label_map``; the overlay op), so an artifact answers
bit for bit as the Predictor of the same weights on the same device does.
The weights stay lifted parameters of each program (placeholders fed from
its state_dict), not constants folded into the graph.

Each platform is traced on its own device: the code under the trace tests
the device in places (the card's s8 GEMM pads short matrices,
``ops/quant.py``; cuDNN's float32 sums, ``ops/winograd.py``), and a trace
keeps the branch its device took. The kernel ops are picked by the
dispatcher when the program runs, so a ``cuda`` program launches the
hand-written kernels and a ``cpu`` one runs their plain versions.

Batch: exported symbolic (``torch.export.Dim``) where the model traces under
a symbolic batch; a model that branches on the batch (DeepLab's dilated
convs, ``models/common.py`` ``dilated_form``; the int8 conv's patch budget,
``ops/quant.py``) falls back to a fixed batch (1, or ``batch_size``), and
the predictor pads a ragged batch by repeating its last image.
"""

from __future__ import annotations

import io
import json
import traceback
import warnings
import zipfile
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

# registers the kernel ops the programs call (the overlay's comes below)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import (  # noqa: F401
    pool, stage1, winograd,
)
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_OVERLAY_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.infer.predict import (
    inference_form, label_map, padded_logits,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_cuda,
)

FORMAT = "segx-torch-1"
JAX_FORMAT = "segx-1"     # the JAX package's artifacts (StableHLO)
ENTRIES = ("labels", "overlay")
_SYMBOLIC_EXAMPLE = 2     # a batch of 1 would specialise the dim


class _Entry(nn.Module):
    """One entry's program: the model with the Predictor's constants."""

    def __init__(self, model: nn.Module, image_size, mean, std, palette,
                 alpha: float, entry: str):
        super().__init__()
        self.model = model
        self.image_size = tuple(image_size)
        self.stride = getattr(model, "total_stride", 32)
        self.entry = entry
        self.alpha = float(alpha)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32))
        self.register_buffer("palette", torch.as_tensor(
            np.asarray(palette), dtype=torch.float32))

    def forward(self, image_u8: torch.Tensor):
        logits = padded_logits(self.model, image_u8, self.mean, self.std,
                               self.stride)
        if self.entry == "labels":
            return label_map(logits, self.image_size)
        return argmax_colormap_overlay_cuda(image_u8, logits, self.palette,
                                            self.alpha)


def _is_shape_constraint(e: Exception) -> bool:
    """Whether ``torch.export`` refused the symbolic batch (a guard on the
    batch that the trace met), the one failure that falls back to a fixed
    batch."""
    from torch._dynamo.exc import UserError, UserErrorType

    if isinstance(e, UserError):
        return e.error_type == UserErrorType.CONSTRAINT_VIOLATION
    # torch's report of a violated guard can itself fail on a bound of the
    # form b <= p/q (the int8 conv's patch budget, ops/quant.py); its frames
    # name the report
    return isinstance(e, AssertionError) and any(
        f.name == "prettify_results" for f in traceback.extract_tb(e.__traceback__))


def _export(module: nn.Module, device: torch.device, image_size,
            batch: int | None) -> bytes:
    """One traced program, serialized; ``batch`` None: symbolic."""
    h, w = image_size
    example = torch.zeros((batch or _SYMBOLIC_EXAMPLE, h, w, 3),
                          dtype=torch.uint8, device=device)
    dims = None if batch else ({0: torch.export.Dim("b", min=1)},)
    with torch.no_grad():
        ep = torch.export.export(module, (example,), dynamic_shapes=dims)
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # channels_last weights are saved whole with their strides
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(ep, buf)
    return buf.getvalue()


def export_model(model: nn.Module, image_size: tuple[int, int], path: str,
                 mean: Sequence[float] = (123.68, 116.779, 103.939),
                 std: Sequence[float] = (58.393, 57.12, 57.375),
                 overlay_palette: np.ndarray = KITTI_OVERLAY_PALETTE,
                 alpha: float = 0.5,
                 platforms: Sequence[str] = ("cpu", "cuda"),
                 batch_size: int | None = None,
                 num_classes: int | None = None) -> dict:
    """Write a ``.segx`` artifact of ``model`` at ``image_size``; returns its
    meta dict.

    The model is put in the Predictor's inference form (eval mode, the
    compute dtype, channels_last) on each platform's device in turn, and
    stays on the last one: as the Predictor does, this takes ownership of
    ``model``. ``platforms``: ``"cpu"`` and/or ``"cuda"``; ``"cuda"`` is
    traced on the card and raises without one. ``batch_size`` None tries a
    symbolic batch and falls back to batch 1; an int fixes the batch.
    """
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in ("cpu", "cuda")]
    if bad or not platforms:
        raise ValueError(f"platforms must be cpu and/or cuda, got {platforms}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("platform cuda: no CUDA device is available (the "
                           "cuda program is traced on the card)")
    num_classes = num_classes or model.num_classes
    modules = {e: _Entry(model, image_size, mean, std, overlay_palette, alpha, e)
               for e in ENTRIES}

    def programs(batch):
        out = {}
        for platform in platforms:
            device = torch.device(platform)
            inference_form(model, device)
            for e, module in modules.items():
                module.to(device)
                out[f"{e}_{platform}.pt2"] = _export(module, device, image_size,
                                                     batch)
        return out

    batch_mode = "symbolic" if batch_size is None else "fixed"
    try:
        files = programs(batch_size)
    except Exception as e:  # noqa: BLE001 - only the symbolic batch's guard
        if batch_size is not None or not _is_shape_constraint(e):
            raise
        batch_mode, batch_size = "fixed", 1
        files = programs(batch_size)

    meta = {
        "format": FORMAT,
        "image_size": list(image_size),
        "num_classes": int(num_classes),
        "platforms": list(platforms),
        "batch_mode": batch_mode,
        "batch_size": None if batch_mode == "symbolic" else batch_size,
        "entries": {e: {p: f"{e}_{p}.pt2" for p in platforms} for e in ENTRIES},
        "overlay_palette": np.asarray(overlay_palette).tolist(),
        "alpha": alpha,
        "torch": torch.__version__,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        for name, data in files.items():
            z.writestr(name, data)
    return meta


class ExportedPredictor:
    """Serve from a ``.segx`` artifact of the port: no model code, no trace.

    ``device`` picks the platform whose programs run (``"cpu"`` or
    ``"cuda"``); an artifact without that platform raises. The surface is
    the one ``scripts/serve.py`` drives on a :class:`Predictor`:
    ``image_size``, ``_palette``, ``_alpha``, ``_fetch_labels``; ``__call__``
    returns (overlay u8, labels i32) for [H,W,3] or [N,H,W,3] u8 images and
    :meth:`labels` the label map alone. A fixed-batch artifact pads a ragged
    batch by repeating its last image and refuses a larger one."""

    def __init__(self, path: str, device="cuda"):
        self.device = torch.device(device)
        with zipfile.ZipFile(path) as z:
            self.meta = json.loads(z.read("meta.json"))
            fmt = self.meta.get("format")
            if fmt != FORMAT:
                raise ValueError(
                    f"{path}: artifact format {fmt!r}; this package serves "
                    f"{FORMAT!r} artifacts (its scripts/export_model.py), not "
                    f"the JAX package's {JAX_FORMAT!r} (StableHLO)")
            platform = self.device.type
            if platform not in self.meta["platforms"]:
                raise ValueError(f"{path}: no {platform} program (platforms "
                                 f"{self.meta['platforms']})")
            if platform == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {device}: no CUDA device is available")
            self._fns = {e: torch.export.load(io.BytesIO(z.read(
                self.meta["entries"][e][platform]))).module() for e in ENTRIES}
        self.image_size = tuple(self.meta["image_size"])
        self._palette = np.asarray(self.meta["overlay_palette"], np.uint8)
        self._alpha = float(self.meta["alpha"])

    def _batched(self, entry: str, image_u8):
        squeeze = image_u8.ndim == 3
        if squeeze:
            image_u8 = image_u8[None]
        if tuple(image_u8.shape[1:3]) != self.image_size:
            raise ValueError(f"images must be {self.image_size}, got "
                             f"{tuple(image_u8.shape[1:3])}")
        n = image_u8.shape[0]
        fixed = self.meta["batch_size"]
        if fixed is not None:
            if n > fixed:
                raise ValueError(f"fixed-batch artifact (batch {fixed}) got {n}")
            if n < fixed:
                image_u8 = np.concatenate(
                    [image_u8, np.repeat(image_u8[-1:], fixed - n, axis=0)])
        x = torch.from_numpy(np.require(image_u8, np.uint8, "CW")).to(self.device)
        with torch.inference_mode():
            out = self._fns[entry](x)
        outs = [t[:n].cpu().numpy() for t in (out if isinstance(out, tuple)
                                              else (out,))]
        outs = [o[0] for o in outs] if squeeze else outs
        return tuple(outs) if isinstance(out, tuple) else outs[0]

    def __call__(self, image_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self._batched("overlay", np.asarray(image_u8))

    def labels(self, image_u8: np.ndarray) -> np.ndarray:
        return self._batched("labels", np.asarray(image_u8))

    def _fetch_labels(self, image_u8) -> np.ndarray:
        """The serving path's label fetch: [N,H,W,3] u8 -> [N,H,W] labels."""
        return self.labels(image_u8)
