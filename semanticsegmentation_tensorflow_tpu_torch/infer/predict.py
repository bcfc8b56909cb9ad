"""Prediction: overlay, label and confidence maps for a fixed image size, and
the test-set sweep (counterpart of the JAX package's ``infer/predict.py``).

Per batch: normalize, edge-pad to the model's stride, forward, then either
the fused argmax + colormap + blend (``__call__``: the CUDA overlay kernel
reads the padded logits in place, so the crop is free), the label map,
bit-packed on the device for the fetch (``_fetch_labels``: the serving path
and the sweep, which blend on the host), or the road confidence
(``confidence``). Only uint8 crosses the host boundary.

With ``mesh`` (a list of devices, the counterpart of the JAX Predictor's
one-process data mesh) the Predictor holds one replica of the model per
device, pads a ragged batch to the device count by repeating its last
image, runs each equal part on its device (all parts enqueued before any
result is fetched), and joins the results in order.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_OVERLAY_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.ops import labelpack
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_cuda,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
    labels_from_logits, palette_tensor,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import (
    crop_to, pad_to_multiple,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.replicas import (
    mesh_from, run_on_replicas,
)
from semanticsegmentation_tensorflow_tpu_torch.utils import tracing


def inference_form(model: nn.Module, device) -> nn.Module:
    """``model`` on ``device`` in eval mode with its parameters cast once,
    in place, to the compute dtype (``model.dtype``) and to channels_last
    memory: the form every conv (and the stage1 kernel) would otherwise
    convert them to on each call, so the same outputs without ~40 copy
    kernels per image. BatchNorm keeps its f32 parameters and statistics
    (``models.common.BatchNorm``), as flax does."""
    return model.to(torch.device(device), getattr(model, "dtype", None),
                    memory_format=torch.channels_last).eval()


def padded_logits(model: nn.Module, image_u8: torch.Tensor, mean: torch.Tensor,
                  std: torch.Tensor, stride: int) -> torch.Tensor:
    """[N,H,W,3] u8 -> padded [N,Hp,Wp,C] f32 logits, contiguous: normalize,
    edge-pad to ``stride``, forward. The Predictor and the exported programs
    (``infer/export.py``) both run it."""
    x = pad_to_multiple(normalize_images(image_u8, mean, std), stride)
    return model(x).contiguous()


def label_map(logits: torch.Tensor, image_size: Sequence[int]) -> torch.Tensor:
    """Padded logits -> the [N,H,W] label map of the image (ties to the
    lowest class), uint8 up to 256 classes, int32 beyond."""
    logits = crop_to(logits, *image_size)
    return labels_from_logits(logits).to(
        torch.uint8 if logits.shape[-1] <= 256 else torch.int32)


class Predictor:
    """Forward + overlay for a fixed image size on an explicit ``device``.

    ``model`` maps NHWC float input to NHWC float32 logits and carries
    ``num_classes`` (and ``total_stride``, default 32; ``dtype``, its
    compute dtype).

    The Predictor takes ownership of ``model`` (:func:`inference_form`: on
    ``device``, in eval mode, its parameters cast in place to the compute
    dtype and channels_last). The caller's module then holds bf16
    parameters, an inference-only form; to keep the f32 ones (for training,
    or to save them), pass a copy. A BatchNorm model runs on its running
    statistics.

    ``mesh``: devices to hold a replica each (module docstring), ``device``
    the first of them; one device is the plain Predictor."""

    def __init__(self, model: nn.Module, image_size: tuple[int, int], *,
                 device, mean: Sequence[float] = (123.68, 116.779, 103.939),
                 std: Sequence[float] = (58.393, 57.12, 57.375),
                 overlay_palette: np.ndarray = KITTI_OVERLAY_PALETTE,
                 alpha: float = 0.5, mesh: Sequence | None = None):
        mesh = mesh_from(device, mesh)
        self.device = mesh[0]
        # the other replicas copy the caller's model before it is cast
        self._replicas = [Predictor(copy.deepcopy(model), image_size, device=d,
                                    mean=mean, std=std,
                                    overlay_palette=overlay_palette, alpha=alpha)
                          for d in mesh[1:]]
        self.model = inference_form(model, self.device)
        self.image_size = tuple(image_size)
        self._stride = getattr(model, "total_stride", 32)
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self._palette = np.asarray(overlay_palette)
        self._palette_dev = palette_tensor(self._palette, self.device)
        self._alpha = alpha
        self._pack_mode = labelpack.pack_mode(model.num_classes)

    def _to_device(self, image_u8) -> torch.Tensor:
        """[N,H,W,3] u8, numpy or a tensor already on ``self.device``."""
        if tuple(image_u8.shape[1:3]) != self.image_size:
            raise ValueError(f"images must be {self.image_size}, got "
                             f"{tuple(image_u8.shape[1:3])}")
        if torch.is_tensor(image_u8):
            # _mean's device carries the index ("cuda" resolves to "cuda:0")
            if image_u8.device != self._mean.device:
                raise ValueError(f"images on {image_u8.device}, the Predictor "
                                 f"on {self._mean.device}")
            return image_u8
        # writable + contiguous (PIL arrays are read-only): copies only then
        with tracing.span("predict.upload"):
            return torch.from_numpy(np.require(image_u8, np.uint8, "CW")).to(
                self.device)

    @torch.inference_mode()
    def _padded_logits(self, image_u8: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] u8 on the device -> padded [N,Hp,Wp,C] f32 logits."""
        return padded_logits(self.model, image_u8, self._mean, self._std,
                             self._stride)

    @torch.inference_mode()
    def _fwd(self, image_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with tracing.span("predict.forward"):
            logits = self._padded_logits(image_u8)
        with tracing.span("predict.overlay"):
            return argmax_colormap_overlay_cuda(image_u8, logits,
                                                self._palette_dev, self._alpha)

    @torch.inference_mode()
    def _packed_labels(self, image_u8: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] u8 on the device -> the label map packed on the device
        (1 bit/px for 2 classes, a nibble up to 16, raw beyond)."""
        with tracing.span("predict.forward"):
            labels = label_map(self._padded_logits(image_u8), self.image_size)
            return labelpack.pack_labels(labels, self._pack_mode)

    @property
    def mesh_size(self) -> int:
        """The devices holding a replica (1 without a mesh)."""
        return 1 + len(self._replicas)

    def _map(self, fn, image_u8) -> list[np.ndarray]:
        """``fn(predictor, x)`` -> device tensors, over the replicas
        (``parallel/replicas.py``: a ragged batch padded by repeating its
        last image, one part per replica); the results fetched, joined in
        order and cut to the real batch."""
        outs, n = run_on_replicas(lambda p, x: fn(p, p._to_device(x)),
                                  [self, *self._replicas],
                                  [p._mean.device for p in (self, *self._replicas)],
                                  image_u8, pad=True)
        with tracing.span("predict.fetch"):
            if len(outs) == 1:
                return [t.cpu().numpy() for t in outs[0]]
            return [np.concatenate([o[j].cpu().numpy() for o in outs])[:n]
                    for j in range(len(outs[0]))]

    def _fetch_labels(self, image_u8) -> np.ndarray:
        """[N,H,W,3] u8 (numpy, or a tensor on the device) -> [N,H,W] label
        map: forward, pack on the device, fetch, unpack on the host."""
        with tracing.span("predict"):
            packed = self._map(lambda p, x: (p._packed_labels(x),), image_u8)[0]
            return labelpack.unpack_labels(packed, self.image_size[1],
                                           self._pack_mode)

    @torch.inference_mode()
    def confidence(self, image_u8: np.ndarray) -> np.ndarray:
        """[N,H,W] (or [H,W] for one image) uint8 road confidence,
        round(P(road) * 255): the KITTI road devkit's submission maps. The
        softmax runs in f32 on the device; ``torch.round`` rounds half to
        even, as ``jnp.round`` does. Binary models only."""
        if self.model.num_classes != 2:
            raise ValueError("confidence maps need a binary (num_classes=2) "
                             "model")
        squeeze = image_u8.ndim == 3
        with tracing.span("predict"):
            out = self._map(lambda p, x: (p._confidence(x),),
                            image_u8[None] if squeeze else image_u8)[0]
        return out[0] if squeeze else out

    @torch.inference_mode()
    def _confidence(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.span("predict.forward"):
            logits = crop_to(self._padded_logits(x), *self.image_size)
        p = torch.softmax(logits.float(), dim=-1)[..., 1]
        return torch.round(p * 255.0).to(torch.uint8)

    def __call__(self, image_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """[H,W,3] or [N,H,W,3] uint8 -> (overlay u8, labels i32), same rank."""
        squeeze = image_u8.ndim == 3
        if squeeze:
            image_u8 = image_u8[None]
        with tracing.span("predict"):
            overlay, labels = self._map(lambda p, x: p._fwd(x), image_u8)
        return (overlay[0], labels[0]) if squeeze else (overlay, labels)

    def predict_file(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        return self(load_image(path, self.image_size))


def _upload(predictor: Predictor, imgs: np.ndarray, stream):
    """A host batch onto ``predictor.device``: on a CUDA card by a pinned,
    non-blocking copy on the producer's side ``stream`` (so it overlaps the
    forward of the batch before), with an event the consumer waits on."""
    if stream is None:
        return predictor._to_device(imgs), None
    with torch.cuda.stream(stream):
        x = torch.from_numpy(imgs).pin_memory().to(predictor.device,
                                                   non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return x, done


def save_inference_samples(predictor: Predictor, image_paths: Iterable[str],
                           runs_dir: str = "runs", prefetch: int = 2,
                           batch_size: int = 1, writers: int = 2,
                           ) -> Iterator[tuple[str, str]]:
    """Run the test sweep: one overlay per image into runs/<timestamp>/.

    Yields (image_path, output_path) as each file lands, with three legs
    overlapped:

    * a producer thread decodes ahead (``load_image``), batches, pads a
      ragged last batch by repeating its last image, and uploads each batch
      to ``predictor.device`` (on a card, on a side stream);
    * the device runs the forward and returns only the packed label map
      (``Predictor._packed_labels``: 1 bit a pixel for two classes);
    * a writer pool composites the overlay on the host (``host_overlay``)
      and writes it (``utils.fastpng.write_png``; PIL by extension for a
      source that is not a PNG). The native calls and zlib release the GIL.

    Results come in input order once their file is on disk; a decode error
    is raised by the generator, a writer's error on the yield of its file.
    """
    import queue
    import threading

    out_dir = os.path.join(runs_dir, time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(out_dir, exist_ok=True)
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stream = (torch.cuda.Stream(predictor.device)
              if predictor.device.type == "cuda" else None)
    stop = threading.Event()   # the consumer is gone: the producer returns

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def producer() -> None:
        try:
            batch: list[tuple[str, np.ndarray]] = []

            def ship() -> None:
                imgs = np.stack([im for _, im in batch])
                if len(batch) < batch_size:  # the same shape for every batch
                    imgs = np.concatenate(
                        [imgs, np.repeat(imgs[-1:], batch_size - len(batch),
                                         axis=0)])
                put(([p for p, _ in batch], imgs,
                     *_upload(predictor, imgs, stream)))
                batch.clear()

            for p in image_paths:
                if stop.is_set():
                    return
                batch.append((p, load_image(p, predictor.image_size)))
                if len(batch) == batch_size:
                    ship()
            if batch:
                ship()
            put(None)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=producer, name="sweep-producer",
                              daemon=True)
    thread.start()

    try:
        yield from _consume(predictor, q, out_dir, batch_size, writers)
    finally:
        stop.set()
        thread.join(timeout=60)


def _consume(predictor: Predictor, q, out_dir: str, batch_size: int,
             writers: int) -> Iterator[tuple[str, str]]:
    """The sweep's consumer: the forward of each batch the producer queued,
    then its files on the writer pool, yielded in input order."""
    from concurrent.futures import ThreadPoolExecutor

    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.utils.fastpng import write_png

    def render(img: np.ndarray, labels: np.ndarray, path: str) -> None:
        overlay = host_overlay(img, labels, predictor._palette,
                               predictor._alpha)
        if path.lower().endswith(".png"):
            write_png(path, overlay)
        else:
            from PIL import Image

            Image.fromarray(overlay).save(path)

    with ThreadPoolExecutor(max_workers=max(1, writers)) as pool:
        futures: list[tuple[str, str, object]] = []

        def flush(keep: int) -> Iterator[tuple[str, str]]:
            # in submission order, leaving at most ``keep`` files in flight
            while len(futures) > keep:
                src, dst, fut = futures.pop(0)
                fut.result()
                yield src, dst

        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            names, imgs, x, uploaded = item
            if uploaded is not None:
                current = torch.cuda.current_stream(predictor.device)
                current.wait_event(uploaded)
                x.record_stream(current)  # allocated on the side stream
            labels = predictor._fetch_labels(x)
            for i, name in enumerate(names):
                out_path = os.path.join(out_dir, os.path.basename(name))
                futures.append((name, out_path, pool.submit(
                    render, imgs[i], labels[i], out_path)))
            yield from flush(keep=batch_size)
        yield from flush(keep=0)
