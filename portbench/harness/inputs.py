"""Inputs made from the seed, on the device, in a few large calls: KITTI
road-like frames and the model's weights.

The frames follow the recipe of the port's ``data/synthetic.py`` (noise
under a vertical sky-to-ground gradient, a darker road trapezoid below a
random horizon, its mask the label), drawn for a whole chunk of frames at
once with a ``torch.Generator`` on the card instead of frame by frame with
numpy. The weights are one normal draw over every parameter, scaled leaf by
leaf to the reference model's init (its ``param_specs``).

Seeds: the weights draw from ``seed``, the frames from ``seed + 2``; the
program's own generators take ``seed`` (augment, on the host) and
``seed + 1`` (dropout, on the card).
"""

from __future__ import annotations

import numpy as np


def road_frames(torch, n: int, h: int, w: int, seed: int, device,
                chunk: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """(images u8 [n,h,w,3], labels i32 [n,h,w]) in host memory."""
    g = torch.Generator(device=device).manual_seed(seed + 2)
    images = np.empty((n, h, w, 3), np.uint8)
    labels = np.empty((n, h, w), np.int32)
    rows = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    cols = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    sky = torch.linspace(180, 60, h, device=device).view(1, h, 1, 1)
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        noise = torch.randint(0, 255, (m, h, w, 3), generator=g, device=device,
                              dtype=torch.uint8)
        u = torch.rand((m, 4), generator=g, device=device)
        img = (noise.float() * 0.3 + sky * 0.7).to(torch.uint8)
        horizon = torch.floor(h * (0.35 + 0.2 * u[:, 0])).view(m, 1, 1)
        center = torch.floor(w * (0.3 + 0.4 * u[:, 1])).view(m, 1, 1)
        top_half = torch.floor(w * (0.02 + 0.06 * u[:, 2])).view(m, 1, 1)
        bot_half = torch.floor(w * (0.25 + 0.2 * u[:, 3])).view(m, 1, 1)
        frac = ((rows - horizon) / (h - horizon).clamp(min=1)).clamp(0, 1)
        half = top_half + (bot_half - top_half) * frac
        road = (rows >= horizon) & ((cols - center).abs() <= half)
        dark = (img.float() * 0.4 + 80).to(torch.uint8)
        img = torch.where(road.unsqueeze(-1), dark, img)
        images[a:a + m] = img.cpu().numpy()
        labels[a:a + m] = road.to(torch.int32).cpu().numpy()
    return images, labels


def make_weights(torch, specs, seed: int, device, served_dtype=None) -> dict:
    """{name: f32 tensor} for ``specs`` [(name, shape, std)]: one draw of
    normals on the device, scaled by each leaf's std; ``served_dtype``
    (e.g. bfloat16) rounds every value to the type the weights are served
    in, kept in f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(s)) for _, s, _ in specs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    stds = torch.repeat_interleave(
        torch.tensor([std for _, _, std in specs], device=device),
        torch.tensor(sizes, device=device))
    flat.mul_(stds)
    del stds
    if served_dtype is not None:
        flat = flat.to(served_dtype).float()
    out, off = {}, 0
    for (name, shape, _), size in zip(specs, sizes):
        out[name] = flat[off:off + size].view(shape)
        off += size
    return out


def model_weights(torch, cfg: dict, seed: int, device, frame, bias=None,
                  served_dtype=None) -> tuple[dict, object]:
    """(weights, classifier bias): :func:`make_weights` from ``seed``, with
    the output bias of the classifier (the last parameter of
    the reference model's ``param_specs``) shifted by minus each class's median
    logit of the reference over ``frame`` (rounded to ``served_dtype``),
    so that the decision boundary runs through the frames: with random
    weights a model can otherwise give one class everywhere, its labels
    then say nothing of the precision they were computed in, and its
    gradients are one shared push toward the other class. ``bias``: that
    bias as an earlier call worked it out, used as it is."""
    from portbench.reference import predict as ref_predict
    from portbench.reference.models import find

    specs = find(cfg["model"]).param_specs(cfg)
    w = make_weights(torch, specs, seed, device, served_dtype)
    last = w[specs[-1][0]]
    if bias is None:
        logits = ref_predict.logits(cfg, w, frame, device)
        bias = last - logits.reshape(-1, logits.shape[-1]).median(dim=0).values
        if served_dtype is not None:
            bias = bias.to(served_dtype).float()
    last.copy_(bias)
    return w, bias
