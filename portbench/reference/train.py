"""Training steps, followed in plain float32 from the seeds the program was
handed: which frames each batch holds, how they are padded, flipped,
cropped and normalized, the dropout masks, the masked cross entropy over
valid pixels, its gradients and Adam's update.

The draws are worked out again, not read from the program: the batches are
the loader's epochs, each a fresh ``numpy`` shuffle of the frame names by
one ``default_rng(seed)`` stream, the remainder dropped; the flips and
crop offsets come from a host ``torch.Generator`` seeded with ``seed`` (per
step: a uniform per image for the flip, then the row and the column
offsets); the keep-masks of fc6 and fc7 from a ``torch.Generator`` on the
device seeded with ``seed + 1``, drawn at each output's NHWC shape for the
whole batch, fc6's first. The steps may start at a later batch of the
loader (``first_batch``), with the generators and Adam as fresh.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import layers
from portbench.reference.models import find


def batches(names: list[str], seed: int, n: int, first: int,
            count: int) -> list[list[str]]:
    """The names of batches ``first`` .. ``first + count - 1``, counted over
    epochs from the loader's first."""
    per = len(names) // n
    rng = np.random.default_rng(seed)
    out, epoch, order = [], -1, []
    for b in range(first, first + count):
        while epoch < b // per:
            order = list(names)
            rng.shuffle(order)
            epoch += 1
        i = b % per
        out.append(order[i * n:(i + 1) * n])
    return out


def padded(img: np.ndarray, lbl: np.ndarray, val: np.ndarray, m: int):
    """Bottom/right padding to a multiple of ``m``: the image by its edge
    pixels, labels and valid by zeros (padding is never valid)."""
    h, w = lbl.shape
    ph, pw = -h % m, -w % m
    return (np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge"),
            np.pad(lbl, ((0, ph), (0, pw))), np.pad(val, ((0, ph), (0, pw))))


def flip_crop(t: torch.Tensor, flip, oy, ox, crop) -> torch.Tensor:
    """Per image: mirrored across the full width where ``flip``, then the
    crop window at (oy, ox)."""
    ch, cw = crop
    out = []
    for i in range(t.shape[0]):
        x = t[i].flip(1) if bool(flip[i]) else t[i]
        out.append(x[int(oy[i]):int(oy[i]) + ch, int(ox[i]):int(ox[i]) + cw])
    return torch.stack(out)


def _augment_draws(g: torch.Generator, n: int, h: int, w: int, crop):
    flip = torch.rand(n, generator=g) < 0.5
    oy = torch.randint(0, h - crop[0] + 1, (n,), generator=g)
    ox = torch.randint(0, w - crop[1] + 1, (n,), generator=g)
    return flip, oy, ox


def follow(cfg: dict, params: dict, examples, names: list[str], seed: int,
           device, steps: int = 3, first_batch: int = 0,
           microbatch: int = 4) -> dict:
    """``steps`` training steps from ``params`` (f32) and fresh Adam moments
    over the loader's batches ``first_batch`` .. of ``examples`` (name ->
    (image u8, label, valid) at the frame size) and the draws of ``seed``.
    Returns per-step ``loss``, the first step's gradient norm of each leaf
    (``grad_norm``) and each leaf's change over the steps
    (``change_norm``)."""
    with layers.exact_f32():
        return _follow(cfg, params, examples, names, seed, device, steps,
                       first_batch, microbatch)


def _follow(cfg, params0, examples, names, seed, device, steps, first_batch,
            microbatch):
    model = find(cfg["model"])
    n, crop = cfg["batch_size"], tuple(cfg["crop_size"])
    m = model.stride(cfg)
    h, w = padded(*examples[names[0]], m)[1].shape
    g_aug = torch.Generator().manual_seed(seed)
    g_drop = torch.Generator(device=device).manual_seed(seed + 1)
    shapes = model.mask_shapes(cfg, n, *crop)
    mean = torch.tensor(cfg["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(cfg["std"], dtype=torch.float32, device=device)
    keep = 1.0 - cfg["dropout_rate"]
    b1, b2 = cfg["adam_betas"]
    eps, lr = cfg["adam_eps"], cfg["learning_rate"]
    p = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
         for k, v in params0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    var = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad_norm = [], {}
    for t, names_t in enumerate(batches(names, seed, n, first_batch, steps),
                                start=1):
        parts = [padded(*examples[name], m) for name in names_t]
        img, lbl, val = (torch.from_numpy(np.stack(a)) for a in zip(*parts))
        flip, oy, ox = _augment_draws(g_aug, n, h, w, crop)
        img, lbl, val = (flip_crop(a, flip, oy, ox, crop).to(device)
                         for a in (img, lbl, val))
        x = (img.float() - mean) / std
        masks = [torch.rand(s, generator=g_drop, device=device) < keep
                 for s in shapes]
        valid = val.float()
        denom = valid.sum().clamp(min=1.0)
        total = torch.zeros((), device=device)
        for a in range(0, n, microbatch):
            sl = slice(a, a + microbatch)
            logits = model.forward(cfg, p, x[sl], [mk[sl] for mk in masks])
            logp = torch.log_softmax(logits, -1)
            ce = -(logp.gather(-1, lbl[sl].long().unsqueeze(-1)).squeeze(-1)
                   * valid[sl]).sum()
            (ce / denom).backward()
            total += ce.detach()
        losses.append(float(total / denom))
        with torch.no_grad():
            for k, v in p.items():
                g = v.grad
                if t == 1:
                    grad_norm[k] = float(g.norm())
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                var[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = mom[k] / (1 - b1 ** t)
                vhat = var[k] / (1 - b2 ** t)
                v.sub_(lr * mhat / (vhat.sqrt() + eps))
                v.grad = None
    change = {k: float((v.detach() - params0[k].to(device)).norm())
              for k, v in p.items()}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}
