"""Plain float32 layers that the reference models are built of, in plain
PyTorch, with no code of the measured program.

Activations are NHWC at every function boundary; parameters are a flat
dict keyed by the names the benchmark's weights use
(``vgg16.stage1.conv0.weight``, OIHW kernels; transposed-conv kernels
[in, out, k, k]). Dropout takes its keep-masks as arguments: the caller
draws them (see ``reference.train``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (convs, features) of VGG16's five stages
VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """SAME convolution, stride 1, of NHWC ``x`` by OIHW ``w``, plus ``b``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b


def conv_transpose(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """Stride-s transposed conv with a 2s x 2s kernel [in, out, k, k], SAME
    placement (flax ``ConvTranspose(padding="SAME")``): output size s * input."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride,
                           padding=stride // 2)
    return y.permute(0, 2, 3, 1) + b


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, keep_mask: torch.Tensor | None,
            rate: float) -> torch.Tensor:
    """Inverted dropout with a drawn keep-mask (None: the identity)."""
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def stage_features(cfg: dict) -> list[int]:
    """VGG16's stage widths, scaled by the model's ``width_mult`` (1 as
    published; the CPU tests shrink it) as the port scales them."""
    wm = cfg["model_kwargs"].get("width_mult", 1.0)
    return [max(8, int(f * wm)) for _, f in VGG16_STAGES]


def vgg16(p: dict, x: torch.Tensor, masks=(None, None), rate: float = 0.5) -> dict:
    """VGG16's endpoints pool1..pool5 and conv7: five stages of 3x3 convs
    and relus, each closed by a 2x2 max pool, then fc6 (7x7) and fc7 (1x1)
    as convolutions, each relu'd and dropped out with ``masks``."""
    ends = {}
    for i, (n_convs, _) in enumerate(VGG16_STAGES, start=1):
        for j in range(n_convs):
            pre = f"vgg16.stage{i}.conv{j}"
            x = torch.relu(conv(x, p[pre + ".weight"], p[pre + ".bias"]))
        x = max_pool2(x)
        ends[f"pool{i}"] = x
    x = torch.relu(conv(x, p["vgg16.conv6.weight"], p["vgg16.conv6.bias"]))
    x = dropout(x, masks[0], rate)
    x = torch.relu(conv(x, p["vgg16.conv7.weight"], p["vgg16.conv7.bias"]))
    ends["conv7"] = dropout(x, masks[1], rate)
    return ends


def vgg16_specs(cfg: dict, fc: int) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, init std) of VGG16's parameters with fc6/fc7 ``fc``
    wide: kernels followed by a relu take std sqrt(2 / fan-in); biases 0.1."""
    out: list[tuple[str, tuple[int, ...], float]] = []
    cin, feats = 3, stage_features(cfg)
    for i, (n_convs, _) in enumerate(VGG16_STAGES, start=1):
        for j in range(n_convs):
            out += conv_specs(f"vgg16.stage{i}.conv{j}", feats[i - 1], cin, 3)
            cin = feats[i - 1]
    return (out + conv_specs("vgg16.conv6", fc, cin, 7)
            + conv_specs("vgg16.conv7", fc, fc, 1))


def conv_specs(name: str, cout: int, cin: int, k: int, relu: bool = True) -> list:
    """A conv's kernel (std sqrt(2 / fan-in) before a relu, else sqrt(1 /
    fan-in)) and bias (0.1)."""
    return [(name + ".weight", (cout, cin, k, k),
             ((2.0 if relu else 1.0) / (cin * k * k)) ** 0.5),
            (name + ".bias", (cout,), 0.1)]


def conv_transpose_specs(name: str, c: int, stride: int) -> list:
    """A stride-s transposed conv's kernel (2s x 2s, std sqrt(1 / fan-in),
    its fan-in c x (k/s)^2 taps) and bias (0.1)."""
    return [(name + ".weight", (c, c, 2 * stride, 2 * stride), (1.0 / (c * 4)) ** 0.5),
            (name + ".bias", (c,), 0.1)]


class exact_f32:
    """Within it, float32 convolutions and matrix products run in full
    float32 (TF32 off); the previous settings come back after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
