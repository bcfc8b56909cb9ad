"""Plain float32 DeepLab-v2 "DeepLab-ASPP-L" on VGG16 (Chen, Papandreou,
Kokkinos, Murphy, Yuille, arXiv:1606.00915, section 3.3, Fig. 4(b), Table
3): VGG16's 13 convs (3x3, bias, relu), each stage closed by a 3x3 max pool
with padding 1, stride 2 after stages 1-3 and 1 after stages 4-5, stage 5
at dilation 2 (output stride 8); then four branches on pool5, one a rate r
in (6, 12, 18, 24): fc6_r (3x3 at dilation r, padding r, 1024 wide), relu,
dropout, fc7_r (1x1, 1024), relu, dropout, fc8_r (1x1 to the classes); the
logits are the four fc8_r outputs summed.

Departures from the paper, each the benchmark's configuration's:

- the pools run in floor mode (Caffe's in ceil mode), so an input whose
  sides are multiples of 8 gives exactly an eighth;
- the logits are upsampled x8 bilinearly (half-pixel centres) and the loss
  is taken at full resolution; the paper subsamples the labels by 8;
- Adam at 1e-4 in place of SGD with momentum 0.9 and poly decay from 1e-3
  (the benchmark's check reads Adam's moments);
- batch 10 of 320x1152 crops of KITTI road frames (375x1242) in place of
  321x321 crops of PASCAL VOC;
- seeded random weights in place of an ImageNet-trained VGG16;
- the measured program runs its convs in bf16 with f32 accumulation; this
  reference runs in float32;
- no DenseCRF (post-processing, not part of the network).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import layers as L

RATES = (6, 12, 18, 24)
POOL_STRIDES = (2, 2, 2, 1, 1)
DILATIONS = (1, 1, 1, 1, 2)


def fc_features(cfg: dict) -> int:
    return cfg["model_kwargs"].get("fc_features", 1024)


def stride(cfg: dict) -> int:
    return 8


def mask_shapes(cfg: dict, n: int, h: int, w: int) -> list[tuple[int, ...]]:
    """fc6_r's and fc7_r's NHWC outputs, fc6_r's first, rate by rate in
    ascending order: the order the program draws them in."""
    shape = (n, h // 8, w // 8, fc_features(cfg))
    return [shape] * (2 * len(RATES))


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """VGG16's convs, then each branch's fc6, fc7 and fc8 rate by rate: the
    last branch's fc8 bias last (shifting any one branch's bias shifts the
    sum)."""
    nc, fc, feats = cfg["num_classes"], fc_features(cfg), L.stage_features(cfg)
    out, cin = [], 3
    for i, (n_convs, _) in enumerate(L.VGG16_STAGES, start=1):
        for j in range(n_convs):
            out += L.conv_specs(f"vgg16.stage{i}.conv{j}", feats[i - 1], cin, 3)
            cin = feats[i - 1]
    for r in RATES:
        out += (L.conv_specs(f"aspp.fc6_{r}", fc, cin, 3)
                + L.conv_specs(f"aspp.fc7_{r}", fc, fc, 1)
                + L.conv_specs(f"aspp.fc8_{r}", nc, fc, 1, relu=False))
    return out


def atrous_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dilation: int) -> torch.Tensor:
    """SAME stride-1 convolution of NHWC ``x`` by OIHW ``w`` at
    ``dilation``, plus ``b``."""
    pad = dilation * (w.shape[-1] // 2)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1) + b


def max_pool3(x: torch.Tensor, stride_: int) -> torch.Tensor:
    """3x3 max pool with padding 1 (padding never wins), floor mode."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=stride_, padding=1)
    return y.permute(0, 2, 3, 1)


def forward(cfg: dict, p: dict, x: torch.Tensor, masks=None) -> torch.Tensor:
    for i, ((n_convs, _), s, d) in enumerate(
            zip(L.VGG16_STAGES, POOL_STRIDES, DILATIONS), start=1):
        for j in range(n_convs):
            pre = f"vgg16.stage{i}.conv{j}"
            x = torch.relu(atrous_conv(x, p[pre + ".weight"], p[pre + ".bias"], d))
        x = max_pool3(x, s)
    masks = masks or [None] * (2 * len(RATES))
    rate = cfg["dropout_rate"]

    def wb(name: str):
        return p[f"aspp.{name}.weight"], p[f"aspp.{name}.bias"]

    out = 0
    for k, r in enumerate(RATES):
        y = torch.relu(atrous_conv(x, *wb(f"fc6_{r}"), r))
        y = L.dropout(y, masks[2 * k], rate)
        y = L.dropout(torch.relu(L.conv(y, *wb(f"fc7_{r}"))), masks[2 * k + 1], rate)
        out = out + L.conv(y, *wb(f"fc8_{r}"))
    n, h, w, _ = out.shape
    y = F.interpolate(out.permute(0, 3, 1, 2), size=(8 * h, 8 * w),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
