"""Plain float32 FCN-8s (Long, Shelhamer, Darrell, arXiv:1411.4038) on
VGG16 with fc6 (7x7) and fc7 (1x1) as convolutions, ``fc_features`` wide
(4096 as published): 1x1 scores of conv7, pool4 and pool3, added after 2x,
2x and a final 8x transposed conv."""

from __future__ import annotations

import torch

from portbench.reference import layers as L


def fc_features(cfg: dict) -> int:
    return cfg["model_kwargs"].get("fc_features", 1024)


def stride(cfg: dict) -> int:
    return 32


def mask_shapes(cfg: dict, n: int, h: int, w: int) -> list[tuple[int, ...]]:
    """fc6's and fc7's NHWC outputs, fc6's first."""
    shape = (n, h // 32, w // 32, fc_features(cfg))
    return [shape, shape]


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], float]]:
    nc, feats = cfg["num_classes"], L.stage_features(cfg)
    return (L.vgg16_specs(cfg, fc_features(cfg))
            + L.conv_specs("score_conv7", nc, fc_features(cfg), 1, relu=False)
            + L.conv_specs("score_pool4", nc, feats[3], 1, relu=False)
            + L.conv_transpose_specs("up2_conv7", nc, 2)
            + L.conv_specs("score_pool3", nc, feats[2], 1, relu=False)
            + L.conv_transpose_specs("up2_fuse4", nc, 2)
            + L.conv_transpose_specs("up8_final", nc, 8))


def forward(cfg: dict, p: dict, x: torch.Tensor, masks=None) -> torch.Tensor:
    e = L.vgg16(p, x, masks or (None, None), cfg["dropout_rate"])
    s7 = L.conv(e["conv7"], p["score_conv7.weight"], p["score_conv7.bias"])
    s4 = L.conv(e["pool4"], p["score_pool4.weight"], p["score_pool4.bias"])
    y = L.conv_transpose(s7, p["up2_conv7.weight"], p["up2_conv7.bias"], 2) + s4
    s3 = L.conv(e["pool3"], p["score_pool3.weight"], p["score_pool3.bias"])
    y = L.conv_transpose(y, p["up2_fuse4.weight"], p["up2_fuse4.bias"], 2) + s3
    return L.conv_transpose(y, p["up8_final.weight"], p["up8_final.bias"], 8)
