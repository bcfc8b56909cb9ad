"""Experiment configs of the port: the JAX package's ``config.py`` presets,
copied so that the port (and ``chip_smoke.py``) imports nothing of the JAX
package. ``tests/test_torch_predict.py`` pins every preset equal to the JAX
package's, so the two cannot drift.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# KITTI road native resolution (BASELINE.json: 1242x375). Models need
# stride-aligned inputs; pad_to_multiple handles 1242x375 -> 1248x384.
KITTI_IMAGE_SIZE = (375, 1242)  # (H, W)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "kitti_road"          # kitti_road | cityscapes | synthetic
    data_dir: str = "data_road"
    image_size: tuple[int, int] = KITTI_IMAGE_SIZE  # pre-pad (H, W)
    num_classes: int = 2
    crop_size: tuple[int, int] | None = None  # random-crop training size
    random_flip: bool = True
    # per-channel normalization (ImageNet-ish stats, uint8 scale)
    mean: tuple[float, float, float] = (123.68, 116.779, 103.939)
    std: tuple[float, float, float] = (58.393, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8                   # global (split across data mesh axis)
    epochs: int = 50
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"               # adam | sgd | adamw
    # constant (reference behavior) | poly (DeepLab-paper decay) | cosine
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    # median-frequency class balancing (SegNet paper): scan the train GTs
    # once, weight each class's CE by median_freq/freq
    class_balance: bool = False
    log_every: int = 10
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    mesh_shape: tuple[int, ...] = ()      # () -> all local devices on 'data'
    remat: bool = False                   # recompute the encoder in backward


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "fcn8s_kitti"
    model: str = "fcn8s"
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _cfg(**kw: Any) -> ExperimentConfig:
    return ExperimentConfig(**kw)


# The five BASELINE.json configs, in order.
PRESETS: dict[str, ExperimentConfig] = {
    # 1. FCN-8s (VGG16) on KITTI road, single-image inference capable
    "fcn8s_kitti_infer": _cfg(
        name="fcn8s_kitti_infer", model="fcn8s",
        train=TrainConfig(batch_size=1, epochs=0)),
    # 2. FCN-8s end-to-end training with flip/crop augmentation
    "fcn8s_kitti": _cfg(
        name="fcn8s_kitti", model="fcn8s",
        data=DataConfig(crop_size=(320, 1152))),
    # 2b. FCN-8s in the reference's EXACT configuration: classic 4096-wide
    # fc6/fc7 (the TF VGG16's fc layers convolutionalized — FCN lineage,
    # SURVEY.md §3.4) so pretrained TF VGG16 weights import 1:1
    # (tools/import_tf_vgg.py + load_npz_weights(strict=True)). The default
    # fc_features=1024 elsewhere is a perf choice; THIS preset is the parity
    # configuration.
    "fcn8s_kitti_parity": _cfg(
        name="fcn8s_kitti_parity", model="fcn8s",
        model_kwargs={"fc_features": 4096},
        data=DataConfig(crop_size=(320, 1152))),
    # 3. U-Net on Cityscapes 19-class crops
    "unet_cityscapes": _cfg(
        name="unet_cityscapes", model="unet",
        data=DataConfig(dataset="cityscapes", data_dir="cityscapes",
                        num_classes=19, image_size=(512, 1024),
                        crop_size=(256, 512))),
    # 4. SegNet with max-pool-index unpooling
    "segnet_kitti": _cfg(
        name="segnet_kitti", model="segnet",
        data=DataConfig(crop_size=(320, 1152))),
    # 5. DeepLab-style ASPP + multi-device data-parallel training
    "deeplab_kitti_dp": _cfg(
        name="deeplab_kitti_dp", model="deeplab",
        data=DataConfig(crop_size=(320, 1152)),
        train=TrainConfig(batch_size=16, mesh_shape=())),
    # 5b. DeepLab at output stride 16: only stage5's pool is folded into
    # dilation, so stage5/fc/ASPP run on a 4x smaller grid, at a modest
    # localization cost the ASPP rates partly recover. The perf preset; os8
    # remains the parity configuration.
    "deeplab_kitti_os16": _cfg(
        name="deeplab_kitti_os16", model="deeplab",
        model_kwargs={"output_stride": 16},
        data=DataConfig(crop_size=(320, 1152)),
        train=TrainConfig(batch_size=16, mesh_shape=())),
}


def get_preset(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")


def _parse_kw_value(v: str):
    """CLI model-kwarg literal: bool/None/int/float/str, in that order."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse_model_kw(spec: str | None) -> dict[str, Any]:
    """Parse a ``--model-kw`` CLI string (``k=v,k2=v2``) into model kwargs.

    Shared by every entry script so a model trained with flag overrides
    (e.g. ``fc_features=1024``) can be LOADED BACK by test/eval/infer with
    a matching architecture — without it the checkpoint restore fails on
    a shape mismatch against the preset-default model (round 4; the
    reference's scripts have no such problem only because they hardcode
    one architecture per file, SURVEY.md §1)."""
    out: dict[str, Any] = {}
    for pair in (spec or "").split(","):
        if not pair.strip():
            continue
        k, _, v = pair.partition("=")
        out[k.strip()] = _parse_kw_value(v.strip())
    return out
