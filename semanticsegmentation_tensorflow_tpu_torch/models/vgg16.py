"""VGG16 feature extractor (counterpart of the JAX package's
``models/vgg16.py``): stages 1-5 with 2x2 pools (or, for DeepLab, the last
stages dilated instead of pooled), then fc6 (7x7 SAME) and fc7 (1x1) as
convs with dropout. NHWC in, dict of NHWC endpoints out.
Dropout draws its masks from the generator passed to ``forward`` (flax's
semantics, ``models.common.dropout``). :func:`load_npz_weights` imports
pretrained VGG16 weights from the JAX package's ``.npz`` archives.

The stage blocks with the pool inside are the counterparts of the JAX
package's ``ops/packed_stem.py``. On the TPU, stage1 packed width pairs
into the 128-lane channel dim. That is a lane trick of the TPU and is not
carried over: on the H100, :class:`Stage1` runs conv1_1 with cuDNN, adds
b1, and hands the NHWC result to the fused stage1-tail kernels
(``ops/cuda/stage1.py``): the inference kernel, or, when autograd records,
the training forward and its backward (``Stage1Tail``). Under an active
grid that splits rows (``parallel.mesh.spatial_grid``) it runs the halo
mode of the tail instead (kernel 1c, :func:`_halo_tail`).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    Conv, ConvBlock, dropout, region,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import (
    conv3x3_bias_relu, conv3x3_raw,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    Stage1Tail, Stage1TailHalo, stage1_tail, stage1_tail_halo,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import max_pool
from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
    winograd_conv_large,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import boundary_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
    Grid, spatial_grid,
)

# (n_convs, features) per VGG16 stage.
VGG16_STAGES: tuple[tuple[int, int], ...] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512),
)


def _halo_tail(conv0: Conv, conv1: Conv, x: torch.Tensor,
               grid: Grid | None, function, mode: str):
    """Stage1 on ``grid``'s rows: conv1_1 without its bias, then the
    halo-mode tail (kernel 1c), which folds b1 in and exchanges its own
    halo rows with the neighbouring ranks (the image's edge rows at the
    image's edge): the autograd ``function`` (``Stage1TailHalo`` or
    ``SegNetStage1TailHalo``) when autograd records, else the inference
    wrapper in ``mode`` (``"infer"`` or ``"segnet"``). With ``grid`` None
    the halo rows are the image's edge, so it runs over the whole image."""
    z1 = conv0.conv(x).contiguous()
    k2, b2, b1 = conv1.weight, conv1.bias, conv0.bias
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z1, k2, b2, b1)):
        return function.apply(z1, k2, b2, b1, grid)
    [(top, bot)] = boundary_rows([z1], [float("-inf")], grid)
    return stage1_tail_halo(z1, top, bot, k2, b2, b1, mode)


class PooledConvBlock(ConvBlock):
    """ConvBlock + 2x2/2 max pool with the last bias+relu AFTER the pool.

    Exact: ``relu(pool(z) + b) == pool(relu(z + b))`` bit for bit (the max
    commutes with the per-channel bias add, with its monotone rounding and
    with the relu), while the bias add and relu run at 1/4 resolution.
    Same parameters as ``ConvBlock(features, n_convs)``. With ``winograd``
    (the JAX package's ``PooledConvBlock``, ``ops/packed_stem.py:190-256``)
    the inner convs take the fused bias+relu form and the last conv the raw
    one, so its bias and relu stay deferred past the pool."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *head, last = self.convs()
        for conv in head:
            x = conv3x3_bias_relu(x, conv.weight, conv.bias, dtype=conv.dtype,
                                  dilation=conv.dilation,
                                  winograd=self.winograd)
        z = conv3x3_raw(x, last, self.winograd)
        return torch.relu(max_pool(z, 2) + last.bias.to(last.dtype))


class Stage1(PooledConvBlock):
    """VGG stage1: conv3x3 -> relu -> conv3x3 -> relu -> maxpool 2x2.

    conv1_1 (``conv0``) runs as a plain conv plus b1 in the compute dtype;
    the rest (relu, conv1_2, pool, +b2, relu) is one call of the fused
    stage1 tail: the CUDA kernels for CUDA tensors, their plain versions on
    the CPU. When autograd records, the tail is :class:`Stage1Tail` (the
    training forward, which also writes the pool's routing codes, and the
    backward kernel); b1 stays in conv1_1, so autograd gives db1 = sum(dz1).
    Under an active grid that splits rows the tail runs in its halo mode
    (:func:`_halo_tail`, kernel 1c). An odd H or W runs the same params as
    the plain :class:`PooledConvBlock` (with ``winograd``), as the JAX
    package's VGG16 does (``models/vgg16.py:97-118``)."""

    def __init__(self, in_features: int, features: int = 64, *,
                 winograd: str | None = None,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__(in_features, features, 2, winograd=winograd,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            return super().forward(x)
        grid = spatial_grid()
        if grid is not None:
            return _halo_tail(self.conv0, self.conv1, x, grid,
                              Stage1TailHalo, "infer")
        # NHWC-contiguous for the kernel (a no-op for channels_last output)
        z1 = self.conv0(x).contiguous()
        k2, b2 = self.conv1.weight, self.conv1.bias
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (z1, k2, b2)):
            return Stage1Tail.apply(z1, k2, b2)
        return stage1_tail(z1, k2, b2)


class ConvPoolBlock(ConvBlock):
    """ConvBlock (conv + bias [+ BN] + relu for every conv) then a 2x2/2 max
    pool: the JAX package's VGG16 stage with ``deferred_pool_bias=False`` or
    ``use_bn`` (``models/vgg16.py:105-116``). Without BN it has the
    parameters of :class:`PooledConvBlock`, which computes the same function
    bit for bit with the last bias and relu after the pool."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(super().forward(x), 2)


class VGG16(nn.Module):
    """Returns a dict of endpoints: pool1..pool5, conv7.

    ``packed_stage1`` (the JAX flag's name, kept so presets and
    ``--model-kw`` carry over): stage1 runs as :class:`Stage1`, conv1_1 then
    the fused stage1-tail kernels (on even H and W). Otherwise it runs as a
    :class:`PooledConvBlock`, like stages 2-5 (the last bias added after the
    pool, bit-exact). Same params either way. ``deferred_pool_bias=False``
    runs every stage that is not :class:`Stage1` as a :class:`ConvPoolBlock`
    (each conv's bias and relu before the pool, as the JAX flag does),
    bit-equal to the default. ``dropout_rate`` applies to fc6 and fc7 in
    ``train()`` mode, with masks from the ``generator`` given to
    :meth:`forward`.

    ``use_bn``: BatchNorm after every conv of stages 1-5
    (``models.common.BatchNorm``; conv, bias, BN, relu), each stage a
    :class:`ConvPoolBlock` (or, dilated, a :class:`ConvBlock`): no fused
    stage1 and no deferred pool bias, as the JAX package's
    ``models/vgg16.py:97`` and ``:105`` leave them under BN. fc6 and fc7
    have none.

    ``dilated_last_stages`` (DeepLab; the JAX package's
    ``models/vgg16.py:93-138``): stage ``dilate_from`` and every stage after
    it run as a :class:`ConvBlock` (bias and relu per conv, no pool) at the
    running dilation, which starts at 1 and doubles after each such stage;
    fc6 takes the final one. ``dilate_from=4`` gives output stride 8 (stage
    4 at dilation 1, stage 5 at 2, fc6 at 4), ``5`` stride 16 (stage 5 at 1,
    fc6 at 2). ``winograd_fc6`` applies only where fc6 is undilated.
    """

    def __init__(self, fc_features: int = 1024, width_mult: float = 1.0, *,
                 packed_stage1: bool = True, deferred_pool_bias: bool = True,
                 dropout_rate: float = 0.5, dtype: torch.dtype = DEFAULT_DTYPE,
                 use_bn: bool = False, dilated_last_stages: bool = False,
                 winograd: str | None = None, winograd_fc6: bool | None = None,
                 dilate_from: int = 4, device=None):
        super().__init__()
        cin = 3
        dilation = 1
        for i, (n_convs, feats) in enumerate(VGG16_STAGES, start=1):
            feats = max(8, int(feats * width_mult))
            if i == 1 and packed_stage1 and not use_bn:
                block = Stage1(cin, feats, winograd=winograd, dtype=dtype,
                               device=device)
            elif dilated_last_stages and i >= dilate_from:
                block = ConvBlock(cin, feats, n_convs, dilation=dilation,
                                  winograd=winograd, use_bn=use_bn,
                                  dtype=dtype, device=device)
                dilation *= 2      # the stride folded into the dilation
            else:
                kind = (PooledConvBlock if deferred_pool_bias and not use_bn
                        else ConvPoolBlock)
                block = kind(cin, feats, n_convs, winograd=winograd,
                             use_bn=use_bn, dtype=dtype, device=device)
            self.add_module(f"stage{i}", block)
            cin = feats
        self.conv6 = Conv(cin, fc_features, 7, dilation=dilation, dtype=dtype,
                          device=device)
        self.conv7 = Conv(fc_features, fc_features, 1, dtype=dtype,
                          device=device)
        self.dropout_rate = dropout_rate
        self.winograd_fc6 = bool(winograd_fc6) and dilation == 1

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        """Each stage and the fc6/fc7 head is one :func:`region` (the unit
        a train step with ``remat`` recomputes)."""
        ends: dict[str, torch.Tensor] = {}
        for i in range(1, len(VGG16_STAGES) + 1):
            x = region(getattr(self, f"stage{i}"), x)
            ends[f"pool{i}"] = x
        ends["conv7"] = region(self._head, x, generator)
        return ends

    def _head(self, x: torch.Tensor,
              generator: torch.Generator | None) -> torch.Tensor:
        """fc6 (7x7) and fc7 (1x1), each with its relu and dropout."""
        drop = dict(training=self.training, generator=generator)
        if self.winograd_fc6:
            if spatial_grid() is not None:
                raise NotImplementedError(
                    "winograd_fc6 exchanges no halo rows: train a spatial "
                    "grid without it")
            c6 = self.conv6
            x = winograd_conv_large(x.to(c6.dtype), c6.weight, c6.bias, "f3", True)
        else:
            x = torch.relu(self.conv6(x))
        x = dropout(x, self.dropout_rate, **drop)
        return dropout(torch.relu(self.conv7(x)), self.dropout_rate, **drop)


def _is_backbone(flax_path: str) -> bool:
    return any(p.startswith("stage") or p in ("conv6", "conv7")
               for p in flax_path.split("/"))


def load_npz_weights(state_dict: dict[str, torch.Tensor], npz_path: str, *,
                     strict: bool = False, report: dict | None = None,
                     transposed: Iterable[str] = ()) -> dict[str, torch.Tensor]:
    """Import pretrained VGG16 kernels and biases from an ``.npz`` archive
    keyed by flax paths (``stage1/conv0/kernel``, HWIO kernels; the JAX
    package's ``load_npz_weights`` format) into a copy of the port's
    ``state_dict``.

    Each parameter matches by its flax path (``convert.flax_key``), relative
    to the model (``vgg16/...``) or to the backbone; kernels convert to
    PyTorch's layout as ``convert.to_state_dict`` does (``transposed``: the
    keys of transposed-conv kernels, ``convert.transposed_weights``). A name
    match with another shape raises in both modes. ``strict``: every
    backbone parameter (a ``stageN`` or ``conv6``/``conv7`` path) must be
    matched and every archive entry used, else ValueError. ``report`` is
    filled with the ``matched``, ``unmatched_params`` and ``unused_archive``
    lists, in flax path names. Returns the new state_dict."""
    transposed = set(transposed)
    blob = np.load(npz_path)
    out = dict(state_dict)
    matched: list[str] = []
    used: set[str] = set()
    for tk, val in state_dict.items():
        key = convert.flax_key(tk)
        for candidate in (key, f"vgg16/{key}", key.removeprefix("vgg16/")):
            if candidate not in blob.files:
                continue
            a = blob[candidate]
            want = convert.flax_layout(np.broadcast_to(np.float32(0), val.shape),
                                       tk in transposed).shape
            if a.shape != want:
                raise ValueError(
                    f"shape mismatch importing {candidate!r}: archive "
                    f"{a.shape} vs param {want} - model width (e.g. "
                    "fc_features) must match the archive; see the "
                    "fcn8s_kitti_parity preset")
            out[tk] = torch.from_numpy(np.ascontiguousarray(
                convert.torch_layout(a, tk in transposed))).to(val)
            matched.append(key)
            used.add(candidate)
            break
    done = set(matched)
    unmatched = [convert.flax_key(tk) for tk in state_dict
                 if convert.flax_key(tk) not in done
                 and _is_backbone(convert.flax_key(tk))]
    unused = [f for f in blob.files if f not in used]
    if report is not None:
        report.update(matched=sorted(matched), unmatched_params=sorted(unmatched),
                      unused_archive=sorted(unused))
    if strict and (unmatched or unused):
        raise ValueError("strict VGG16 import failed: unmatched backbone params "
                         f"{sorted(unmatched)}; unused archive entries "
                         f"{sorted(unused)}")
    return out
