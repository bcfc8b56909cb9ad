"""Operations and bytes of DeepLab-v2's ASPP-L head (``aspp_roofline.train``),
counting only the taps of a dilated conv that land inside the map: at rate
24 on pool5's 40 rows the dilated window (49 rows) is taller than the map,
and a kernel that skips padded taps does less work than ``harness.work``'s
count of every tap. The bound then cannot read over 100 % for such a
kernel."""

from __future__ import annotations

from portbench.harness import work
from portbench.reference.models.deeplab_v2 import RATES


def taps_1d(size: int, k: int, d: int) -> int:
    """Of ``size`` outputs of a SAME stride-1 1-D conv of ``k`` taps at
    dilation ``d``, the (output, tap) pairs whose input lies inside."""
    half = k // 2
    return sum(max(0, size - abs(t) * d) for t in range(-half, half + 1))


def in_map_taps(h: int, w: int, k: int, d: int) -> int:
    """(output pixel, tap) pairs of a SAME k x k conv at dilation ``d`` on an
    h x w map whose input pixel lies inside the map (the rows and the
    columns are independent)."""
    return taps_1d(h, k, d) * taps_1d(w, k, d)


def aspp_work(cfg: dict, n: int, h: int, w: int) -> tuple[float, float]:
    """(bytes, FLOPs) of the head on an n x h x w pool5 map: each branch's
    fc6_r (at its rate), fc7_r and fc8_r, forward, input gradient and weight
    gradient, 2 FLOPs per multiply-add of an in-map tap. Bytes: the bf16
    input read and its gradient written, the f32 output written and its
    gradient read, the f32 kernels and biases read and their gradients
    written."""
    cin = work.param_shape(cfg, f"aspp.fc6_{RATES[0]}.weight")[1]
    flops = nbytes = 0.0
    for r in RATES:
        for name, d in ((f"fc6_{r}", r), (f"fc7_{r}", 1), (f"fc8_{r}", 1)):
            co, ci, k, _ = work.param_shape(cfg, f"aspp.{name}.weight")
            flops += 3 * 2.0 * n * ci * co * in_map_taps(h, w, k, d)
            nbytes += 4 * (co * ci * k * k + co) * 2
    classes = cfg["num_classes"]
    return nbytes + 2 * n * h * w * (2 * cin + 4 * classes), flops
