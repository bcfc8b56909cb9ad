"""predict_mfu.frame: the reference's forward FLOPs of one frame at its
padded size times the frames of the traced window, over the window and the
card's bf16 peak, in %."""

from portbench.harness import work
from portbench.reference.models import find


def read(rec):
    cfg, w = rec["cfg"], rec["window"]
    h, w_ = rec["traffic"]["frame_hw"]
    s = find(cfg["model"]).stride(cfg)
    flops = work.forward_flops(cfg, -(-h // s) * s, -(-w_ // s) * s)
    return work.mfu_pct(flops * w["units"], w["seconds"]) if w["units"] else None
