"""step_mfu.train: the reference's FLOPs of a training step (forward, weight
gradients, input gradients; ``harness.work``) times the steps of the traced
window, over the window and the card's bf16 peak, in %."""

from portbench.harness import work


def read(rec):
    cfg, w = rec["cfg"], rec["window"]
    ch, cw = cfg["crop_size"]
    flops = work.train_step_flops(cfg, cfg["batch_size"], ch, cw)
    return work.mfu_pct(flops * w["units"], w["seconds"])
