"""overlay_roofline.frame: argmax, palette and blend of one frame through
the entry the Predictor calls (``infer.predict``'s overlay function) on
padded float32 logits, timed after the window by the device time of every
op it launches; the share of that time its byte bound takes (4C + 10 bytes
a pixel), in %."""

from portbench.harness import trace, work
from portbench.reference.models import find


def read(rec):
    torch, cfg, dev = rec["torch"], rec["cfg"], rec["device"]
    from semanticsegmentation_tensorflow_tpu_torch.infer import predict

    h, w = rec["traffic"]["frame_hw"]
    s, c = find(cfg["model"]).stride(cfg), cfg["num_classes"]
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.randint(0, 256, (1, h, w, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    logits = torch.randn((1, -(-h // s) * s, -(-w // s) * s, c), generator=g,
                         device=dev)
    pal = torch.as_tensor(rec["mix"].palette, device=dev, dtype=torch.float32)
    alpha = rec["mix"].alpha
    t = trace.device_seconds_per_call(
        torch, lambda: predict.argmax_colormap_overlay_cuda(img, logits, pal, alpha),
        200)
    return None if t is None else work.roofline_pct(work.overlay_bytes(1, h, w, c),
                                                    0.0, t)
