"""aspp_roofline.train: DeepLab-v2's ASPP-L head as the model calls it, in
train mode with its dropout drawn from a seeded generator, forward and
backward into its input at the cell's batch and pool5's grid (the crop over
8), timed after the window by the device time of every op it launches
(``harness.trace``); the share of that time its bound takes (the larger of
the in-map taps' FLOPs over the bf16 peak and bytes over HBM bandwidth,
``harness.atrous``), in %."""

from portbench.harness import atrous, trace, work


def read(rec):
    torch, cfg, dev = rec["torch"], rec["cfg"], rec["device"]
    aspp = rec["mix"].model.aspp
    n = cfg["batch_size"]
    h, w = cfg["crop_size"][0] // 8, cfg["crop_size"][1] // 8   # pool5's grid
    cin = work.param_shape(cfg, f"aspp.fc6_{atrous.RATES[0]}.weight")[1]
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((n, h, w, cfg["num_classes"]), generator=g, device=dev)
    drop = torch.Generator(device=dev).manual_seed(1)
    params = list(aspp.parameters())
    aspp.train()

    def call():
        for p in params:
            p.grad = None
        aspp(x.detach().requires_grad_(), drop).backward(dy)

    t = trace.device_seconds_per_call(torch, call, 5, warmup=1)
    for p in params:
        p.grad = None
    return None if t is None else work.roofline_pct(*atrous.aspp_work(cfg, n, h, w), t)
