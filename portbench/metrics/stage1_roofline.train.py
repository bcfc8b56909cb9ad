"""stage1_roofline.train: VGG16's first stage as the model module calls it
(conv1_1, conv1_2, pool, biases, relus; the fused stage1 kernels where the
model runs them), forward and backward at the cell's batch and crop, timed
after the window by the device time of every op it launches; the share of
that time its bound takes, in %."""

from portbench.harness import trace, work


def read(rec):
    torch, cfg, dev = rec["torch"], rec["cfg"], rec["device"]
    stage1 = rec["mix"].model.vgg16.stage1
    n, (h, w) = cfg["batch_size"], cfg["crop_size"]
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, h, w, 3), generator=g, device=dev)
    dy = torch.randn(tuple(stage1(x).shape), generator=g, device=dev).to(torch.bfloat16)
    params = list(stage1.parameters())

    def call():
        for p in params:
            p.grad = None
        stage1(x).backward(dy)

    t = trace.device_seconds_per_call(torch, call, 10)
    for p in params:
        p.grad = None
    c = work.param_shape(cfg, "vgg16.stage1.conv0.weight")[0]
    return None if t is None else work.roofline_pct(*work.stage1_work(n, h, w, c), t)
