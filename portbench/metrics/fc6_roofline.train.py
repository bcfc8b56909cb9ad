"""fc6_roofline.train: VGG16's fc6 (the 7x7 conv with its bias and relu) as
the model module calls it, forward and both gradients at the cell's batch
and fc6's grid, timed after the window by the device time of every op it
launches (``harness.trace``); the share of that time its bound takes (the
larger of FLOPs over the bf16 peak and bytes over HBM bandwidth), in %."""

from portbench.harness import trace, work


def read(rec):
    torch, cfg, dev = rec["torch"], rec["cfg"], rec["device"]
    conv6 = rec["mix"].model.vgg16.conv6
    n = cfg["batch_size"]
    h, w = cfg["crop_size"][0] // 32, cfg["crop_size"][1] // 32   # pool5's grid
    fc, cin, _, _ = work.param_shape(cfg, "vgg16.conv6.weight")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((n, h, w, fc), generator=g, device=dev).to(torch.bfloat16)

    def call():
        conv6.weight.grad = conv6.bias.grad = None
        torch.relu(conv6(x.detach().requires_grad_())).backward(dy)

    t = trace.device_seconds_per_call(torch, call, 10)
    conv6.weight.grad = conv6.bias.grad = None
    return None if t is None else work.roofline_pct(*work.fc6_work(cfg, n, h, w), t)
