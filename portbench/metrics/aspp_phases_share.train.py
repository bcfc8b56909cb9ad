"""aspp_phases_share.train: of the dilated passes of DeepLab-v2's ASPP-L
head (each fc6_r's forward, input gradient and weight gradient: 12), the
share that ran by phases, in one train-mode forward and backward of the
head into its input at the cell's batch and pool5's grid (the crop over 8)
after the window, as ``aspp_roofline.train`` calls it: the change in the
program's host-side count of dilated passes by (pass, form)
(``models.common.DILATED_PASSES``); 0 where every pass ran direct. A
program without that count, or a head narrower than ASPP-L's published
1024 channels (a cut-down run, whose shapes the rule was not fitted to),
gives nothing to read (None)."""

import sys

from portbench.harness import atrous

COMMON = "semanticsegmentation_tensorflow_tpu_torch.models.common"
PUBLISHED_WIDTH = 1024   # each fc6_r's output channels in ASPP-L


def read(rec):
    counter = getattr(sys.modules.get(COMMON), "DILATED_PASSES", None)
    aspp = rec["mix"].model.aspp
    cout, cin = getattr(aspp, f"fc6_{atrous.RATES[0]}").weight.shape[:2]
    if counter is None or cout < PUBLISHED_WIDTH:
        return None
    torch, cfg, dev = rec["torch"], rec["cfg"], rec["device"]
    n = cfg["batch_size"]
    h, w = cfg["crop_size"][0] // 8, cfg["crop_size"][1] // 8   # pool5's grid
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn((n, h, w, cfg["num_classes"]), generator=g, device=dev)
    drop = torch.Generator(device=dev).manual_seed(1)
    params = list(aspp.parameters())
    aspp.train()
    before = counter.copy()
    aspp(x.requires_grad_(), drop).backward(dy)
    for p in params:
        p.grad = None
    ran = counter - before
    phases = sum(v for (_, form), v in ran.items() if form == "phases")
    return phases / sum(ran.values())
