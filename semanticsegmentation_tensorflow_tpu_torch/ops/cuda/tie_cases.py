"""Integer inputs that hold the stage1 kernels to their plain versions bit
for bit, ties included: every sum is exact in f32 and in bf16's integer
range, so a kernel that routes a tie otherwise than the first maximum in
(dy, dx) row-major window order shows. Each returns float32 CPU tensors
(z1 [N,H,W,C], k2 [C,C,3,3], b2 [C]) for the caller to move and cast;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` share them.
"""

from __future__ import annotations

import torch


def _windows(pats: torch.Tensor, n: int, h: int, w: int, c: int,
             seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """z1 whose 2x2 windows are rows of ``pats`` ((0,0), (0,1), (1,0),
    (1,1) order) picked at random, and a centre-tap identity k2, so that
    the conv output is relu(z1) exactly."""
    g = torch.Generator().manual_seed(seed)
    win = pats[torch.randint(0, len(pats), (n, h // 2, w // 2, c), generator=g)]
    z1 = win.reshape(n, h // 2, w // 2, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    k2 = torch.zeros(c, c, 3, 3)
    k2[torch.arange(c), torch.arange(c), 1, 1] = 1.0
    return z1.reshape(n, h, w, c), k2


def tie_windows(n, h, w, c, seed):
    """FCN's codes: windows that are permutations of tie patterns, among
    them c = b > a ((0,1) = (1,0) > (0,0)); b2 = 0."""
    pats = torch.tensor([[1, 2, 2, 0], [2, 2, 2, 2], [0, 1, 1, 1], [3, 1, 3, 0],
                         [0, 0, 1, 2], [-1, -2, 1, 1], [1, 1, 2, 2]],
                        dtype=torch.float32)
    return (*_windows(pats, n, h, w, c, seed), torch.zeros(c))


def segnet_tie_windows(n, h, w, c, seed):
    """SegNet's index, taken after the bf16 bias add and the relu: b2 per
    channel in {256, -3, 0, 1}. With 256 the bf16 add rounds z = 0 and 1 to
    the same 256 (the spacing there is 2), so windows tie only after it;
    -3 makes every window all-zero after the relu (index 0); 0 keeps
    c = b > a. C must be a multiple of 4."""
    pats = torch.tensor([[1, 0, 3, 2], [0, 1, 0, 1], [1, 2, 2, 0], [2, 1, 0, 2],
                         [0, 0, 0, 0], [3, 1, 3, 0]], dtype=torch.float32)
    b2 = torch.tensor([256.0, -3.0, 0.0, 1.0]).repeat(c // 4)
    return (*_windows(pats, n, h, w, c, seed), b2)


def int_case(n, h, w, c, seed):
    """Random small integers with repeated kernel taps: many ties."""
    g = torch.Generator().manual_seed(seed)
    z1 = torch.randint(-2, 3, (n, h, w, c), generator=g).float()
    k2 = torch.randint(-1, 2, (c, c, 3, 3), generator=g).float()
    k2[:, :, 1] = k2[:, :, 0]
    return z1, k2, torch.randint(-1, 2, (c,), generator=g).float()
