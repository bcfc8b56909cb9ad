"""The kernels' registered torch ops (``segport::``, ``ops/cuda/library.py``)
on the CPU: ``torch.library.opcheck`` on each (its schema, its fake
implementation against the real one, its autograd registration and a trace
with a symbolic batch), each op equal to its plain version, and the
gradients through the ops on the CPU equal to autograd through the plain
versions. The CUDA implementations are held against the plain versions on
the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import (  # noqa: F401
    overlay, pool, stage1, winograd,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
    pool_argmax_plain, unpool_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    stage1_tail_plain, stage1_tail_segnet_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
    u_for, winograd_fwd_plain,
)

ops = torch.ops.segport


def _t(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                            .astype(np.float32))


def _cases():
    """(name, op, args, plain) at small shapes, float args differentiable."""
    z1, k2, b2 = _t(0, 2, 4, 6, 16), _t(1, 16, 16, 3, 3) / 12, _t(2, 16) / 10
    x = _t(3, 2, 4, 6, 8)
    pooled, idx = pool_argmax_plain(x)
    img = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 5, 7, 3),
                                                             np.uint8))
    logits, pal = _t(5, 2, 8, 8, 3), torch.tensor([[0, 0, 0], [255, 0, 255],
                                                    [0, 255, 0]], dtype=torch.float32)
    wx, ww, wb = _t(6, 1, 4, 4, 32), _t(7, 32, 32, 3, 3) / 17, _t(8, 32) / 10
    u = u_for(ww, "f2", torch.float32)
    o = _t(9, 1, 4, 4, 32)
    return [
        ("stage1_tail", ops.stage1_tail, (z1, k2, b2), stage1_tail_plain),
        ("stage1_tail_segnet", ops.stage1_tail_segnet, (z1, k2, b2),
         stage1_tail_segnet_plain),
        ("pool_argmax", ops.pool_argmax, (x,), pool_argmax_plain),
        ("unpool", ops.unpool, (pooled, idx), unpool_plain),
        ("overlay", ops.overlay, (img, logits, pal, 0.4, False),
         lambda i, lg, p, a, b0: argmax_colormap_overlay_plain(
             i, lg[:, :5, :7], p, a, b0)),
        ("winograd_fwd", ops.winograd_fwd, (wx, u, wb, None, "f2", "bias_relu"),
         winograd_fwd_plain),
        ("winograd_fwd_masked", ops.winograd_fwd, (wx, u, None, o, "f2", "none"),
         winograd_fwd_plain),
    ]


CASES = {c[0]: c for c in _cases()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck(name):
    """With the float inputs differentiable (the forward is checked as
    well, and the gradients through the autograd registration)."""
    _, op, args, _ = CASES[name]
    torch.library.opcheck(op, tuple(
        a.clone().requires_grad_() if torch.is_tensor(a) and a.is_floating_point()
        else a for a in args))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_equals_plain_and_differentiates_through_it(name):
    """Outputs bit-equal to the plain version, NHWC-contiguous; float
    inputs' gradients equal to autograd through the plain version."""
    _, op, args, plain = CASES[name]
    got, want = op(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == w.dtype
        assert torch.equal(g, w)
    leaves = [i for i, a in enumerate(args)
              if torch.is_tensor(a) and a.is_floating_point()]
    if not any(o.is_floating_point() for o in want):
        return      # integer outputs (the overlay): nothing to differentiate

    def grads(fn):
        xs = [a.clone().requires_grad_() if i in leaves else a
              for i, a in enumerate(args)]
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        cot = _t(10, *out.shape)
        return torch.autograd.grad(out, [xs[i] for i in leaves], cot,
                                   allow_unused=True)

    for g, w in zip(grads(op), grads(plain)):
        assert (g is None and w is None) or torch.equal(g, w)
