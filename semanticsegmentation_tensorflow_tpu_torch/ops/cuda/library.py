"""What the registered kernel ops share.

The inference kernels' wrappers (``stage1_tail``, ``stage1_tail_segnet``,
``pool_argmax``, ``unpool``, the overlay and ``winograd_fwd``) each run a
torch op of the ``segport`` namespace (``torch.library.custom_op``), whose
CPU implementation is the kernel's plain version and whose CUDA one launches
the kernel (or raises). The dispatcher picks between them by the tensors'
device when the op runs, not when a program is traced, so an exported
program (``infer/export.py``) launches the kernels on the card.

Training never differentiates through these ops: it runs the kernels'
autograd Functions (``Stage1Tail``, ``MaxPoolArgmax``, ...), whose backward
launches the backward kernels. On the CPU the ops are differentiable all the
same, through their plain versions (:func:`register_plain_autograd`), as the
wrappers were before they became ops; on the card their backward raises
rather than run the plain version.
"""

from __future__ import annotations

from typing import Callable

import torch


def register_plain_autograd(op, plain: Callable) -> None:
    """Make ``op`` differentiable on the CPU by autograd through ``plain``
    (the function its CPU implementation runs), recomputed in the backward.
    On any other device the backward raises."""

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*(t if torch.is_tensor(t) else None for t in inputs))
        ctx.others = [None if torch.is_tensor(t) else t for t in inputs]

    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if any(t is not None and t.device.type != "cpu" for t in saved):
            raise RuntimeError(f"{op._qualname}: no gradient on the card; train "
                               "through the kernel's autograd Function")
        want = [t is not None and ctx.needs_input_grad[i]
                for i, t in enumerate(saved)]
        with torch.enable_grad():
            args = [o if t is None else
                    t.detach().requires_grad_(w) for t, o, w in
                    zip(saved, ctx.others, want)]
            out = plain(*args)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            leaves = [a for a, w in zip(args, want) if w]
            got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                           [g for _, g in pairs],
                                           allow_unused=True)
                       if pairs and leaves else [None] * len(leaves))
        return tuple(next(got) if w else None for w in want)

    op.register_autograd(backward, setup_context=setup_context)
