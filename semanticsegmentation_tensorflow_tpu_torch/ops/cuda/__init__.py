"""Hand-written CUDA kernels (``csrc/*.cu``) and their PyTorch wrappers.

Nothing here builds or imports a compiler at import time: the library is
built at a wrapper's first launch on a CUDA tensor (``build.lib()``).
"""

import sys


def launch_counters() -> list:
    """The kernel wrappers of the modules here imported so far: each
    function defined in one of them with an int ``launches`` count."""
    out = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith(__name__ + "."):
            continue
        out += [fn for fn in vars(mod).values()
                if isinstance(getattr(fn, "launches", None), int)
                and getattr(fn, "__module__", None) == name]
    return out
