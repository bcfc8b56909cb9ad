"""Hand-written CUDA kernels (``csrc/*.cu``) and their PyTorch wrappers.

Nothing here builds or imports a compiler at import time: the library is
built at a wrapper's first launch on a CUDA tensor (``build.lib()``).
"""
