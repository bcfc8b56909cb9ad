"""PyTorch/CUDA port of semanticsegmentation_tensorflow_tpu for one NVIDIA H100.

A second package beside the JAX one, which stays the reference. The module
paths mirror the JAX package's, so each counterpart is found by name. The
port imports ``torch`` and nothing of JAX or of the JAX package; its
``config.py`` is a copy of the JAX package's presets, pinned equal by a test.

Layout and dtype policy follow the JAX package: NHWC activations at every
public function, float32 parameters, bf16 conv inputs and weights with f32
accumulation, logits cast to float32 at the end.

The TPU's Pallas kernels on the ported paths (inference and training) are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use (``ops/cuda/build.py``). Each kernel's wrapper takes its plain PyTorch
version for CPU tensors only.
"""

__version__ = "0.1.0"
