"""mm_s2ut_torch — the PyTorch/CUDA port of ``mm_s2ut``.

The JAX package ``mm_s2ut`` is the reference; this package mirrors its
module names (``config``, ``ops``, ``models``, ``infer``, ``data``,
``tasks``, ``train``, ``parallel``, ``eval``, ``cli``, ``inference``) and
runs the speech-to-unit translation paths, inference and training, on
NVIDIA Hopper GPUs. The attention contractions that the reference runs as
Pallas TPU kernels are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``); every
kernel has a plain PyTorch twin in the same module, which a CPU tensor
takes.

Importing this package imports neither JAX nor the ``mm_s2ut`` package.
"""

__version__ = "0.1.0"
