"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core``, ``dist``, ``models``, ``serve``, ``train``,
``checkpoint``, ``kernels``, ``launch``)
and is held to it by the parity tests in ``tests/test_torch_*.py``.  It
imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  On
a CUDA tensor, attention, the experts and the recurrences run in the
hand-written kernels of ``kernels/`` (built with ``nvcc`` at first use),
and so do their gradients (decode attention has none: it is decode only);
their plain PyTorch versions run only for CPU tensors.
"""
