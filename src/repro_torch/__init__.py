"""repro_torch — the PFCS serving path on PyTorch and CUDA (NVIDIA Hopper).

A port of ``repro`` that mirrors its module paths one for one
(``repro_torch/x/y.py`` is held against ``repro/x/y.py``).  Placement
state stays in numpy on the host; the six discovery kernels (the
divisibility mask, the squarefree factorization and the gcd, each flat
and over 32-bit limbs for wide registries) are CUDA C++ built for
``sm_90a`` at first use (``kernels/csrc``).  Entry points take a
``device`` that defaults to ``"cuda"``; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.  See ROADMAP.md for what is
still to port.
"""

__version__ = "0.1.0"
