"""mpqe_tpu_torch: the PyTorch/CUDA port of ``mpqe_tpu``.

MPQE query encoding and its GQE baselines, their training, evaluation and
top-k answer serving on an NVIDIA GPU.  The port
is a package of its own: it imports ``torch`` and numpy, never ``jax`` and
nothing of ``mpqe_tpu`` (whose ``__init__`` pulls in the JAX model), and
keeps its own copies of the host-side modules it needs.  The module paths
mirror ``mpqe_tpu`` so each piece's reference is easy to find.

Kernels that ``mpqe_tpu`` wrote in Pallas for the TPU are hand-written
CUDA C++ here (sources under ``csrc/``), built with ``nvcc`` at first use.
Every entry point runs on the card unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
