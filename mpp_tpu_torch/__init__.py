"""mpp_tpu_torch — the PyTorch + CUDA port of ``mpp_tpu``.

A second package beside the JAX reference ``mpp_tpu``, laid out like it so
each module's counterpart is easy to find (``ops/``, ``models/``,
``batched/``, ``driver/``, ``problems/``, ``tools/``).  It runs the ALM
VSFM coupling step and the coupled TH step end to end on one NVIDIA GPU;
every Pallas kernel of the JAX package is a hand-written CUDA C++ kernel
here (``csrc/*.cu``, bound in ``ops/hopper_kernels.py``).

Rules of the package:

* it imports ``torch`` and never ``jax``, and nothing of ``mpp_tpu``: the
  host modules it needs (``constants``, ``dtypes``) are its own copies;
* entry points run on the card unless the caller passes ``device="cpu"``
  (``device.py``); a CUDA device without a card raises;
* numeric code is plain functions on ``[ncol, n]`` tensors with the device
  and dtype taken from the state; there is no global default dtype;
* a kernel wrapper runs its plain PyTorch version only for CPU tensors; a
  CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
