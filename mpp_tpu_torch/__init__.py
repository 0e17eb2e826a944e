"""mpp_tpu_torch — the PyTorch + CUDA port of ``mpp_tpu``.

A second package beside the JAX reference ``mpp_tpu``, laid out like it so
each module's counterpart is easy to find (``ops/``, ``models/``,
``batched/``, ``driver/``).  It runs the ALM VSFM coupling step end to end
on one NVIDIA GPU; the three Pallas kernels on that path are hand-written
CUDA C++ kernels here (``csrc/tridiag_kernels.cu``, bound in
``ops/hopper_kernels.py``).

Rules of the package:

* it imports ``torch`` and never ``jax``; from ``mpp_tpu`` it imports only
  the jax-free host modules ``constants``, ``varpar`` and
  ``dtypes.{mesh,conditions,regions,mpp_base}``;
* numeric code is plain functions on ``[ncol, n]`` tensors with the device
  and dtype taken from the state; there is no global default dtype;
* a kernel wrapper runs its plain PyTorch version only for CPU tensors; a
  CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
