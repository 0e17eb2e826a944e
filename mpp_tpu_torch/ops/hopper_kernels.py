"""Wrappers of the hand-written CUDA kernels on the Newton paths.

Four kernels, each beside its plain PyTorch version; the first three
(``csrc/tridiag_kernels.cu``) are on the VSFM path, the fourth
(``csrc/block_thomas_kernels.cu``) on the TH path:

* :func:`thomas` — batched tridiagonal solve, the Newton direction;
  replaces ``pallas_thomas`` (``mpp_tpu/ops/pallas_kernels.py:131-211``).
* :func:`tridiag_spmv` — y = T x in f32/f64, the Jacobian action for the
  line search's initial slope; replaces ``tridiag_spmv`` (l.49-73).
* :func:`tridiag_spmv_mixed` — the same action with the bands stored in
  bf16 and f32 state, the f32 runs' form; replaces ``tridiag_spmv_mixed``
  (l.76-111).
* :func:`block_thomas2` — batched 2x2 block-tridiagonal solve, the TH
  Newton direction; replaces ``pallas_block_thomas2`` (l.289-408).

Dispatch rule: a CPU tensor runs the plain version (``ops/tridiag.py``,
``ops/block_thomas.py``);
a CUDA tensor launches the kernel, building it at first use
(``ops/_build.py``), or raises.  A build or launch failure raises; nothing
falls back.  Each launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import torch

from mpp_tpu_torch.ops import _build
from mpp_tpu_torch.ops.block_thomas import block_thomas
from mpp_tpu_torch.ops.tridiag import thomas as thomas_plain
from mpp_tpu_torch.ops.tridiag import tridiag_matvec

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"thomas": 0, "tridiag_spmv": 0, "tridiag_spmv_mixed": 0,
            "block_thomas2": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, arrays, dtypes, ref):
    """Raise ValueError unless every array is a contiguous 2-D tensor of
    ``ref``'s shape on ``ref``'s device with a dtype in ``dtypes``."""
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected tensors, got {type(a)}")
        if a.dim() != 2 or a.shape != ref.shape:
            raise ValueError(f"{name}: expected [ncol, nz] arrays of one "
                             f"shape, got {tuple(a.shape)} and "
                             f"{tuple(ref.shape)}")
        if a.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {a.dtype} not in {dtypes}")
        if a.device != ref.device:
            raise ValueError(f"{name}: arrays on {a.device} and {ref.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: arrays must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ref.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
    LAUNCHES[name] += 1


def thomas(dl, d, du, b):
    """Solve T x = b for batched tridiagonal T, ``[ncol, nz]`` each, f32 or
    f64, any nz >= 1.  No pivoting: diagonally dominant systems only.
    ``dl[:, 0]`` and ``du[:, -1]`` are unused."""
    _check("thomas", (dl, d, du, b), (torch.float32, torch.float64), d)
    if len({dl.dtype, d.dtype, du.dtype, b.dtype}) != 1:
        raise ValueError("thomas: all arrays must share one dtype")
    if d.device.type == "cpu":
        return thomas_plain(dl, d, du, b)
    ncol, nz = d.shape
    x = torch.empty_like(b)
    if ncol == 0 or nz == 0:
        return x
    cp = torch.empty_like(b)
    lib = _build.library()
    fn = lib.mpp_thomas_f64 if d.dtype == torch.float64 else \
        lib.mpp_thomas_f32
    with torch.cuda.device(d.device):
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                cp.data_ptr(), x.data_ptr(), ncol, nz, _stream(d))
    _launched("thomas", rc)
    return x


def tridiag_spmv(dl, d, du, x):
    """y = T x over ``[ncol, nz]`` arrays, f32 or f64, any nz."""
    _check("tridiag_spmv", (dl, d, du, x), (torch.float32, torch.float64), x)
    if len({dl.dtype, d.dtype, du.dtype, x.dtype}) != 1:
        raise ValueError("tridiag_spmv: all arrays must share one dtype")
    if x.device.type == "cpu":
        return tridiag_matvec(dl, d, du, x)
    ncol, nz = x.shape
    y = torch.empty_like(x)
    if ncol == 0 or nz == 0:
        return y
    lib = _build.library()
    fn = lib.mpp_spmv_f64 if x.dtype == torch.float64 else lib.mpp_spmv_f32
    with torch.cuda.device(x.device):
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), x.data_ptr(),
                y.data_ptr(), ncol, nz, _stream(x))
    _launched("tridiag_spmv", rc)
    return y


def tridiag_spmv_mixed_plain(dl16, d16, du16, x):
    """Plain version of the mixed action: bands widened to f32, then the
    f32 stencil."""
    return tridiag_matvec(dl16.to(x.dtype), d16.to(x.dtype),
                          du16.to(x.dtype), x)


def tridiag_spmv_mixed(dl16, d16, du16, x):
    """y = T x with the bands stored in bf16 and x, y and the arithmetic in
    f32, ``[ncol, nz]``, any nz."""
    _check("tridiag_spmv_mixed", (dl16, d16, du16), (torch.bfloat16,), x)
    _check("tridiag_spmv_mixed", (x,), (torch.float32,), x)
    if x.device.type == "cpu":
        return tridiag_spmv_mixed_plain(dl16, d16, du16, x)
    ncol, nz = x.shape
    y = torch.empty_like(x)
    if ncol == 0 or nz == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.mpp_spmv_bf16_f32(dl16.data_ptr(), d16.data_ptr(),
                                   du16.data_ptr(), x.data_ptr(),
                                   y.data_ptr(), ncol, nz, _stream(x))
    _launched("tridiag_spmv_mixed", rc)
    return y


def _check_blocks(L, D, U, b):
    """Raise ValueError unless L/D/U are ``[ncol, n, 2, 2]`` and b
    ``[ncol, n, 2]`` contiguous tensors of one float dtype on one CPU or
    CUDA device."""
    name = "block_thomas2"
    for a in (L, D, U, b):
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected tensors, got {type(a)}")
    if b.dim() != 3 or b.shape[-1] != 2:
        raise ValueError(f"{name}: b must be [ncol, n, 2], got "
                         f"{tuple(b.shape)}")
    blk = tuple(b.shape) + (2,)
    for a in (L, D, U):
        if tuple(a.shape) != blk:
            raise ValueError(f"{name}: blocks must be {blk}, got "
                             f"{tuple(a.shape)}")
    if b.dtype not in (torch.float32, torch.float64) or \
            len({a.dtype for a in (L, D, U, b)}) != 1:
        raise ValueError(f"{name}: all arrays must share one dtype, f32 or "
                         f"f64; got {[a.dtype for a in (L, D, U, b)]}")
    if len({a.device for a in (L, D, U, b)}) != 1:
        raise ValueError(f"{name}: arrays on several devices")
    if b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {b.device}")
    if not all(a.is_contiguous() for a in (L, D, U, b)):
        raise ValueError(f"{name}: arrays must be contiguous")


def block_thomas2(L, D, U, b):
    """Solve T x = b for batched 2x2 block-tridiagonal T: blocks
    ``[ncol, n, 2, 2]`` (``L[:, 0]`` and ``U[:, n-1]`` unused), b and x
    ``[ncol, n, 2]``, f32 or f64, any n.  No pivoting: block diagonally
    dominant systems only."""
    _check_blocks(L, D, U, b)
    if b.device.type == "cpu":
        return block_thomas(L, D, U, b)
    ncol, n = b.shape[0], b.shape[1]
    x = torch.empty_like(b)
    if ncol == 0 or n == 0:
        return x
    cp = torch.empty_like(D)
    lib = _build.library()
    fn = lib.mpp_block_thomas2_f64 if b.dtype == torch.float64 else \
        lib.mpp_block_thomas2_f32
    with torch.cuda.device(b.device):
        rc = fn(L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
                cp.data_ptr(), x.data_ptr(), ncol, n, _stream(b))
    _launched("block_thomas2", rc)
    return x
