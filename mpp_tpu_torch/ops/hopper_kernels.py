"""Wrappers of the port's hand-written CUDA kernels.

Each kernel sits beside its plain PyTorch version.  The first three
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

The SpMV family (``csrc/spmv_family_kernels.cu``) serves the public ops
and the SpMV measurement harness (``tools/exp_spmv.py``):

* :func:`tridiag_spmv_chain` — y = (scale T)^K x with the bands resident
  in registers; replaces ``tridiag_spmv_chain`` (l.214-247).
* :func:`tridiag_jacobi_smooth` — K weighted-Jacobi sweeps with T and b
  resident; replaces ``tridiag_jacobi_smooth`` (l.250-286).
* :func:`spmv_variant` — y = T x in f32 by tiles of whole columns, the
  neighbours loaded or shuffled, one block per tile or a persistent grid;
  replaces ``pallas_kernel`` and ``pallas_kernel_cp`` of the JAX package's
  ``tools/exp_spmv.py``.
* :func:`spmv_packed` — y = T x with the bands packed ``[ncol, 3*nz]``;
  replaces ``packed_kernel`` of ``tools/exp_spmv.py``.
* :func:`stream_ceiling` — the harness's elementwise 4-read, 1-write pass
  (the yardstick XLA fused in the JAX tool; no TPU kernel).

Dispatch rule: a CPU tensor runs the plain version (``ops/tridiag.py``,
``ops/block_thomas.py``, the ``*_plain`` functions here);
a CUDA tensor launches the kernel, building it at first use
(``ops/_build.py``), or raises.  A build or launch failure raises; nothing
falls back.  Each launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import torch

from mpp_tpu_torch.ops import _build
from mpp_tpu_torch.ops.block_thomas import block_thomas
from mpp_tpu_torch.ops import tridiag
from mpp_tpu_torch.ops.tridiag import thomas as thomas_plain
from mpp_tpu_torch.ops.tridiag import tridiag_matvec

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"thomas": 0, "tridiag_spmv": 0, "tridiag_spmv_mixed": 0,
            "block_thomas2": 0, "tridiag_spmv_chain": 0,
            "tridiag_jacobi_smooth": 0, "spmv_variant": 0, "spmv_packed": 0,
            "stream_ceiling": 0}

#: the largest nz of the register-resident chain and smoother (16 slots of
#: 32 levels in each lane of a warp)
RESIDENT_MAX_NZ = 512


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


def _resident(name, arrays, x, iters):
    """Checks shared by the chain and the smoother."""
    _check(name, arrays, (torch.float32, torch.float64), x)
    if len({a.dtype for a in arrays}) != 1:
        raise ValueError(f"{name}: all arrays must share one dtype")
    if isinstance(iters, bool) or not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{name}: iters must be an int >= 0, got {iters!r}")
    if x.shape[1] > RESIDENT_MAX_NZ:
        raise ValueError(f"{name}: nz={x.shape[1]} > {RESIDENT_MAX_NZ}, the "
                         "largest column the register-resident kernel holds")


def tridiag_spmv_chain(dl, d, du, x, iters, scale=1.0):
    """y = (scale * T)^iters x over ``[ncol, nz]`` arrays, f32 or f64,
    nz <= ``RESIDENT_MAX_NZ``; the bands are read once for all ``iters``
    applications."""
    _resident("tridiag_spmv_chain", (dl, d, du, x), x, iters)
    if x.device.type == "cpu":
        return tridiag.tridiag_spmv_chain(dl, d, du, x, iters, scale)
    ncol, nz = x.shape
    y = torch.empty_like(x)
    if ncol == 0 or nz == 0:
        return y
    lib = _build.library()
    fn = lib.mpp_spmv_chain_f64 if x.dtype == torch.float64 else \
        lib.mpp_spmv_chain_f32
    with torch.cuda.device(x.device):
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), x.data_ptr(),
                y.data_ptr(), ncol, nz, iters, float(scale), _stream(x))
    _launched("tridiag_spmv_chain", rc)
    return y


def tridiag_jacobi_smooth(dl, d, du, b, x, iters, omega=2.0 / 3.0):
    """``iters`` sweeps x <- x + omega * (b - T x) / d over ``[ncol, nz]``
    arrays, f32 or f64, nz <= ``RESIDENT_MAX_NZ``; T and b are read once
    for all sweeps."""
    _resident("tridiag_jacobi_smooth", (dl, d, du, b, x), x, iters)
    if x.device.type == "cpu":
        return tridiag.tridiag_jacobi_smooth(dl, d, du, b, x, iters, omega)
    ncol, nz = x.shape
    y = torch.empty_like(x)
    if ncol == 0 or nz == 0:
        return y
    lib = _build.library()
    fn = lib.mpp_jacobi_smooth_f64 if x.dtype == torch.float64 else \
        lib.mpp_jacobi_smooth_f32
    with torch.cuda.device(x.device):
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                x.data_ptr(), y.data_ptr(), ncol, nz, iters, float(omega),
                _stream(x))
    _launched("tridiag_jacobi_smooth", rc)
    return y


#: neighbour exchanges and grids of :func:`spmv_variant`
EXCHANGES = ("concat", "roll")
GRIDS = ("tile", "persistent")


def spmv_variant(dl, d, du, x, exchange="concat", block=1024, grid="tile"):
    """y = T x over f32 ``[ncol, nz]`` arrays by tiles of ``block`` whole
    columns (``ncol % block == 0``, the Pallas ``block_cols``).
    ``exchange``: "concat" loads the neighbours, "roll" shuffles them
    between lanes; ``grid``: "tile" is one thread block per tile (the
    "parallel" grid), "persistent" one per SM walking the tiles in order
    (the "arbitrary" one).  Every choice computes the same y."""
    name = "spmv_variant"
    _check(name, (dl, d, du, x), (torch.float32,), x)
    if exchange not in EXCHANGES:
        raise ValueError(f"{name}: exchange {exchange!r} not in {EXCHANGES}")
    if grid not in GRIDS:
        raise ValueError(f"{name}: grid {grid!r} not in {GRIDS}")
    ncol, nz = x.shape
    if isinstance(block, bool) or not isinstance(block, int) or block < 1 \
            or ncol % block or block * nz > 2 ** 30:
        raise ValueError(f"{name}: block={block!r} must be an int >= 1 "
                         f"dividing ncol={ncol}, with block * nz <= 2**30")
    if x.device.type == "cpu":
        return tridiag_matvec(dl, d, du, x)
    y = torch.empty_like(x)
    if nz == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.mpp_spmv_variant_f32(
            dl.data_ptr(), d.data_ptr(), du.data_ptr(), x.data_ptr(),
            y.data_ptr(), ncol, nz, block, int(exchange == "roll"),
            int(grid == "persistent"), _stream(x))
    _launched(name, rc)
    return y


def spmv_packed_plain(t, x):
    """Plain version of the packed action: the three bands sliced from
    ``t = [dl | d | du]``, then the stencil."""
    nz = x.shape[-1]
    return tridiag_matvec(t[..., :nz], t[..., nz:2 * nz], t[..., 2 * nz:], x)


def spmv_packed(t, x):
    """y = T x with the bands packed into one f32 ``[ncol, 3*nz]`` array
    ``t = [dl | d | du]`` and x, y f32 ``[ncol, nz]``."""
    name = "spmv_packed"
    _check(name, (x,), (torch.float32,), x)
    if not isinstance(t, torch.Tensor) or t.dim() != 2 or \
            tuple(t.shape) != (x.shape[0], 3 * x.shape[1]):
        raise ValueError(f"{name}: t must be a [ncol, 3*nz] = "
                         f"{(x.shape[0], 3 * x.shape[1])} tensor, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dtype != torch.float32 or t.device != x.device or \
            not t.is_contiguous():
        raise ValueError(f"{name}: t must be a contiguous f32 tensor on "
                         f"{x.device}")
    if x.device.type == "cpu":
        return spmv_packed_plain(t, x)
    ncol, nz = x.shape
    y = torch.empty_like(x)
    if ncol == 0 or nz == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.mpp_spmv_packed_f32(t.data_ptr(), x.data_ptr(), y.data_ptr(),
                                     ncol, nz, _stream(x))
    _launched(name, rc)
    return y


def stream_ceiling_plain(a, b, c, x):
    """Plain version of the elementwise pass: min(a + x*(b - x*c), 2) * 0.9
    (the loop body of the JAX tool's ``ceiling``)."""
    return torch.clamp(a + x * (b - x * c), max=2.0) * 0.9


def stream_ceiling(a, b, c, x):
    """min(a + x*(b - x*c), 2) * 0.9 over f32 ``[ncol, nz]`` arrays in one
    pass: 4 streams read, 1 written."""
    _check("stream_ceiling", (a, b, c, x), (torch.float32,), x)
    if x.device.type == "cpu":
        return stream_ceiling_plain(a, b, c, x)
    ncol, nz = x.shape
    y = torch.empty_like(x)
    if ncol == 0 or nz == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.mpp_stream_ceiling_f32(a.data_ptr(), b.data_ptr(),
                                        c.data_ptr(), x.data_ptr(),
                                        y.data_ptr(), ncol, nz, _stream(x))
    _launched("stream_ceiling", rc)
    return y
