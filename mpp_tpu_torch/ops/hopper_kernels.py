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

``csrc/block_thomas_small_kernels.cu`` holds the block solve of the canopy
and the block plans; it replaces no Pallas kernel but the JAX package's
``lax.scan`` sweeps of ``block_thomas`` (``mpp_tpu/ops/block_thomas.py:
22-122``):

* :func:`block_thomas_small` — batched block-tridiagonal solve with m x m
  blocks, 1 <= m <= 8, small_solve's pivoting inside each block; the
  callers reach it through ``ops/block_structure.block_solve``.

The SpMV family (``csrc/spmv_family_kernels.cu``) serves the public ops
and the SpMV measurement harness (``tools/exp_spmv.py``):

* :func:`tridiag_spmv_chain` — y = (scale T)^K x with the bands read once
  (in registers, in shared memory, or streamed past both); replaces
  ``tridiag_spmv_chain`` (l.214-247).
* :func:`tridiag_jacobi_smooth` — K weighted-Jacobi sweeps, T and b kept
  the same way; replaces ``tridiag_jacobi_smooth`` (l.250-286).
* :func:`spmv_variant` — y = T x in f32 by tiles of whole columns, the
  neighbours loaded or shuffled, one block per tile or a persistent grid;
  replaces ``pallas_kernel`` and ``pallas_kernel_cp`` of the JAX package's
  ``tools/exp_spmv.py``.
* :func:`spmv_packed` — y = T x with the bands packed ``[ncol, 3*nz]``;
  replaces ``packed_kernel`` of ``tools/exp_spmv.py``.
* :func:`stream_ceiling` — the harness's elementwise 4-read, 1-write pass
  (the yardstick XLA fused in the JAX tool; no TPU kernel).

The ILU(0) pair (``csrc/ilu0_kernels.cu``) serves every Krylov caller
through ``batched/ilu_gmres.BatchedILU0``; it replaces no Pallas kernel but
the JAX package's ``lax.scan`` row sweeps
(``mpp_tpu/batched/ilu_gmres.py:121-162``):

* :func:`ilu0_factor` — the numeric IKJ factorization of a batch of
  systems on one CSR sparsity, bit for bit :func:`ilu0_factor_plain`.
* :func:`ilu0_apply` — (LU)^-1 b: the unit-lower forward sweep, then the
  upper back sweep with the diagonal divide.

Both walk an :class:`ILU0Schedule` (``ops/ilu0_schedule.py``), built once a
sparsity: its connected components binned into parts that the kernels run
independently, each part's steps and levels, and the rule that picks a
kernel's form (staged or streamed) from the schedule's widths and the
kernels' shared-memory limits (:func:`ilu0_limits`); the plain forms walk
the same parts in lockstep.

Dispatch rule: a CPU tensor runs the plain version (``ops/tridiag.py``,
``ops/block_thomas.py``, the ``*_plain`` functions here);
a CUDA tensor launches the kernel, building it at first use
(``ops/_build.py``), or raises.  A build or launch failure raises; nothing
falls back.  Each launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import torch

from mpp_tpu_torch.ops import _build
from mpp_tpu_torch.ops.ilu0_schedule import LIMITS, ILU0Schedule
from mpp_tpu_torch.ops.block_thomas import block_thomas
from mpp_tpu_torch.ops import tridiag
from mpp_tpu_torch.ops.tridiag import thomas as thomas_plain
from mpp_tpu_torch.ops.tridiag import tridiag_matvec

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"thomas": 0, "tridiag_spmv": 0, "tridiag_spmv_mixed": 0,
            "block_thomas2": 0, "block_thomas_small": 0,
            "tridiag_spmv_chain": 0,
            "tridiag_jacobi_smooth": 0, "spmv_variant": 0, "spmv_packed": 0,
            "stream_ceiling": 0, "ilu0_factor": 0, "ilu0_apply": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_MAX_ON_CHIP = {}


def max_on_chip(kernel, dtype, memory="shared"):
    """The deepest column (levels) that ``kernel`` keeps on chip in
    ``dtype``: for "thomas" and "block_thomas2" with the carries in shared
    memory, for "tridiag_spmv_chain" and "tridiag_jacobi_smooth" with the
    bands, b and x in shared memory, or with ``memory="registers"`` in a
    warp's registers (those two only).  Deeper columns need a global
    scratch.  The launcher's own rule, read
    from the library (built at first use) once per kernel, dtype and
    memory.  (The ILU(0) kernels' limits: :func:`ilu0_limits`.)"""
    key = (kernel, dtype, memory)
    if key not in _MAX_ON_CHIP:
        which = {"shared": "max_on_chip",
                 "registers": "max_in_registers"}[memory]
        query = getattr(_build.library(), f"mpp_{kernel}_{which}")
        _MAX_ON_CHIP[key] = query(torch.empty((), dtype=dtype).element_size())
    return _MAX_ON_CHIP[key]


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
    lib = _build.library()
    cp = torch.empty_like(b) if nz > max_on_chip("thomas", b.dtype) else None
    fn = lib.mpp_thomas_f64 if d.dtype == torch.float64 else \
        lib.mpp_thomas_f32
    with torch.cuda.device(d.device):
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                None if cp is None else cp.data_ptr(), x.data_ptr(), ncol,
                nz, _stream(d))
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
    lib = _build.library()
    cp = torch.empty_like(D) if n > max_on_chip("block_thomas2", b.dtype) \
        else None
    fn = lib.mpp_block_thomas2_f64 if b.dtype == torch.float64 else \
        lib.mpp_block_thomas2_f32
    with torch.cuda.device(b.device):
        rc = fn(L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
                None if cp is None else cp.data_ptr(), x.data_ptr(), ncol, n,
                _stream(b))
    _launched("block_thomas2", rc)
    return x


#: the largest block :func:`block_thomas_small` takes
BLOCK_SMALL_MAX = 8


def _check_small_blocks(L, D, U, b):
    """Raise ValueError unless b is ``[..., n, m]`` with 1 <= m <= 8 and
    L, D, U ``[..., n, m, m]`` of b's leading dims, all contiguous tensors
    of one dtype (f32 or f64) on one CPU or CUDA device."""
    name = "block_thomas_small"
    for a in (L, D, U, b):
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected tensors, got {type(a)}")
    if b.dim() < 2 or not 1 <= b.shape[-1] <= BLOCK_SMALL_MAX:
        raise ValueError(f"{name}: b must be [..., n, m] with 1 <= m <= "
                         f"{BLOCK_SMALL_MAX}, got {tuple(b.shape)}")
    blk = tuple(b.shape) + (b.shape[-1],)
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


def block_thomas_small(L, D, U, b):
    """Solve T x = b for batched block-tridiagonal T with m x m blocks,
    1 <= m <= 8: blocks ``[..., n, m, m]`` (``L[..., 0]`` and ``U[..., n-1]``
    unused), b and x ``[..., n, m]``, f32 or f64, any n; the leading dims
    are the batch.  small_solve's contract inside each block (m = 2 the
    adjugate, 3 <= m <= 8 partial pivoting), none across levels: block
    diagonally dominant systems.  On the card one launch, within rounding
    of :func:`ops.block_thomas.block_thomas` (not bit for bit)."""
    _check_small_blocks(L, D, U, b)
    if b.device.type == "cpu":
        return block_thomas(L, D, U, b)
    n, m = b.shape[-2], b.shape[-1]
    x = torch.empty_like(b)
    nsys = b.numel() // max(n * m, 1)
    if nsys == 0 or n == 0:
        return x
    lib = _build.library()
    # the scratch of Cp_k, k < n - 1 (the kernel strides it like D)
    cp = torch.empty_like(D) if n > 1 else None
    fn = lib.mpp_block_thomas_small_f64 if b.dtype == torch.float64 else \
        lib.mpp_block_thomas_small_f32
    with torch.cuda.device(b.device):
        rc = fn(L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
                None if cp is None else cp.data_ptr(), x.data_ptr(), nsys, n,
                m, _stream(b))
    _launched("block_thomas_small", rc)
    return x


def _resident(name, arrays, x, iters):
    """Checks shared by the chain and the smoother."""
    _check(name, arrays, (torch.float32, torch.float64), x)
    if len({a.dtype for a in arrays}) != 1:
        raise ValueError(f"{name}: all arrays must share one dtype")
    if isinstance(iters, bool) or not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{name}: iters must be an int >= 0, got {iters!r}")


def _scratch(name, x, iters):
    """The streamed form's ping-pong buffer: needed past the on-chip depth
    when there is more than one sweep."""
    if x.shape[1] > max_on_chip(name, x.dtype) and iters > 1:
        return torch.empty_like(x)
    return None


def tridiag_spmv_chain(dl, d, du, x, iters, scale=1.0):
    """y = (scale * T)^iters x over ``[ncol, nz]`` arrays, f32 or f64, any
    nz; the bands are read once for all ``iters`` applications where the
    column fits on chip (``max_on_chip``: in registers, then in shared
    memory), and once a sweep past that."""
    name = "tridiag_spmv_chain"
    _resident(name, (dl, d, du, x), x, iters)
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
        sc = _scratch(name, x, iters)
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), x.data_ptr(),
                None if sc is None else sc.data_ptr(), y.data_ptr(), ncol,
                nz, iters, float(scale), _stream(x))
    _launched(name, rc)
    return y


def tridiag_jacobi_smooth(dl, d, du, b, x, iters, omega=2.0 / 3.0):
    """``iters`` sweeps x <- x + omega * (b - T x) / d over ``[ncol, nz]``
    arrays, f32 or f64, any nz; T and b are read once for all sweeps where
    the column fits on chip, as in :func:`tridiag_spmv_chain`.  In f32 the
    register form divides through a reciprocal taken once a level in f64,
    which gives ``/``'s bits (``csrc/spmv_family_kernels.cu``); every other
    form, and f64, divides with ``/``."""
    name = "tridiag_jacobi_smooth"
    _resident(name, (dl, d, du, b, x), x, iters)
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
        sc = _scratch(name, x, iters)
        rc = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                x.data_ptr(), None if sc is None else sc.data_ptr(),
                y.data_ptr(), ncol, nz, iters, float(omega), _stream(x))
    _launched(name, rc)
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


# ---- ILU(0): the factor and the apply -------------------------------------

_ILU0_LIMITS = {}


def ilu0_limits(dtype):
    """The ILU(0) kernels' limits for ``dtype`` values, by ``LIMITS`` name
    (``csrc/ilu0_kernels.cu``'s ``mpp_ilu0_limit``, read from the library
    once a dtype): the staged form's shared memory, a ring stage's words
    and values, the ring's stages, and the streamed forms' on-chip cells
    (factor) and rows of y (apply); past those the streamed forms keep
    the rest in a global scratch."""
    elem = torch.empty((), dtype=dtype).element_size()
    if elem not in _ILU0_LIMITS:
        q = _build.library().mpp_ilu0_limit
        _ILU0_LIMITS[elem] = {k: q(i, elem) for i, k in enumerate(LIMITS)}
    return _ILU0_LIMITS[elem]


def _check_ilu0(name, sched, arrays, widths):
    """Raise ValueError unless ``sched`` is an ILU0Schedule and every array
    is a contiguous 2-D f32 / f64 tensor of ``sched``'s ``widths`` ("nnz"
    or "n") columns, all of one dtype, batch and CPU or CUDA device."""
    if not isinstance(sched, ILU0Schedule):
        raise ValueError(f"{name}: sched must be an ILU0Schedule, got "
                         f"{type(sched)}")
    for a, w in zip(arrays, (getattr(sched, k) for k in widths)):
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected tensors, got {type(a)}")
        if a.dim() != 2 or a.shape[1] != w:
            raise ValueError(f"{name}: expected a [B, {w}] tensor, got "
                             f"{tuple(a.shape)}")
        if a.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"{name}: dtype {a.dtype} is not f32 or f64")
        if not a.is_contiguous():
            raise ValueError(f"{name}: arrays must be contiguous")
    ref = arrays[0]
    for a in arrays[1:]:
        if a.dtype != ref.dtype or a.device != ref.device or \
                a.shape[0] != ref.shape[0]:
            raise ValueError(f"{name}: arrays of one dtype, device and batch "
                             f"expected, got {a.dtype} / {ref.dtype}, "
                             f"{a.device} / {ref.device}, {a.shape[0]} / "
                             f"{ref.shape[0]}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ref.device}")


def ilu0_factor_plain(data, sched):
    """Plain version of :func:`ilu0_factor`: the steps of ``sched`` one at a
    time, every system of the batch in one gather / divide / scatter."""
    lp, ld, pij, pik, pkj = sched.sections(data.device, "factor", "lp", "ld",
                                           "pij", "pik", "pkj")
    lp_ptr, pair_ptr = sched.ptrs["lp_ptr"], sched.ptrs["pair_ptr"]
    f = data.clone()
    for s in range(len(lp_ptr) - 1):
        a, b = lp_ptr[s], lp_ptr[s + 1]
        f[:, lp[a:b]] = f[:, lp[a:b]] / f[:, ld[a:b]]
        c, d = pair_ptr[s], pair_ptr[s + 1]
        if d > c:
            # f_ij + (-(m f_kj)): the slots of a step are distinct
            f.index_add_(1, pij[c:d], f[:, pik[c:d]] * f[:, pkj[c:d]],
                         alpha=-1)
    return f


def ilu0_apply_plain(f, b, sched):
    """Plain version of :func:`ilu0_apply`: each level of the two sweeps as
    one gather, padded-row sum and scatter over the batch; the pads read an
    appended zero of f and of y."""
    fz = torch.cat([f, f.new_zeros(f.shape[0], 1)], dim=1)
    y = torch.cat([b, b.new_zeros(b.shape[0], 1)], dim=1)
    dpos, = sched.sections(b.device, "apply", "dpos")
    for tag in ("f_", "b_"):
        rows, pos, col = sched.sections(b.device, "apply", tag + "rows",
                                        tag + "pos", tag + "col")
        row_ptr, tab_ptr = sched.ptrs[tag + "row_ptr"], \
            sched.ptrs[tag + "tab_ptr"]
        for L, w in enumerate(sched.ptrs[tag + "width"]):
            r = slice(row_ptr[L], row_ptr[L + 1])
            t = slice(tab_ptr[L], tab_ptr[L + 1])
            s = torch.sum(fz[:, pos[t].view(-1, w)] * y[:, col[t].view(-1, w)],
                          dim=-1)
            if tag == "f_":
                y.index_add_(1, rows[r], s, alpha=-1)
            else:
                y.index_copy_(1, rows[r], (y[:, rows[r]] - s) / fz[:, dpos[r]])
    return y[:, :sched.n]


def _ilu0_launch(name, sched, lead, B, fn, args, elem_arrays):
    """Launch ``fn`` on ``sched``'s plan for ``lead``'s dtype at ``B``
    systems: the program, the spill scratch the streamed forms need past
    their on-chip limit, then ``args`` and the plan's shape."""
    plan = sched.plan(name.replace("ilu0_", ""), lead.element_size(), B,
                      ilu0_limits(lead.dtype))
    prog = sched.program_on(plan, lead.device)
    spill = plan.get("spill", 0)
    scratch = torch.empty(B * len(sched.parts) * spill, dtype=lead.dtype,
                          device=lead.device) if spill else None
    with torch.cuda.device(lead.device):
        rc = fn(*args, prog.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B,
                *elem_arrays, len(sched.parts), int(plan["form"] ==
                                                    "streamed"),
                plan["systems"], plan["lanes"], plan["threads"],
                plan["smem"], plan.get("on_chip", 0), spill, _stream(lead))
    _launched(name, rc)


def ilu0_factor(data, sched):
    """The ILU(0) factor values ``[B, nnz]`` of the systems ``data [B,
    nnz]`` (f32 or f64, contiguous) on ``sched``'s sparsity: PETSc's IKJ
    order (levels 0, natural ordering, no shift), any n, nnz and B; bit
    for bit :func:`ilu0_factor_plain`.  On the card one launch, in the
    form ``sched.plan`` picks: staged (the part's steps and G-lane
    systems' values in shared memory, 32 / G systems a warp) or streamed (the steps through a ring, the values in
    shared-memory cells, a global scratch past them)."""
    name = "ilu0_factor"
    _check_ilu0(name, sched, (data,), ("nnz",))
    if data.device.type == "cpu":
        return ilu0_factor_plain(data, sched)
    f = torch.empty_like(data)
    B = data.shape[0]
    if B == 0:
        return f
    lib = _build.library()
    fn = lib.mpp_ilu0_factor_f64 if data.dtype == torch.float64 else \
        lib.mpp_ilu0_factor_f32
    _ilu0_launch(name, sched, data, B, fn, (data.data_ptr(), f.data_ptr()),
                 (sched.n, sched.nnz))
    return f


def ilu0_apply(f, b, sched):
    """(LU)^-1 b for ``b [B, n]`` and the factor values ``f [B, nnz]`` (one
    dtype, f32 or f64, contiguous) on ``sched``'s sparsity: the unit-lower
    forward sweep, then the upper back sweep; any n, nnz and B, within
    1e-12 (f64) / 1e-5 (f32) of max |x| of :func:`ilu0_apply_plain`.  On the
    card one launch, in the form ``sched.plan`` picks: staged (the part's
    levels and G-lane systems' f and y in shared memory) or streamed (the
    levels and the f values they read through a ring, y in shared memory
    and a global scratch past it)."""
    name = "ilu0_apply"
    _check_ilu0(name, sched, (f, b), ("nnz", "n"))
    if b.device.type == "cpu":
        return ilu0_apply_plain(f, b, sched)
    x = torch.empty_like(b)
    B = b.shape[0]
    if B == 0 or sched.n == 0:
        return x
    lib = _build.library()
    fn = lib.mpp_ilu0_apply_f64 if b.dtype == torch.float64 else \
        lib.mpp_ilu0_apply_f32
    _ilu0_launch(name, sched, b, B, fn, (f.data_ptr(), b.data_ptr(),
                                         x.data_ptr()), (sched.n, sched.nnz))
    return x
