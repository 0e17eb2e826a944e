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

``csrc/block_thomas_small_kernels.cu`` and ``csrc/block_thomas_large_
kernels.cu`` hold the block solve of the canopy and the block plans; they
replace no Pallas kernel but the JAX package's ``lax.scan`` sweeps of
``block_thomas`` (``mpp_tpu/ops/block_thomas.py:22-122``); the callers
reach them through ``ops/block_structure.block_solve``, by block size:

* :func:`block_thomas_small` — batched block-tridiagonal solve with m x m
  blocks, 1 <= m <= 8, small_solve's pivoting inside each block, in one
  of two forms (``BTS_FORMS``) that :func:`bts_form` picks by m and dtype.
* :func:`block_thomas_large` — the same with m >= 9, each level's block
  solve an elimination with partial pivoting (small_solve's
  ``linalg.solve`` branch), in one of two forms (``BTL_FORMS``) that
  :func:`btl_form` picks by shape: a thread block a system, or a
  thread-block cluster a system with the working matrix split over its
  CTAs' shared memory (:func:`btl_cluster_plan`).

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

The GMRES pair (``csrc/gmres_kernels.cu``) serves every Krylov caller
through ``batched/ilu_gmres.gmres_cycles``, one launch an inner step and one
a cycle; it replaces no Pallas kernel but the JAX package's ``fori_loop``s
of GMRES(m) (``mpp_tpu/batched/ilu_gmres.py:225-281``):

* :func:`gmres_arnoldi` — an inner step: classical Gram-Schmidt, the new
  basis vector, the Givens rotations of the Hessenberg column, the residual
  estimate and the columns it converges.
* :func:`gmres_update` — a cycle's end: the truncated back substitution, the
  correction of x and the done-column bookkeeping.

Both write the host's loop predicates into a device word (``flags``), so
the caller's sync reads it with no eager op between; each takes one of two
forms (``GMRES_FORMS``) that :func:`gmres_form` picks by shape.

The column assembly (``csrc/vsfm_assembly_kernels.cu``) serves the
tridiagonal plan of ``batched/vsfm_compiled.py`` where the problem's
structure is a column's (``models/richards_column.column_spec``); it
replaces no Pallas kernel but the JAX package's XLA-fused residual and
Jacobian values of ``RichardsGE`` (``mpp_tpu/models/richards.py:674-837``)
under ``jit``:

* :func:`vsfm_column_assemble` — F, the tridiagonal Jacobian bands, or
  both, of a batch of columns in one pass.

Dispatch rule: a CPU tensor runs the plain version (``ops/tridiag.py``,
``ops/block_thomas.py``, the ``*_plain`` functions here);
a CUDA tensor launches the kernel, building it at first use
(``ops/_build.py``), or raises.  A build or launch failure raises; nothing
falls back.  Each launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import ctypes

import torch

from mpp_tpu_torch.ops import _build
from mpp_tpu_torch.ops.ilu0_schedule import LIMITS, ILU0Schedule
from mpp_tpu_torch.ops.block_thomas import block_thomas
from mpp_tpu_torch.ops import tridiag
from mpp_tpu_torch.ops.tridiag import thomas as thomas_plain
from mpp_tpu_torch.ops.tridiag import tridiag_matvec
from mpp_tpu_torch.models import richards_column

#: kernel launches since the last reset, by kernel name
LAUNCHES = {"thomas": 0, "tridiag_spmv": 0, "tridiag_spmv_mixed": 0,
            "block_thomas2": 0, "block_thomas_small": 0,
            "block_thomas_large": 0,
            "tridiag_spmv_chain": 0,
            "tridiag_jacobi_smooth": 0, "spmv_variant": 0, "spmv_packed": 0,
            "stream_ceiling": 0, "ilu0_factor": 0, "ilu0_apply": 0,
            "gmres_arnoldi": 0, "gmres_update": 0,
            "vsfm_column_assemble": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_MAX_ON_CHIP = {}


def max_on_chip(kernel, dtype, memory="shared"):
    """The deepest column (levels) that ``kernel`` keeps on chip in
    ``dtype``: for "thomas" and "block_thomas2" with the carries in shared
    memory, for "tridiag_spmv_chain" and "tridiag_jacobi_smooth" with the
    bands, b and x in shared memory, or with ``memory="registers"`` in a
    warp's registers (those two only); for "block_thomas_large" the largest
    block size m whose working matrix stays in shared memory.  Deeper
    columns (larger blocks) need a global scratch.  The launcher's own
    rule, read from the library (built at first use) once per kernel,
    dtype and memory.  (The ILU(0) kernels' limits: :func:`ilu0_limits`.)"""
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


#: the largest block :func:`block_thomas_small` takes; the smallest
#: :func:`block_thomas_large` takes
BLOCK_SMALL_MAX = 8
BLOCK_LARGE_MIN = BLOCK_SMALL_MAX + 1
#: the forms of :func:`block_thomas_small` (csrc/block_thomas_small_kernels
#: .cu): "thread", a system a thread, its level blocks streamed through a
#: shared-memory ring, built to m = BTS_THREAD_BUILT in both dtypes (the
#: kernel's kThreadMax), so that the threshold below can be measured again;
#: "lanes", a system on m lanes of a warp, built to m = 8
BTS_FORMS = ("thread", "lanes")
BTS_THREAD_BUILT = 5
#: the rule: the largest m that takes the thread form, by dtype, one
#: threshold a dtype, from the forms' device times at the canopy's [4096,
#: 93, m] on one H100 (``tools/resident_variants.py --bts-forms``, PERF.md
#: section 6): the thread form wins at the canopy's m = 3 (f64) and m = 4
#: (f32); at f32 m = 2, which no path solves, lanes read faster.  Tests
#: and tools force a form by patching it.
BTS_THREAD_MAX = {torch.float32: 5, torch.float64: 3}


def bts_form(m, dtype):
    """The form of :func:`block_thomas_small` the rule picks for m x m
    blocks in ``dtype``: "thread" to ``BTS_THREAD_MAX[dtype]``, "lanes"
    past it."""
    return "thread" if m <= BTS_THREAD_MAX[dtype] else "lanes"


def _check_block_systems(name, L, D, U, b, m_lo, m_hi):
    """Raise ValueError unless b is ``[..., n, m]`` with m_lo <= m (<= m_hi
    unless None) and L, D, U ``[..., n, m, m]`` of b's leading dims, all
    contiguous tensors of one dtype (f32 or f64) on one CPU or CUDA
    device."""
    for a in (L, D, U, b):
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: expected tensors, got {type(a)}")
    if b.dim() < 2 or b.shape[-1] < m_lo or \
            (m_hi is not None and b.shape[-1] > m_hi):
        span = f"{m_lo} <= m" + ("" if m_hi is None else f" <= {m_hi}")
        raise ValueError(f"{name}: b must be [..., n, m] with {span}, got "
                         f"{tuple(b.shape)}")
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
    diagonally dominant systems.  On the card one launch in the form
    :func:`bts_form` picks, within rounding of
    :func:`ops.block_thomas.block_thomas` (not bit for bit)."""
    name = "block_thomas_small"
    _check_block_systems(name, L, D, U, b, 1, BLOCK_SMALL_MAX)
    if b.device.type == "cpu":
        return block_thomas(L, D, U, b)
    n, m = b.shape[-2], b.shape[-1]
    x = torch.empty_like(b)
    nsys = b.numel() // max(n * m, 1)
    if nsys == 0 or n == 0:
        return x
    lib = _build.library()
    code = BTS_FORMS.index(bts_form(m, b.dtype))
    size = lib.mpp_block_thomas_small_scratch(nsys, n, m, b.element_size(),
                                              code)
    scr = torch.empty(size, dtype=b.dtype, device=b.device) if size else None
    fn = lib.mpp_block_thomas_small_f64 if b.dtype == torch.float64 else \
        lib.mpp_block_thomas_small_f32
    with torch.cuda.device(b.device):
        rc = fn(L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
                None if scr is None else scr.data_ptr(), x.data_ptr(), nsys,
                n, m, code, _stream(b))
    _launched(name, rc)
    return x


#: the forms of :func:`block_thomas_large` (csrc/block_thomas_large_kernels
#: .cu): "block", a thread block a system (many systems, narrow blocks);
#: "cluster", a thread-block cluster a system, the level's working matrix
#: split by column tiles over its CTAs' shared memory (few wide systems)
BTL_FORMS = ("block", "cluster")
#: the cluster form's panel width, panel slots a CTA and warps a CTA (the
#: kernel's kPanel, kSlots, kClusterWarps), and CTAs a system:
#: BTL_CLUSTER_CTAS (the portable limit) where the blocks have that many
#: panels, fewer where they have fewer, more (to BTL_CLUSTER_MAX_CTAS, the
#: non-portable limit) where the working matrix needs them to stay on chip
#: (7 read 3 % faster than 8 at m = 200, 13 slower; the tests cover 8)
BTL_PANEL = 16
BTL_SLOTS = 3
BTL_CLUSTER_WARPS = 8
BTL_CLUSTER_CTAS = 8
BTL_CLUSTER_MAX_CTAS = 16
#: the most dynamic shared memory a CTA takes on Hopper (the kernels'
#: mpp::kOnChipBytes)
ON_CHIP_BYTES = 227 * 1024
#: the rule: the cluster form for blocks of at least BTL_CLUSTER_MIN_M at
#: most BTL_CLUSTER_MAX_SYSTEMS systems, or at most
#: BTL_CLUSTER_MAX_SYSTEMS_WIDE where the block form's working matrix is off
#: chip (m > btl_block_max_on_chip()); the block form otherwise.  From the
#: forms' device times on one H100 (``tools/resident_variants.py
#: --btl-forms``, PERF.md section 6): one system, the block form wins to m
#: = 40 ([1, 2, 40], [1, 20, 20] too), the cluster form from m = 48 (at m =
#: 16, which no path solves, the cluster form reads faster); at m = 64 the
#: block form wins from 33 systems (a cluster of 4 CTAs a system, 132
#: CTAs), at m = 200 the cluster form up to the 132 systems measured.
#: Tests and tools force a form by patching these.
BTL_CLUSTER_MIN_M = 48
BTL_CLUSTER_MAX_SYSTEMS = 8
BTL_CLUSTER_MAX_SYSTEMS_WIDE = 132


def _up8(v):
    return (v + 7) // 8 * 8


def btl_block_smem(m, on_chip):
    """The block form's dynamic shared bytes at m x m blocks (the kernel's
    block_smem): W (m x (2m + 1) f64) when on chip, three f64 vectors and
    two int vectors of m."""
    return ((m * (2 * m + 1) if on_chip else 0) + 3 * m) * 8 + 2 * m * 4


def btl_block_max_on_chip():
    """The largest m whose working matrix the block form keeps in shared
    memory (the kernel's max_on_chip; 119)."""
    m = 1
    while btl_block_smem(m + 1, True) <= ON_CHIP_BYTES:
        m += 1
    return m


def btl_cluster_layout(m, ctas):
    """The cluster form's layout at m x m blocks and ``ctas`` CTAs a system
    (the kernel's ClusterLayout): ``panels`` of BTL_PANEL columns, at most
    ``panels_a_cta`` a CTA, the W tile's row stride ``ld`` (the CTA's
    denominator columns, then its X columns, each padded to 8, plus one),
    ``big`` (the tile and BTL_SLOTS panel slots, f64 values), and the
    dynamic shared bytes with ``big`` on chip (``smem_on_chip``) or in the
    global scratch (``smem_off_chip``)."""
    m8 = _up8(m)
    panels = -(-m // BTL_PANEL)
    npc = -(-panels // ctas)
    a8 = npc * BTL_PANEL
    ld = a8 + _up8(npc * BTL_PANEL + 1) + 1
    rows = -(-m // ctas)
    slot = m8 * (BTL_PANEL + 1) + 2 * BTL_PANEL
    big = m8 * ld + BTL_SLOTS * slot
    dbl = BTL_PANEL * ld + 3 * m8 + 2 * rows + 4 * BTL_CLUSTER_WARPS + \
        BTL_PANEL
    ints = 2 * m8
    return dict(ctas=ctas, panels=panels, panels_a_cta=npc, ld=ld, big=big,
                smem_on_chip=(big + dbl) * 8 + ints * 4,
                smem_off_chip=dbl * 8 + ints * 4)


def btl_cluster_plan(m):
    """The cluster form's launch at m x m blocks: the fewest CTAs from
    min(BTL_CLUSTER_CTAS, panels) up to min(BTL_CLUSTER_MAX_CTAS, panels)
    whose shares of the working matrix fit shared memory (``on_chip``
    True, no scratch), else the most CTAs with the tiles in a global
    scratch of ``scratch`` f64 values a CTA; None where not even that
    fits.  Adds ``on_chip``, ``smem`` and ``scratch`` to the layout."""
    panels = -(-m // BTL_PANEL)
    lo = min(BTL_CLUSTER_CTAS, panels)
    hi = max(lo, min(BTL_CLUSTER_MAX_CTAS, panels))
    for ctas in range(lo, hi + 1):
        lay = btl_cluster_layout(m, ctas)
        if lay["smem_on_chip"] <= ON_CHIP_BYTES:
            return dict(lay, on_chip=True, smem=lay["smem_on_chip"],
                        scratch=0)
    lay = btl_cluster_layout(m, hi)
    if lay["smem_off_chip"] > ON_CHIP_BYTES:
        return None
    return dict(lay, on_chip=False, smem=lay["smem_off_chip"],
                scratch=lay["big"])


def btl_form(nsys, m, dtype):
    """The form of :func:`block_thomas_large` the rule picks for ``nsys``
    systems of m x m blocks in ``dtype`` (both forms work in f64, so the
    thresholds serve both dtypes): "cluster" for m >= BTL_CLUSTER_MIN_M at
    most BTL_CLUSTER_MAX_SYSTEMS systems, or BTL_CLUSTER_MAX_SYSTEMS_WIDE
    where the block form's working matrix is off chip (and where the
    cluster plan exists), "block" otherwise.  By shape alone; monotone:
    fewer systems or wider blocks never leave the cluster form."""
    most = BTL_CLUSTER_MAX_SYSTEMS_WIDE if m > btl_block_max_on_chip() \
        else BTL_CLUSTER_MAX_SYSTEMS
    if m >= BTL_CLUSTER_MIN_M and nsys <= max(most, BTL_CLUSTER_MAX_SYSTEMS) \
            and btl_cluster_plan(m) is not None:
        return "cluster"
    return "block"


def btl_launch(nsys, n, m, dtype):
    """The launch of :func:`block_thomas_large` at ``nsys`` systems of n
    levels of m x m blocks in ``dtype``: the rule's ``form`` and its code,
    ``ctas`` a system (0 for the block form), and the f64 scratch values:
    ``cp`` (the levels' [Cp_k | dp_k], k < n - 1) and ``ws`` (the working
    matrices where the form keeps them off chip).  ValueError for a form
    not in BTL_FORMS."""
    form = btl_form(nsys, m, dtype)
    if form not in BTL_FORMS:
        raise ValueError(f"block_thomas_large: form {form!r} not in "
                         f"{BTL_FORMS}")
    cp = nsys * n * m * (m + 1) if n > 1 else 0
    if form == "cluster":
        plan = btl_cluster_plan(m)
        ctas, ws = plan["ctas"], nsys * plan["ctas"] * plan["scratch"]
    else:
        ctas = 0
        ws = nsys * m * (2 * m + 1) if m > btl_block_max_on_chip() else 0
    return dict(form=form, code=BTL_FORMS.index(form), ctas=ctas, cp=cp,
                ws=ws)


def block_thomas_large(L, D, U, b):
    """Solve T x = b for batched block-tridiagonal T with m x m blocks,
    m >= 9: blocks ``[..., n, m, m]`` (``L[..., 0]`` and ``U[..., n-1]``
    unused), b and x ``[..., n, m]``, f32 or f64, any n; the leading dims
    are the batch.  Each level's block solve eliminates with partial
    pivoting (the largest |entry| among the rows not yet pivoted, ties to
    the lower row, a NaN the largest: LU's pivots), none across levels:
    block diagonally dominant systems.  On the card one launch in the form
    :func:`btl_form` picks by shape (:func:`btl_launch`): "block", a thread
    block a system, the level's working matrix in shared memory to
    :func:`btl_block_max_on_chip` and in a global scratch past it; or
    "cluster", a thread-block cluster a system (:func:`btl_cluster_plan`),
    the working matrix split over its CTAs' shared memory, its panel
    updates on the f64 tensor cores.  f64 arithmetic for either dtype;
    within rounding of :func:`ops.block_thomas.block_thomas`
    (``torch.linalg.solve`` a level, not bit for bit).  A refused launch
    raises; no form gives way to the other."""
    name = "block_thomas_large"
    _check_block_systems(name, L, D, U, b, BLOCK_LARGE_MIN, None)
    n, m = b.shape[-2], b.shape[-1]
    nsys = b.numel() // max(n * m, 1)
    plan = btl_launch(nsys, n, m, b.dtype)
    if b.device.type == "cpu":
        return block_thomas(L, D, U, b)
    x = torch.empty_like(b)
    if nsys == 0 or n == 0:
        return x
    lib = _build.library()
    f64 = dict(dtype=torch.float64, device=b.device)
    cp = torch.empty(plan["cp"], **f64) if plan["cp"] else None
    ws = torch.empty(plan["ws"], **f64) if plan["ws"] else None
    fn = lib.mpp_block_thomas_large_f64 if b.dtype == torch.float64 else \
        lib.mpp_block_thomas_large_f32
    with torch.cuda.device(b.device):
        rc = fn(L.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
                None if cp is None else cp.data_ptr(),
                None if ws is None else ws.data_ptr(), x.data_ptr(), nsys,
                n, m, plan["code"], plan["ctas"], _stream(b))
    _launched(name, rc)
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


# ---- GMRES(m): the Arnoldi step and the cycle update ----------------------

#: the forms of :func:`gmres_arnoldi` / :func:`gmres_update`
#: (csrc/gmres_kernels.cu): "warp", a warp a column, up to GMRES_WARP_COLS
#: columns a block, m <= GMRES_WARP_MAX_M (many short columns); "cluster",
#: a thread-block cluster a column, its rows split over the CTAs, each with
#: a warp for the serial tail (few long columns)
GMRES_FORMS = ("warp", "cluster")
#: the kernels' kWarpCols, kWarpMaxM, kCtaThreads and kMaxCluster
GMRES_WARP_COLS = 4
GMRES_WARP_MAX_M = 32
GMRES_CTA_THREADS = 512
GMRES_CLUSTER_MAX = 16
#: rows of a column a CTA of the cluster form takes (ceil(n / this) CTAs,
#: to GMRES_CLUSTER_MAX): of 256, 512, 1024 and 2048, 256 reads fastest at
#: one column of 500, 2048 and 6000 rows (a 30-step cycle and its update
#: 166 / 177 / 215 us; 512: 209 / 214 / 228; 1024: 209 / 254 / 268), all
#: alike at 95232 (``tools/resident_variants.py --gmres-forms`` on one
#: H100, PERF.md row 15)
GMRES_CTA_ELEMS = 256
#: the rule: the warp form for columns of at most GMRES_WARP_MAX_N rows, or
#: of at most GMRES_WARP_MAX_N_WIDE rows from GMRES_WARP_MIN_COLS columns;
#: the cluster form otherwise.  From the forms' device times on one H100
#: (``tools/resident_variants.py --gmres-forms``, PERF.md row 15; a cycle
#: weighed as 30 steps at j = 15 and an update): the warp form wins at 32
#: rows at every width (1-8192 columns), the cluster form at 100-128 rows
#: to 256 columns and from 512 rows; at 128 rows the warp form wins from
#: 1024 columns (291 against 407 us a cycle; (q)'s [8192, 128]: 2595
#: against 3035); at 512 rows and 8192 columns, a shape no path runs, the
#: two tie (11.46 against 11.59 ms).
#: Tests and tools force a form by patching these.
GMRES_WARP_MAX_N = 32
GMRES_WARP_MAX_N_WIDE = 128
GMRES_WARP_MIN_COLS = 1024


def gmres_smem(kernel, form, m, threads, elem, ctas=GMRES_CLUSTER_MAX):
    """Dynamic shared bytes of a launch without its slots (the kernels'
    base_bytes, the launcher's ``mpp_gmres_smem``): kernel "arnoldi" or
    "update", form "warp" (GMRES_WARP_COLS columns a block, the most a
    launch takes) or "cluster" (``threads`` element threads and ``ctas``
    CTAs), ``elem`` bytes a value.  A launch adds its slots (w and V's
    rows a thread reads) where they fit."""
    update = m * m + 3 * m
    if form == "warp":
        step = (m + 1) + (m + 2) + 2 * m
        return GMRES_WARP_COLS * (step if kernel == "arnoldi" else update) \
            * elem
    if kernel == "arnoldi":
        # the partial dots a CTA exchanges, in rows of 16-byte multiples
        stride = -(-(m + 1) * elem // 16) * 16 // elem
        values = stride * (ctas + 1) + threads + (m + 1) + \
            GMRES_CTA_THREADS // 32 + ctas + (m + 2) + 2 * m
        return 16 + values * elem
    return update * elem


def _gmres_fits(form, m, threads, elem, ctas=GMRES_CLUSTER_MAX):
    if form == "warp" and m > GMRES_WARP_MAX_M:
        return False
    return max(gmres_smem(k, form, m, threads, elem, ctas)
               for k in ("arnoldi", "update")) <= ON_CHIP_BYTES


def _elem(dtype):
    return 8 if dtype == torch.float64 else 4


def gmres_form(ncol, n, m, dtype):
    """The form of :func:`gmres_arnoldi` / :func:`gmres_update` the rule
    picks for ``ncol`` columns of ``n`` rows, Krylov dimension ``m``, in
    ``dtype``: "warp" for columns of at most GMRES_WARP_MAX_N rows, or of
    at most GMRES_WARP_MAX_N_WIDE from GMRES_WARP_MIN_COLS columns, where m
    <= GMRES_WARP_MAX_M and its shared memory holds m; else "cluster".  By
    shape alone; monotone: more columns or fewer rows never leave the warp
    form."""
    short = n <= GMRES_WARP_MAX_N or \
        (n <= GMRES_WARP_MAX_N_WIDE and ncol >= GMRES_WARP_MIN_COLS)
    if short and _gmres_fits("warp", m, 32, _elem(dtype)):
        return "warp"
    return "cluster"


def gmres_plan(ncol, n, m, dtype):
    """The launch of both GMRES kernels at ``ncol`` columns of ``n`` rows,
    Krylov dimension ``m``, in ``dtype``: the rule's ``form`` and its
    ``code``; for the warp form ``threads`` 32 (a warp a column), for the
    cluster form ``ctas`` a column (ceil(n / GMRES_CTA_ELEMS), 1 to
    GMRES_CLUSTER_MAX), ``chunk`` rows a CTA and ``threads`` element
    threads a CTA (the chunk rounded up to warps, at most
    GMRES_CTA_THREADS; the tail's warp is one more).  ValueError where m
    outgrows shared memory."""
    form = gmres_form(ncol, n, m, dtype)
    if form == "warp":
        ctas, chunk, threads = 0, 0, 32
    else:
        ctas = max(1, min(GMRES_CLUSTER_MAX, -(-n // GMRES_CTA_ELEMS), n))
        chunk = -(-n // ctas)
        threads = min(GMRES_CTA_THREADS, max(32, -(-chunk // 32) * 32))
    if not _gmres_fits(form, m, threads, _elem(dtype), ctas):
        raise ValueError(f"gmres: Krylov dimension {m} outgrows shared "
                         f"memory in {dtype}")
    return dict(form=form, code=GMRES_FORMS.index(form), ctas=ctas,
                chunk=chunk, threads=threads)


def gmres_workspace(b, m, ws=None):
    """A cycle's basis V ``[ncol, m + 1, n]``, Hessenberg H ``[ncol, m + 1,
    m]``, rotations cs, sn ``[ncol, m]`` and g ``[ncol, m + 1]`` in the
    dtype and device of ``b [ncol, n]``: zero-filled for every cycle on the
    CPU (the plain forms contract the whole basis, its unset rows zero),
    made once a solve on the card, unfilled (the kernels read only what the
    cycle wrote); ``ws`` the last cycle's."""
    if ws is not None and b.device.type != "cpu":
        return ws
    ncol, n = b.shape
    make = b.new_zeros if b.device.type == "cpu" else b.new_empty
    return (make((ncol, m + 1, n)), make((ncol, m + 1, m)), make((ncol, m)),
            make((ncol, m)), make((ncol, m + 1)))


def _colnorm(A):
    return torch.sqrt(torch.sum(A * A, dim=-1))


def _hypot(x1, x2):
    """jnp.hypot's formula: hi * sqrt(1 + (lo/hi)^2), inf if either leg
    is +inf."""
    x1, x2 = torch.abs(x1), torch.abs(x2)
    inf = torch.isposinf(x1) | torch.isposinf(x2)
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    z = hi == 0
    q = lo / torch.where(z, 1.0, hi)
    x = torch.where(z, hi, hi * torch.sqrt(1 + q * q))
    return torch.where(inf, torch.inf, x)


def _check_gmres(name, V, arrays):
    """Raise ValueError unless V is a contiguous ``[ncol, m + 1, n]`` f32 /
    f64 tensor (ncol, n, m >= 1) and each of ``arrays`` (label: (tensor,
    shape function of (ncol, n, m), kind: "float" V's dtype, "int64" or
    "bool")) has its shape and kind, all contiguous on V's CPU or CUDA
    device; returns (ncol, n, m)."""
    for label, a in (("V", V), *((k, t) for k, (t, _, _) in arrays.items())):
        if not isinstance(a, torch.Tensor):
            raise ValueError(f"{name}: {label} must be a tensor, got "
                             f"{type(a)}")
    if V.dim() != 3 or V.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: V must be a [ncol, m + 1, n] f32 or f64 "
                         f"tensor, got {tuple(V.shape)} {V.dtype}")
    ncol, m, n = V.shape[0], V.shape[1] - 1, V.shape[2]
    if ncol < 1 or n < 1 or m < 1:
        raise ValueError(f"{name}: V {tuple(V.shape)} needs ncol, n and m "
                         ">= 1")
    kinds = {"float": V.dtype, "int64": torch.int64, "bool": torch.bool}
    for label, (a, shape, kind) in arrays.items():
        want = tuple(shape(ncol, n, m))
        if tuple(a.shape) != want:
            raise ValueError(f"{name}: {label} must be {want}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != kinds[kind]:
            raise ValueError(f"{name}: {label} must be {kinds[kind]}, got "
                             f"{a.dtype}")
    for label, a in (("V", V), *((k, t) for k, (t, _, _) in arrays.items())):
        if a.device != V.device:
            raise ValueError(f"{name}: {label} on {a.device}, V on "
                             f"{V.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if V.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {V.device}")
    return ncol, n, m


#: each array a launcher binds (beside V): (shape of (ncol, n, m), kind)
_GMRES_ARRAYS = {"H": (lambda c, n, m: (c, m + 1, m), "float"),
                 "cs": (lambda c, n, m: (c, m), "float"),
                 "sn": (lambda c, n, m: (c, m), "float"),
                 "g": (lambda c, n, m: (c, m + 1), "float"),
                 "tol": (lambda c, n, m: (c,), "float"),
                 "mj": (lambda c, n, m: (c,), "int64"),
                 "found": (lambda c, n, m: (c,), "bool"),
                 "done": (lambda c, n, m: (c,), "bool"),
                 "flags": (lambda c, n, m: (3,), "bool"),
                 "x": (lambda c, n, m: (c, n), "float"),
                 "its": (lambda c, n, m: (c,), "int64")}


class _GmresArgs(ctypes.Structure):
    """The kernels' GmresArgs: a workspace's pointers and plan, bound once."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("V", *_GMRES_ARRAYS)] + \
        [(k, ctypes.c_int) for k in ("ncol", "n", "m", "form", "ctas",
                                     "chunk", "threads")]


class GmresLauncher:
    """Both GMRES kernels bound to one workspace (V, H, cs, sn, g) and the
    solve's tol, mj, found, done, flags, x and its (cs, sn and tol may be
    None where only updates are launched, x and its where only steps
    are): every device, dtype, shape and contiguity check runs here, once
    (ValueError on what the kernels do not take); on the card the plan
    (:func:`gmres_plan`), the ctypes functions and the fixed pointers are
    bound here too.  A step then checks only its fresh ``w`` and ``j``; an
    update checks nothing.  On CPU tensors the plain forms run.
    ``GmresLauncher.checks`` / ``.plans`` count the full checks and the
    card plans made."""
    checks = 0
    plans = 0

    def __init__(self, V, H, cs, sn, g, tol, mj, found, done, flags, x=None,
                 its=None):
        given = dict(H=H, cs=cs, sn=sn, g=g, tol=tol, mj=mj, found=found,
                     done=done, flags=flags, x=x, its=its)
        self.ncol, self.n, self.m = _check_gmres("gmres", V, {
            k: (a, *_GMRES_ARRAYS[k]) for k, a in given.items()
            if a is not None})
        GmresLauncher.checks += 1
        self.V, self.a = V, given
        if V.device.type == "cpu":
            return
        self.plan = gmres_plan(self.ncol, self.n, self.m, V.dtype)
        GmresLauncher.plans += 1
        lib = _build.library()
        f64 = V.dtype == torch.float64
        self._step = lib.mpp_gmres_arnoldi_f64 if f64 else \
            lib.mpp_gmres_arnoldi_f32
        self._update = lib.mpp_gmres_update_f64 if f64 else \
            lib.mpp_gmres_update_f32
        self._args = _GmresArgs(
            V.data_ptr(), *(None if a is None else a.data_ptr()
                            for a in given.values()),
            self.ncol, self.n, self.m, self.plan["code"], self.plan["ctas"],
            self.plan["chunk"], self.plan["threads"])
        self._ref = ctypes.addressof(self._args)
        self._index = V.device.index

    def _on_card(self, fn, *args):
        if torch.cuda.current_device() == self._index:
            return fn(*args, _stream(self.V))
        with torch.cuda.device(self.V.device):
            return fn(*args, _stream(self.V))

    def arnoldi(self, w, j, cap=False):
        """Inner step j of the cycle, given ``w`` = M A V_j (see
        :func:`gmres_arnoldi`)."""
        V = self.V
        if not isinstance(w, torch.Tensor) or \
                tuple(w.shape) != (self.ncol, self.n) or \
                w.dtype != V.dtype or w.device != V.device or \
                not w.is_contiguous():
            raise ValueError(
                f"gmres_arnoldi: w must be a contiguous ({self.ncol}, "
                f"{self.n}) {V.dtype} tensor on {V.device}, got "
                f"{tuple(w.shape) if isinstance(w, torch.Tensor) else w!r}")
        if isinstance(j, bool) or not isinstance(j, int) or \
                not 0 <= j < self.m:
            raise ValueError(f"gmres_arnoldi: j={j!r} must be an int in "
                             f"[0, {self.m})")
        a = self.a
        if a["tol"] is None or a["cs"] is None or a["sn"] is None:
            raise ValueError("gmres_arnoldi: the launcher has no cs, sn or "
                             "tol")
        if V.device.type == "cpu":
            gmres_arnoldi_plain(V, a["H"], a["cs"], a["sn"], a["g"], w,
                                a["tol"], a["mj"], a["found"], a["done"],
                                a["flags"], j, cap)
            return
        _launched("gmres_arnoldi", self._on_card(
            self._step, w.data_ptr(), self._ref, j, int(bool(cap))))

    def update(self):
        """The cycle's end (see :func:`gmres_update`)."""
        a = self.a
        if a["x"] is None or a["its"] is None:
            raise ValueError("gmres_update: the launcher has no x or its")
        if self.V.device.type == "cpu":
            gmres_update_plain(self.V, a["H"], a["g"], a["mj"], a["found"],
                               a["done"], a["x"], a["its"], a["flags"])
            return
        _launched("gmres_update", self._on_card(self._update, self._ref))


def gmres_arnoldi_plain(V, H, cs, sn, g, w, tol, mj, found, done, flags, j,
                        cap=False):
    """Plain version of :func:`gmres_arnoldi`: the port's eager step, with
    V's rows past j + 1 zero (the contraction runs over the whole basis)."""
    m = H.shape[-1]
    ar = torch.arange(m + 1, device=V.device)
    # classical Gram-Schmidt over the full V: its unset rows are zero, so
    # the contraction equals V[:j+1] w
    h = torch.bmm(V, w[:, :, None])[..., 0]
    w = w - torch.bmm(h[:, None, :], V)[:, 0]
    hlast = _colnorm(w)
    V[:, j + 1] = w / torch.where(hlast == 0, 1.0, hlast)[:, None]
    col = torch.where(ar == j + 1, hlast[:, None], h)
    for i in range(j):
        a, bb = col[:, i], col[:, i + 1]
        t = cs[:, i] * a + sn[:, i] * bb
        nxt = -sn[:, i] * a + cs[:, i] * bb
        col[:, i] = t
        col[:, i + 1] = nxt
    cj, cj1 = col[:, j].clone(), col[:, j + 1].clone()
    d = _hypot(cj, cj1)
    z = d == 0
    dd = torch.where(z, 1.0, d)
    c = torch.where(z, 1.0, cj / dd)
    s = torch.where(z, 0.0, cj1 / dd)
    col[:, j] = c * cj + s * cj1
    col[:, j + 1] = 0.0
    cs[:, j] = c
    sn[:, j] = s
    gj = g[:, j].clone()
    g[:, j + 1] = -s * gj
    g[:, j] = c * gj
    H[:, :, j] = col
    conv = torch.abs(g[:, j + 1]) <= tol
    mj.copy_(torch.where(~found & conv, j + 1, mj))
    found |= conv
    if cap:
        # a column still running has reached the caller's maxiter
        mj.copy_(torch.where(found, mj, j + 1))
    flags[j % 2] = torch.all(found | done)
    flags[(j + 1) % 2] = True
    flags[2] = False


def gmres_arnoldi(V, H, cs, sn, g, w, tol, mj, found, done, flags, j,
                  cap=False):
    """Inner step j (0 <= j < m) of a GMRES(m) cycle of every column, in
    place, given ``w [ncol, n]`` = M A V_j: classical Gram-Schmidt against
    V's rows 0..j, V's row j + 1, the Hessenberg column H[:, :, j] through
    the earlier Givens rotations and the new one (cs, sn ``[ncol, m]``),
    g ``[ncol, m + 1]``, and for the columns whose residual estimate
    |g_{j+1}| reaches ``tol`` ``[ncol]`` mj = j + 1 and found (int64 and
    bool ``[ncol]``); with ``cap`` (the caller's maxiter reached at this
    step) mj = j + 1 for every column not found.  ``flags`` (bool [3]):
    ``flags[j % 2]`` becomes "every column found or done" (the host's
    early-exit predicate), ``flags[(j + 1) % 2]`` True, ``flags[2]`` False
    (:func:`gmres_update` sets it).  V ``[ncol, m + 1, n]`` and H
    ``[ncol, m + 1, m]``; one dtype (f32 or f64), contiguous, one device.
    On the card one launch in the form :func:`gmres_plan` picks, reading
    only V's rows <= j; within rounding of :func:`gmres_arnoldi_plain`
    (whose V must be zero past row j).  Every argument is checked at each
    call; a solve binds a :class:`GmresLauncher` once instead."""
    GmresLauncher(V, H, cs, sn, g, tol, mj, found, done, flags).arnoldi(
        w, j, cap)


def gmres_update_plain(V, H, g, mj, found, done, x, its, flags):
    """Plain version of :func:`gmres_update`: the port's eager update."""
    ncol, m = H.shape[0], H.shape[-1]
    # mj-truncated back-substitution: y_k = 0 for k >= mj
    y = g.new_zeros((ncol, m))
    for jrow in range(m - 1, -1, -1):
        num = g[:, jrow] - torch.sum(H[:, jrow, :m] * y, dim=-1)
        hjj = H[:, jrow, jrow]
        yi = num / torch.where(hjj == 0, 1.0, hjj)
        y[:, jrow] = torch.where(jrow < mj, yi, 0.0)
    dx = torch.bmm(y[:, None, :], V[:, :m])[:, 0]
    x.copy_(torch.where(done[:, None], x, x + dx))
    its.copy_(torch.where(done, its, its + mj))
    done |= found
    flags[:2] = True
    flags[2] = torch.any(~done)


def gmres_update(V, H, g, mj, found, done, x, its, flags):
    """The end of a GMRES(m) cycle of every column, in place: y from the
    mj-truncated back substitution of H y = g (rows mj - 1 down to 0), x +=
    y V[:mj] and its += mj where not ``done``, then done |= found;
    ``flags[2]`` becomes "a column is left not done" (it must be False on
    entry, as every :func:`gmres_arnoldi` leaves it), ``flags[0]`` and
    ``flags[1]`` True.  V ``[ncol, m + 1, n]``, H ``[ncol, m + 1, m]``, g
    ``[ncol, m + 1]``, x ``[ncol, n]`` (one dtype, f32 or f64); mj, its
    int64 and found, done bool ``[ncol]``; contiguous, one device.  On the
    card one launch in the form :func:`gmres_plan` picks, reading only H's
    columns, g's entries and V's rows below mj; within rounding of
    :func:`gmres_update_plain`."""
    GmresLauncher(V, H, None, None, g, None, mj, found, done, flags, x,
                  its).update()


# ---- the column assembly (csrc/vsfm_assembly_kernels.cu) -------------------
class _ColumnArray(ctypes.Structure):
    """The kernel's ColumnArray: element (c, j) at p[c * cs + j * es]."""
    _fields_ = [("p", ctypes.c_void_p), ("cs", ctypes.c_longlong),
                ("es", ctypes.c_longlong)]


class _ColumnArgs(ctypes.Structure):
    """The kernel's ColumnAssembleArgs: a launch's arrays, outputs, table
    and sizes."""
    _fields_ = [("a", _ColumnArray * len(richards_column.ARGS)),
                ("F", ctypes.c_void_p), ("dl", ctypes.c_void_p),
                ("d", ctypes.c_void_p), ("du", ctypes.c_void_p),
                ("table", ctypes.c_void_p)] + \
        [(k, ctypes.c_int) for k in ("ncol", "n", "nbc", "nss", "density",
                                     "porosity")]


_COLUMN_MODES = {"residual": 1, "bands": 2, "both": 3}


def vsfm_column_assemble(*arrays, spec, mode):
    """F, the tridiagonal Jacobian bands (dl, d, du), or both, of a batch
    of columns of the column GE ``spec`` (``richards_column.ColumnSpec``):
    ``mode`` "residual", "bands" or "both".  ``arrays`` are the kernel's
    inputs in ``richards_column.ARGS`` order (``column_inputs`` lays them
    out; positional, so that a trace's record of the call holds each
    input's shape), checked by ``spec.check``.  Returns F, (dl, d, du) or
    (F, (dl, d, du)), each ``[ncol, nz]`` in P's dtype (f32 or f64).  On
    the card one launch reads each input once (any strides) and writes each
    output once; on the CPU the plain form
    (``richards_column.column_assemble_plain``) runs."""
    ncol = spec.check(arrays, mode)
    P = arrays[0]
    if P.device.type == "cpu":
        return richards_column.column_assemble_plain(spec, mode, *arrays)
    want_F, want_J = richards_column.MODES[mode]
    new = lambda: torch.empty(P.shape, dtype=P.dtype, device=P.device)
    F = new() if want_F else None
    bands = (new(), new(), new()) if want_J else (None,) * 3
    if ncol:
        args = _ColumnArgs(ncol=ncol, n=spec.n, nbc=spec.nbc, nss=spec.nss,
                           density=int(spec.tgdpb01),
                           porosity=int(spec.linear_porosity))
        for slot, a in zip(args.a, arrays):
            if a is not None:
                slot.p = a.data_ptr()
                slot.cs, slot.es = a.stride() if a.dim() == 2 \
                    else (0, a.stride(0))
        for k, t in zip(("F", "dl", "d", "du"), (F, *bands)):
            setattr(args, k, None if t is None else t.data_ptr())
        args.table = spec.table(P.device).data_ptr()
        lib = _build.library()
        fn = lib.mpp_vsfm_column_assemble_f64 if P.dtype == torch.float64 \
            else lib.mpp_vsfm_column_assemble_f32
        with torch.cuda.device(P.device):
            rc = fn(ctypes.addressof(args), _COLUMN_MODES[mode], _stream(P))
        _launched("vsfm_column_assemble", rc)
    return F if not want_J else bands if not want_F else (F, bands)
