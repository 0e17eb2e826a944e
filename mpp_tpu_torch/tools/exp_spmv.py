"""SpMV variants against the stream ceiling on one NVIDIA GPU.

The port of the JAX package's SpMV measurement harness
(``tools/exp_spmv.py``, not part of the framework): the same sizes (NCOL =
131072 columns, NZ = 256 levels, f32), the same band distributions, the
same ITERS = 100 chained applications x <- (T x) * 0.5 ending in a sum, and
the same variant names and result keys.  Each name maps to a launch of a
hand-written kernel (``ops/hopper_kernels.py``):

====================== ================================ =====================
name                   JAX tool                         here
====================== ================================ =====================
pallas_b{128..4096}    ``pallas_kernel(b)``             ``spmv_variant``
                                                        concat, block b, tile
pallas_roll_b1024      ``pallas_kernel(1024, roll)``    ``spmv_variant`` roll
pallas_bf16diag_b1024  ``bf16_variant(1024)``           bf16 casts (torch),
                                                        ``tridiag_spmv_mixed``
pallas_b256_arb        ``pallas_kernel_cp(256,          ``spmv_variant``,
                       "arbitrary")``                   persistent grid
pallas_b512_par        ``pallas_kernel_cp(512,          ``spmv_variant``,
                       "parallel")``                    one block per tile
pallas_packed_b{512,   ``packed_kernel(b)``             ``spmv_packed`` (one
1024}                                                   thread per level: the
                                                        two names are one
                                                        launch)
jnp_concat, jnp_pad    XLA-fused jnp stencils           their torch forms
ceiling_elementwise    XLA-fused 4-read 1-write body    ``stream_ceiling``
====================== ================================ =====================

Like the JAX tool's loop, each chained call prepares the operands once (the
packed concatenation; here also the bf16 casts) and then applies the
variant ITERS times.  Before it is timed, each variant's first application
is held against its plain form on the same inputs (max |got - plain| <=
1e-6 max |plain|); a mismatch or a failed launch raises (the JAX tool
recorded a "FAIL" string and went on).  Times are CUDA events around whole
chained calls; every result carries the card's name and power limit.

Run on a machine with an NVIDIA GPU::

    python -m mpp_tpu_torch.tools.exp_spmv          # EXP_FAST=1: short list

Without CUDA it raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops.tridiag import tridiag_matvec

ITERS = 100
NCOL, NZ = 131072, 256
ROOF = 3350.0  # GB/s: the H100 SXM's HBM3 (NVIDIA data sheet)
RTOL = 1e-6    # first application against the plain form, of max |plain|


def inputs(ncol=NCOL, nz=NZ, seed=0, device="cuda"):
    """(dl, d, du, x), f32 ``[ncol, nz]``, with the JAX tool's
    distributions: d U(1, 2), dl and du U(0.1, 0.2), x U(0, 1), drawn from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)

    def u(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=device)
    d = u(1.0, 2.0)
    dl = u(0.1, 0.2)
    du = u(0.1, 0.2)
    x = u(0.0, 1.0)
    return dl, d, du, x


def jnp_concat(dl, d, du, x):
    """The JAX tool's ``jnp_concat`` stencil in torch (zero-padded
    neighbour products concatenated)."""
    return tridiag_matvec(dl, d, du, x)


def jnp_pad(dl, d, du, x):
    """The JAX tool's ``jnp_pad`` stencil in torch (zero-padded shifted
    copies of x)."""
    xl = F.pad(x, (1, 0))[:, :-1]
    xr = F.pad(x, (0, 1))[:, 1:]
    return d * x + dl * xl + du * xr


@dataclasses.dataclass
class Variant:
    """One row of the harness: ``prep(dl, d, du, x)`` gives the operands
    (all but x) once per chained call, ``apply(*ops, x)`` is one
    application, ``plain(*ops, x)`` its plain form, ``kernel`` the
    ``hk.LAUNCHES`` key it counts under, ``scale`` the factor after each
    application (None: the body is applied as it is)."""
    prep: Callable
    apply: Callable
    plain: Callable
    kernel: Optional[str] = None
    scale: Optional[float] = 0.5


def _bands(dl, d, du, x):
    return dl, d, du


def pallas_kernel(block_cols, roll=False):
    return Variant(_bands, lambda dl, d, du, x: hk.spmv_variant(
        dl, d, du, x, "roll" if roll else "concat", block_cols, "tile"),
        tridiag_matvec, "spmv_variant")


def bf16_variant(block_cols):
    """Bands stored bf16, x and y f32: kernel 2's mixed kernel (it walks
    the levels one thread each, so ``block_cols`` has no counterpart)."""
    return Variant(lambda dl, d, du, x: tuple(a.to(torch.bfloat16)
                                              for a in (dl, d, du)),
                   hk.tridiag_spmv_mixed, hk.tridiag_spmv_mixed_plain,
                   "tridiag_spmv_mixed")


def pallas_kernel_cp(block_cols, semantics="arbitrary"):
    """The grid-semantics twin: "parallel" is one block per tile,
    "arbitrary" (a sequential grid) a persistent grid of one block per SM
    walking the tiles in order."""
    grid = {"arbitrary": "persistent", "parallel": "tile"}[semantics]
    return Variant(_bands, lambda dl, d, du, x: hk.spmv_variant(
        dl, d, du, x, "concat", block_cols, grid),
        tridiag_matvec, "spmv_variant")


def packed_kernel(block_cols):
    """Bands packed into one ``[ncol, 3*nz]`` array, concatenated once per
    chained call as in the JAX tool."""
    return Variant(lambda dl, d, du, x: (torch.cat([dl, d, du], dim=1),),
                   hk.spmv_packed, hk.spmv_packed_plain, "spmv_packed")


def torch_form(fn):
    return Variant(_bands, fn, jnp_concat)


#: the 4-read, 1-write elementwise yardstick: a + x*(b - x*c), capped at 2,
#: times 0.9, with (a, b, c) = (dl, d, du)
CEILING = Variant(_bands, hk.stream_ceiling, hk.stream_ceiling_plain,
                  "stream_ceiling", scale=None)


def chained(v, iters=None):
    """f(dl, d, du, x): the variant's operands, then ``iters`` (default
    ITERS) applications and the sum of the result (the JAX tool's
    ``chained``)."""
    def f(dl, d, du, x):
        ops = v.prep(dl, d, du, x)
        for _ in range(ITERS if iters is None else iters):
            x = v.apply(*ops, x)
            if v.scale is not None:
                x = x * v.scale
        return x.sum()
    return f


def variants(fast=False):
    """The JAX tool's variant list, in its order (``EXP_FAST``: its short
    list)."""
    out = {
        "pallas_b512": pallas_kernel(512),
        "pallas_b1024": pallas_kernel(1024),
        "pallas_b2048": pallas_kernel(2048),
        "pallas_b4096": pallas_kernel(4096),
        "pallas_roll_b1024": pallas_kernel(1024, roll=True),
        "jnp_concat": torch_form(jnp_concat),
        "jnp_pad": torch_form(jnp_pad),
        "pallas_bf16diag_b1024": bf16_variant(1024),
        "pallas_b128": pallas_kernel(128),
        "pallas_b256": pallas_kernel(256),
        "pallas_b256_arb": pallas_kernel_cp(256, "arbitrary"),
        "pallas_b512_par": pallas_kernel_cp(512, "parallel"),
        "pallas_packed_b512": packed_kernel(512),
        "pallas_packed_b1024": packed_kernel(1024),
    }
    if fast:
        keep = ("pallas_b1024", "pallas_b256", "pallas_packed_b1024",
                "pallas_b2048")
        out = {k: v for k, v in out.items() if k in keep}
    return out


def card():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def _events_ms(fn, reps):
    """Milliseconds of ``reps`` calls of ``fn()`` between CUDA events,
    after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def measure(name, v, data, iters, bytes_f32):
    """Check the first application of ``v`` against its plain form, then
    time chained calls (``ms`` per application, with the harness's scaling
    pass) and one application alone (``kernel_ms``) and in its plain form
    (``plain_ms``)."""
    dl, d, du, x = data
    ops = v.prep(dl, d, du, x)
    got = v.apply(*ops, x)
    ref = v.plain(*ops, x)
    err = float((got - ref).abs().max())
    ymax = float(ref.abs().max())
    if not (err <= RTOL * ymax and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"{name}: first application off its plain form: "
                           f"max |got - plain| {err:.3e} > {RTOL:g} * "
                           f"{ymax:.3e}")
    before = hk.LAUNCHES.get(v.kernel, 0)
    reps = 3
    f = chained(v, iters)
    dt = _events_ms(lambda: f(dl, d, du, x), reps) / 1e3 / (reps * iters)
    launches = hk.LAUNCHES.get(v.kernel, 0) - before if v.kernel else None
    kernel_ms = _events_ms(lambda: v.apply(*ops, x), 20) / 20
    plain_ms = _events_ms(lambda: v.plain(*ops, x), 5) / 5
    gbs = bytes_f32 / dt / 1e9
    ncell = x.numel()
    if v.kernel == "tridiag_spmv_mixed":
        row = {"equiv_f32_GB_s": gbs,
               "actual_GB_s": (3 * 2 + 2 * 4) * ncell / dt / 1e9,
               "ms": dt * 1e3}
    else:
        row = {"GB_s": gbs, "frac_roof": gbs / ROOF, "ms": dt * 1e3}
    row.update(kernel_ms=kernel_ms, plain_ms=plain_ms, max_abs_err=err,
               max_abs_y=ymax, kernel=v.kernel, launches=launches)
    return row


def run(data=None, iters=ITERS, fast=None, log=None):
    """Every variant checked and timed on the card; returns the results
    dict (the JAX tool's keys, plus the card, the check and the launch
    count of each variant's chained calls).  ``data``: (dl, d, du, x) on
    the card, else :func:`inputs`."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_spmv measures the CUDA kernels: "
                           "torch.cuda.is_available() is false")
    data = inputs() if data is None else data
    ncol, nz = data[3].shape
    bytes_f32 = 5 * ncol * nz * 4
    if fast is None:
        fast = bool(os.environ.get("EXP_FAST"))
    results = {"device": torch.cuda.get_device_name(0), "card": card(),
               "ncol": ncol, "nz": nz, "iters": iters, "roof_GB_s": ROOF}
    rows = {"ceiling_elementwise": CEILING, **variants(fast)}
    for name, v in rows.items():
        results[name] = measure(name, v, data, iters, bytes_f32)
        if log is not None:
            log(f"{name} -> {results[name]}")
    return results


def main():
    results = run(log=lambda s: print(s, flush=True))
    print(json.dumps(results, indent=1, default=str))


if __name__ == "__main__":
    main()
