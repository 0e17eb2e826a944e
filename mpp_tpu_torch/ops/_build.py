"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

``library()`` compiles every ``mpp_tpu_torch/csrc/*.cu`` with ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together), links
the objects into one shared library with a plain C interface, placed in
``mpp_tpu_torch/_build/`` under a name that carries a hash of the sources
and their headers (``csrc/*.cuh``; a changed file rebuilds), and loads it
with ``ctypes``.  It runs at the
first kernel launch on a CUDA tensor, never at import.  A missing ``nvcc``
or a failed compile raises with the compiler's output; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: C signature of each launcher: device pointers and the stream as
#: ``c_void_p``, sizes and switches as ``c_int``, coefficients as
#: ``c_double``; every launcher returns cudaError_t (the ``*_max_on_chip``
#: and ``*_max_in_registers`` queries the deepest column a kernel keeps on
#: chip, or in registers, for 4- or 8-byte values; ``mpp_ilu0_limit`` the
#: ILU(0) forms' limits; ``mpp_block_thomas_small_scratch`` a launch's
#: scratch values, ``mpp_block_thomas_large_cluster_*`` the cluster
#: form's shared bytes and scratch values and ``mpp_gmres_smem`` a GMRES
#: launch's shared bytes, each a ``c_longlong``: RESTYPES; the GMRES
#: launchers take the address of a workspace's bound ``GmresArgs``,
#: ``hopper_kernels._GmresArgs``, the column assembly the address of a
#: launch's ``ColumnAssembleArgs``, ``hopper_kernels._ColumnArgs``)
SIGNATURES = {
    "mpp_thomas_max_on_chip": (_I,),
    "mpp_thomas_f32": (_P,) * 6 + (_I, _I, _P),
    "mpp_thomas_f64": (_P,) * 6 + (_I, _I, _P),
    "mpp_spmv_f32": (_P,) * 5 + (_I, _I, _P),
    "mpp_spmv_f64": (_P,) * 5 + (_I, _I, _P),
    "mpp_spmv_bf16_f32": (_P,) * 5 + (_I, _I, _P),
    "mpp_block_thomas2_max_on_chip": (_I,),
    "mpp_block_thomas2_f32": (_P,) * 6 + (_I, _I, _P),
    "mpp_block_thomas2_f64": (_P,) * 6 + (_I, _I, _P),
    "mpp_block_thomas_small_scratch": (_I, _I, _I, _I, _I),
    "mpp_block_thomas_small_f32": (_P,) * 6 + (_I,) * 4 + (_P,),
    "mpp_block_thomas_small_f64": (_P,) * 6 + (_I,) * 4 + (_P,),
    "mpp_block_thomas_large_max_on_chip": (_I,),
    "mpp_block_thomas_large_cluster_smem": (_I, _I, _I),
    "mpp_block_thomas_large_cluster_scratch": (_I, _I),
    "mpp_block_thomas_large_f32": (_P,) * 7 + (_I,) * 5 + (_P,),
    "mpp_block_thomas_large_f64": (_P,) * 7 + (_I,) * 5 + (_P,),
    "mpp_tridiag_spmv_chain_max_in_registers": (_I,),
    "mpp_tridiag_spmv_chain_max_on_chip": (_I,),
    "mpp_tridiag_jacobi_smooth_max_in_registers": (_I,),
    "mpp_tridiag_jacobi_smooth_max_on_chip": (_I,),
    "mpp_spmv_chain_f32": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "mpp_spmv_chain_f64": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "mpp_jacobi_smooth_f32": (_P,) * 7 + (_I, _I, _I, _D, _P),
    "mpp_jacobi_smooth_f64": (_P,) * 7 + (_I, _I, _I, _D, _P),
    "mpp_spmv_variant_f32": (_P,) * 5 + (_I,) * 5 + (_P,),
    "mpp_spmv_packed_f32": (_P,) * 3 + (_I, _I, _P),
    "mpp_stream_ceiling_f32": (_P,) * 5 + (_I, _I, _P),
    "mpp_ilu0_limit": (_I, _I),
    "mpp_ilu0_factor_f32": (_P,) * 4 + (_I,) * 11 + (_P,),
    "mpp_ilu0_factor_f64": (_P,) * 4 + (_I,) * 11 + (_P,),
    "mpp_ilu0_apply_f32": (_P,) * 5 + (_I,) * 11 + (_P,),
    "mpp_ilu0_apply_f64": (_P,) * 5 + (_I,) * 11 + (_P,),
    "mpp_gmres_smem": (_I,) * 6,
    "mpp_gmres_arnoldi_f32": (_P, _P, _I, _I, _P),
    "mpp_gmres_arnoldi_f64": (_P, _P, _I, _I, _P),
    "mpp_gmres_update_f32": (_P, _P),
    "mpp_gmres_update_f64": (_P, _P),
    "mpp_vsfm_column_max_levels": (),
    "mpp_vsfm_column_smem": (_I, _I, _I, _I),
    "mpp_vsfm_column_max_smem": (),
    "mpp_vsfm_column_assemble_f32": (_P, _I, _P),
    "mpp_vsfm_column_assemble_f64": (_P, _I, _P),
}

#: launchers and queries whose result is not a ``c_int``
RESTYPES = {"mpp_block_thomas_small_scratch": ctypes.c_longlong,
            "mpp_block_thomas_large_cluster_smem": ctypes.c_longlong,
            "mpp_block_thomas_large_cluster_scratch": ctypes.c_longlong,
            "mpp_gmres_smem": ctypes.c_longlong,
            "mpp_vsfm_column_smem": ctypes.c_longlong}

_LIB = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: ptxas's report (registers, spills) of the last build, "" if none ran
build_log = ""


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "cannot be built")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmpp_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the hashed library exists; return its
    path."""
    global build_seconds, build_log
    out = library_path()
    if os.path.isfile(out):
        build_seconds = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                         for src, obj in zip(sources(), objs))]
    results = [(cmd, p, *p.communicate()) for cmd, p in procs]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tag}.tmp", *objs]
    for cmd, p, so, se in results:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{so}\n{se}")
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
    build_log = "".join(so + se for _, _, so, se in results)
    for obj in objs:
        os.remove(obj)
    os.replace(f"{tag}.tmp", out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _LIB = lib
    return _LIB
