"""PetscViewer binary Vec serialization: the port's own copy of
``mpp_tpu/io/petsc_vec.py`` (numpy only).

The reference checkpoints model state and reads input tables /
boundary-condition datasets as PETSc binary Vecs
(``driver/standalone/ml_model/ml_model_problem.F90:357-360``,
``mlc.F90:1043-1092``, ``util/RSLPsiHat.F90:38-41``).  The on-disk
format is two big-endian int32 words — the Vec classid 1211214 and the
length — followed by ``length`` big-endian float64 values.  Writing the
same format keeps our checkpoints interchangeable with the reference's.
"""
from __future__ import annotations

import os

import numpy as np

VEC_FILE_CLASSID = 1211214


def _read_at(path: str, offset: int):
    """The Vec at byte ``offset``: (values, offset of the next Vec)."""
    header = np.fromfile(path, dtype=">i4", count=2, offset=offset)
    if header.size != 2 or int(header[0]) != VEC_FILE_CLASSID:
        raise ValueError(f"{path}@{offset}: not a PETSc binary Vec "
                         f"(classid {header[0] if header.size else '??'})")
    n = int(header[1])
    data = np.fromfile(path, dtype=">f8", offset=offset + 8, count=n)
    if data.size != n:
        raise ValueError(f"{path}: truncated Vec (expected {n} doubles, "
                         f"got {data.size})")
    return data.astype(np.float64), offset + 8 + 8 * n


def read_vec(path: str) -> np.ndarray:
    """Load a PETSc binary Vec (VecLoad semantics): the file's first."""
    return _read_at(path, 0)[0]


def read_vecs(path: str) -> list:
    """Every Vec of a file that holds several, viewed one after another
    (VecView to one viewer in turn), in file order."""
    size = os.path.getsize(path)
    out, offset = [], 0
    while offset < size:
        data, offset = _read_at(path, offset)
        out.append(data)
    return out


def write_vec(path: str, values: np.ndarray, append: bool = False) -> None:
    """Write a PETSc binary Vec (VecView to PetscViewerBinary semantics);
    ``append`` views it after the Vecs the file holds."""
    values = np.asarray(values, np.float64).ravel()
    with open(path, "ab" if append else "wb") as f:
        np.array([VEC_FILE_CLASSID, values.size], dtype=">i4").tofile(f)
        values.astype(">f8").tofile(f)
