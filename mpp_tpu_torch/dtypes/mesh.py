"""Control-volume mesh and connection sets as static SoA topology: the
port's own copy of ``mpp_tpu/dtypes/mesh.py`` (numpy only).

The reference's mesh/connection data model (``src/mpp/dtypes/MeshType.F90``,
``ConnectionSetType.F90``, ``src/mpp/util/mpp_mesh_utils.F90``):

* topology (cell ids, connection endpoints, distances, areas) is **static
  numpy** fixed when a problem is frozen — assembly becomes scatter-adds
  over these index arrays;
* per-cell geometric attributes are numpy (config) moved to tensors by the
  compute that uses them.

A two-point-flux connection is (id_up, id_dn, dist_up, dist_dn, area,
unit_vec) exactly as in ``connection_type`` (ConnectionSetType.F90:15-48).
Cell ids here are 0-based (the reference is 1-based Fortran).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mpp_tpu_torch.constants import ConnKind, MeshType as MeshKind


@dataclasses.dataclass
class ConnectionSet:
    """SoA of ``connection_set_type`` (ConnectionSetType.F90:50-64)."""
    id_up: np.ndarray        # int32 [nconn] — 0-based; -1 for boundary "no cell"
    id_dn: np.ndarray        # int32 [nconn] — 0-based
    dist_up: np.ndarray      # f64 [nconn]
    dist_dn: np.ndarray      # f64 [nconn]
    area: np.ndarray         # f64 [nconn]
    itype: np.ndarray        # int32 [nconn] — ConnKind
    unit_vec: Optional[np.ndarray] = None  # f64 [nconn,3]

    def __post_init__(self):
        self.id_up = np.asarray(self.id_up, np.int32)
        self.id_dn = np.asarray(self.id_dn, np.int32)
        self.dist_up = np.asarray(self.dist_up, np.float64)
        self.dist_dn = np.asarray(self.dist_dn, np.float64)
        self.area = np.asarray(self.area, np.float64)
        self.itype = np.asarray(self.itype, np.int32)
        if self.unit_vec is not None:
            self.unit_vec = np.asarray(self.unit_vec, np.float64)

    @property
    def num_connections(self) -> int:
        return int(self.id_dn.shape[0])


@dataclasses.dataclass
class Mesh:
    """SoA of ``mesh_type`` (MeshType.F90:24-70)."""
    name: str
    itype: int = 0
    orientation: int = int(MeshKind.AGAINST_GRAVITY)
    ncells_local: int = 0
    ncells_ghost: int = 0
    nlev: int = 0
    xc: np.ndarray = None
    yc: np.ndarray = None
    zc: np.ndarray = None
    dx: np.ndarray = None
    dy: np.ndarray = None
    dz: np.ndarray = None
    area_xy: np.ndarray = None
    vol: np.ndarray = None
    is_active: np.ndarray = None          # bool [ncells_all]
    intrn_conn_sets: List[ConnectionSet] = dataclasses.field(default_factory=list)
    lateral_conn_sets: List[ConnectionSet] = dataclasses.field(default_factory=list)

    @property
    def ncells_all(self) -> int:
        return self.ncells_local + self.ncells_ghost

    def set_grid_cell_filter(self, is_active) -> None:
        """MeshType.F90 SetGridCellFilter equivalent."""
        self.is_active = np.asarray(is_active, bool)

    def compute_volume(self) -> None:
        """vol = area_xy * dz (MeshType.F90 ComputeVolume)."""
        self.vol = self.area_xy * self.dz


def compute_cell_ids(nx: int, ny: int, nz: int) -> np.ndarray:
    """0-based natural cell ids, x-fastest (mpp_mesh_utils.F90:967-990)."""
    return np.arange(nx * ny * nz, dtype=np.int32).reshape(nz, ny, nx)  # [kk,jj,ii]


def _internal_conns_along_dir(nx, ny, nz, dx, dy, dz, idir):
    """One direction of internal connections (mpp_mesh_utils.F90:363-470).

    Loop order matches the reference: ii outer, jj, kk inner.  All internal
    connections carry itype CONN_HORIZONTAL (mpp_mesh_utils.F90:462 — the
    reference overrides the per-direction type).  Plain numpy (the JAX
    package's copy can also take the prebuilt native library; this one
    does not).
    """
    ids = compute_cell_ids(nx, ny, nz)
    id_up, id_dn, dup, ddn, area = [], [], [], [], []
    if idir == ConnKind.IN_X_DIR:
        rng = [(ii, jj, kk) for ii in range(nx - 1) for jj in range(ny)
               for kk in range(nz)]
        off, dist, ar = (1, 0, 0), dx, dy * dz
    elif idir == ConnKind.IN_Y_DIR:
        rng = [(ii, jj, kk) for ii in range(nx) for jj in range(ny - 1)
               for kk in range(nz)]
        off, dist, ar = (0, 1, 0), dy, dx * dz
    elif idir == ConnKind.IN_Z_DIR:
        rng = [(ii, jj, kk) for ii in range(nx) for jj in range(ny)
               for kk in range(nz - 1)]
        off, dist, ar = (0, 0, 1), dz, dx * dy
    else:
        raise ValueError(f"Unsupported idir {idir}")
    for ii, jj, kk in rng:
        id_up.append(ids[kk, jj, ii])
        id_dn.append(ids[kk + off[2], jj + off[1], ii + off[0]])
        dup.append(0.5 * dist)
        ddn.append(0.5 * dist)
        area.append(ar)
    n = len(id_up)
    return ConnectionSet(
        id_up=np.array(id_up, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.array(dup), dist_dn=np.array(ddn), area=np.array(area),
        itype=np.full(n, int(ConnKind.HORIZONTAL), np.int32))


def internal_connections(nx, ny, nz, dx, dy, dz, idir) -> ConnectionSet:
    """Structured-grid internal connection set
    (mpp_mesh_utils.F90:251-360): x-dir then y-dir then z-dir for
    CONN_IN_XYZ_DIR."""
    if idir == ConnKind.IN_XYZ_DIR:
        parts = []
        if nx > 1:
            parts.append(_internal_conns_along_dir(nx, ny, nz, dx, dy, dz,
                                                   ConnKind.IN_X_DIR))
        if ny > 1:
            parts.append(_internal_conns_along_dir(nx, ny, nz, dx, dy, dz,
                                                   ConnKind.IN_Y_DIR))
        if nz > 1:
            parts.append(_internal_conns_along_dir(nx, ny, nz, dx, dy, dz,
                                                   ConnKind.IN_Z_DIR))
        if not parts:
            return ConnectionSet(np.zeros(0), np.zeros(0), np.zeros(0),
                                 np.zeros(0), np.zeros(0), np.zeros(0))
        return concat_connection_sets(parts)
    return _internal_conns_along_dir(nx, ny, nz, dx, dy, dz, idir)


def concat_connection_sets(sets: List[ConnectionSet]) -> ConnectionSet:
    if not sets:
        z = np.zeros(0)
        return ConnectionSet(z.astype(np.int32), z.astype(np.int32),
                             z, z, z, z.astype(np.int32),
                             unit_vec=np.zeros((0, 3)))
    uv = None
    if all(s.unit_vec is not None for s in sets):
        uv = np.concatenate([s.unit_vec for s in sets])
    return ConnectionSet(
        id_up=np.concatenate([s.id_up for s in sets]),
        id_dn=np.concatenate([s.id_dn for s in sets]),
        dist_up=np.concatenate([s.dist_up for s in sets]),
        dist_dn=np.concatenate([s.dist_dn for s in sets]),
        area=np.concatenate([s.area for s in sets]),
        itype=np.concatenate([s.itype for s in sets]),
        unit_vec=uv)


def structured_mesh(name, x_max, y_max, z_max, nx, ny, nz, conn_dir,
                    x_min=0.0, y_min=0.0, z_min=0.0) -> Mesh:
    """Uniform structured mesh (MeshType.F90:173-290 MeshCreate).

    Centroids x-fastest; vol = dx*dy*dz; internal connections per
    ``conn_dir``.
    """
    dx = (x_max - x_min) / nx
    dy = (y_max - y_min) / ny
    dz = (z_max - z_min) / nz
    n = nx * ny * nz
    kk, jj, ii = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    xc = (x_min + dx / 2 + ii * dx).ravel()
    yc = (y_min + dy / 2 + jj * dy).ravel()
    zc = (z_min + dz / 2 + kk * dz).ravel()
    mesh = Mesh(name=name, itype=int(MeshKind.CLM_SOIL_COL),
                ncells_local=n, ncells_ghost=0, nlev=nz,
                xc=xc, yc=yc, zc=zc,
                dx=np.full(n, dx), dy=np.full(n, dy), dz=np.full(n, dz),
                area_xy=np.full(n, dx * dy),
                is_active=np.ones(n, bool))
    mesh.compute_volume()
    mesh.intrn_conn_sets = [internal_connections(nx, ny, nz, dx, dy, dz, conn_dir)]
    return mesh


def column_mesh(name, zc, dz, area, ncols=1, itype=0,
                orientation=int(MeshKind.ALONG_GRAVITY)) -> Mesh:
    """1-D soil-column mesh like ``MeshCreateFromCLMCols``
    (MeshType.F90:295-402): nlev cells per column, vertical connections.

    ``zc``/``dz``/``area`` are [nlev] per-level arrays (uniform across
    columns) or [ncols*nlev] flattened (level-fastest).
    """
    zc = np.asarray(zc, np.float64)
    dz = np.asarray(dz, np.float64)
    area = np.asarray(area, np.float64)
    nlev = zc.shape[-1] if zc.ndim == 1 and ncols == 1 else zc.shape[-1]
    if zc.ndim == 1 and ncols > 1:
        zc = np.tile(zc, ncols)
        dz = np.tile(dz, ncols)
        area = np.tile(area, ncols)
    n = ncols * nlev
    mesh = Mesh(name=name, itype=itype, orientation=orientation,
                ncells_local=n, nlev=nlev,
                xc=np.zeros(n), yc=np.zeros(n), zc=zc.ravel(),
                dx=np.zeros(n), dy=np.zeros(n), dz=dz.ravel(),
                area_xy=area.ravel(), is_active=np.ones(n, bool))
    mesh.compute_volume()
    # vertical connections within each column
    id_up, id_dn, dup, ddn, ar = [], [], [], [], []
    for c in range(ncols):
        base = c * nlev
        for k in range(nlev - 1):
            id_up.append(base + k)
            id_dn.append(base + k + 1)
            dup.append(0.5 * dz.ravel()[base + k])
            ddn.append(0.5 * dz.ravel()[base + k + 1])
            ar.append(area.ravel()[base + k])
    ncn = len(id_up)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.array(id_up, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.array(dup), dist_dn=np.array(ddn), area=np.array(ar),
        itype=np.full(ncn, int(ConnKind.VERTICAL), np.int32))]
    return mesh
