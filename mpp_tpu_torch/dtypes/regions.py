"""Region -> boundary/source connection-set builders (the port's own copy
of ``mpp_tpu/dtypes/regions.py``).

Equivalent of ``MeshCreateConnectionSet1`` (MeshType.F90:648-851): given a
mesh region id (SOIL_TOP_CELLS, SOIL_BOTTOM_CELLS, ALL_CELLS, ...) build
the condition connection set with the reference's unit vectors and
distances (dist_up=0, dist_dn=dz/2 for top/bottom faces).
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import Region, ConnKind, MeshType as MeshKind
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet


def region_connection_set(mesh: Mesh, region: int) -> ConnectionSet:
    region = int(region)
    nlev = mesh.nlev if mesh.nlev > 0 else mesh.ncells_local
    ncols = mesh.ncells_local // nlev
    against = mesh.orientation == int(MeshKind.AGAINST_GRAVITY)

    if region in (int(Region.SOIL_TOP_CELLS), int(Region.SNOW_TOP_CELLS),
                  int(Region.SSW_TOP_CELLS), int(Region.SOIL_BOTTOM_CELLS),
                  int(Region.SNOW_BOTTOM_CELLS)):
        top = region in (int(Region.SOIL_TOP_CELLS),
                         int(Region.SNOW_TOP_CELLS),
                         int(Region.SSW_TOP_CELLS))
        ids, uz = [], []
        for c in range(1, ncols + 1):
            if against == top:
                # against-gravity top / along-gravity bottom: last cell
                ids.append(nlev * c - 1)
            else:
                ids.append(nlev * (c - 1))
            uz.append(-1.0 if top else 1.0)
        ids = np.array(ids, np.int32)
        n = len(ids)
        uv = np.zeros((n, 3))
        uv[:, 2] = uz
        return ConnectionSet(
            id_up=np.full(n, -1, np.int32), id_dn=ids,
            dist_up=np.zeros(n), dist_dn=0.5 * mesh.dz[ids],
            area=mesh.area_xy[ids],
            itype=np.full(n, int(ConnKind.VERTICAL), np.int32),
            unit_vec=uv)

    if region in (int(Region.SOIL_CELLS), int(Region.ALL_CELLS)):
        n = mesh.ncells_local
        ids = np.arange(n, dtype=np.int32)
        return ConnectionSet(
            id_up=np.full(n, -1, np.int32), id_dn=ids,
            dist_up=np.zeros(n), dist_dn=np.zeros(n),
            area=mesh.area_xy[ids],
            itype=np.full(n, int(ConnKind.VERTICAL), np.int32),
            unit_vec=np.zeros((n, 3)))

    raise NotImplementedError(f"region {region}")
