"""Plain reference of MPP's V-catchment problem (vsfm_vchannel_problem.F90).

20 x 10 x nz cells of 10 x 10 x 0.5 m on a valley whose surface falls
0.1 towards the centre line in x and rises 0.2 along y; uniform van
Genuchten soil (m 0.5, alpha 3.4257e-4 1/Pa, residual saturation 0.2772,
porosity 0.368, permeability 8.3913e-12 m^2); no boundary condition, so
the water only redistributes; an initial water table (head 18.75 - 0.5 kk
- 2 m at layer kk from the bottom).  The cells, their connections and the
initial state are built here from those numbers; the step is
``vsfm.newton`` on the one system.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import vsfm

NX, NY = 20, 10
DX, DY, DZ = 10.0, 10.0, 0.5
SLOPE_X, SLOPE_Y = 0.1, 0.2
POROSITY, VG_M, ALPHA, PERM, SAT_RES = 0.368, 0.5, 3.4257e-4, 8.3913e-12, \
    0.2772


def cell_centres(nz):
    """Centroids [n] (x, y, z) of the cells, x fastest, then y, then the
    layer from the bottom: the mean of the four corner elevations of the
    column less the depth of the layer's centre."""
    xv = np.arange(NX + 1) * DX
    yv = np.arange(NY + 1) * DY
    zx = SLOPE_X * np.abs(xv - NX // 2 * DX)
    zv = zx[:, None] + SLOPE_Y * yv[None, :]             # [NX+1, NY+1]
    mean4 = lambda a: 0.25 * (a[:-1, :-1] + a[1:, :-1] + a[:-1, 1:]
                              + a[1:, 1:])
    X, Y = np.meshgrid(xv, yv, indexing="ij")
    xc, yc, zs = mean4(X).T, mean4(Y).T, mean4(zv).T   # [NY, NX]
    kk = np.arange(nz)[:, None, None]
    zc = zs[None] - (DZ / 2.0 + (nz - kk - 1) * DZ)
    full = lambda a: np.broadcast_to(a, (nz, NY, NX)).ravel()
    return full(xc), full(yc), zc.ravel()


def connections(nz):
    """The internal connections (up, dn, half distances, areas), in x, y
    and z between neighbouring cells."""
    ids = np.arange(NX * NY * nz).reshape(nz, NY, NX)
    pairs = [(ids[:-1].ravel(), ids[1:].ravel(), DX * DY),            # z
             (ids[:, :, :-1].ravel(), ids[:, :, 1:].ravel(), DZ * DY),  # x
             (ids[:, :-1, :].ravel(), ids[:, 1:, :].ravel(), DZ * DX)]  # y
    up = np.concatenate([p[0] for p in pairs])
    dn = np.concatenate([p[1] for p in pairs])
    area = np.concatenate([np.full(p[0].size, p[2]) for p in pairs])
    return up, dn, area


def system(nz, device, dtype=torch.float64):
    """The V-catchment as one ``vsfm.System``."""
    xc, yc, zc = cell_centres(nz)
    up, dn, area = connections(nz)
    d = np.stack([xc[dn] - xc[up], yc[dn] - yc[up], zc[dn] - zc[up]])
    dist = np.sqrt((d * d).sum(axis=0))
    unit = d / dist
    # vertical neighbours sit DZ apart; lateral ones at their centroids'
    # distance, each half on either side
    vertical = np.arange(up.size) < NX * NY * (nz - 1)
    half = np.where(vertical, 0.5 * DZ, 0.5 * dist)
    n = NX * NY * nz
    f = lambda v: torch.as_tensor(np.asarray(v, np.float64)[None],
                                  dtype=dtype, device=device)
    full = lambda v: f(np.full(n, v))
    return vsfm.System(
        up=torch.as_tensor(up, device=device),
        dn=torch.as_tensor(dn, device=device),
        dist_up=f(half), dist_dn=f(half), area=f(area),
        unit_z=torch.as_tensor(unit[2], dtype=dtype, device=device),
        perm=full(PERM), porosity=full(POROSITY),
        vol=full(DX * DY * DZ), satfunc="van_genuchten",
        sat={"sat_res": full(SAT_RES), "alpha": full(ALPHA),
             "m": full(VG_M)},
        perm_fac=torch.as_tensor(np.abs(unit).sum(axis=0), dtype=dtype,
                                 device=device))


def initial_pressure(nz, ic_offset=2.0):
    """The initial pressures [n] [Pa]: hydrostatic below a water table at
    18.75 - 0.5 kk - ic_offset m of head in layer kk (F90:1003-1032)."""
    kk = np.repeat(np.arange(nz), NX * NY)
    return (18.75 - 0.5 * kk - ic_offset) * 997.18 * 9.8 + 101325.0
