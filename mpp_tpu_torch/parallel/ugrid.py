"""Unstructured distributed column grid: the ugrid/ugdm analog.

Counterpart of ``mpp_tpu/parallel/ugrid.py``.  The reference's
``dtypes/UnstructuredGridType.F90`` carries, per rank: local/ghost index
sets in local/petsc/natural orderings, an AO (application ordering)
mapping natural <-> petsc ids, and VecScatters for global<->local ghost
updates (:22-66, create_ugrid :76, create_ugdm :481, ScatterDataG2L
:609).  The ALM driver builds lateral inter-column connections from the
unstructured ldomain adjacency (``alm/MPPVSFMALM_Initialize.F90:588-795``)
and exchanges ghost columns each step.

* ``UGrid``: the GLOBAL column graph, ncol columns in natural order and
  an undirected edge list with its geometry.  ``partition(ndev)`` makes a
  contiguous block partition in a chosen petsc order, the AO maps between
  the orders and the static per-rank index maps of a ``UGDM``, in host
  numpy exactly as the JAX package does.
* ``UGDM``: the maps as tensors, padded to equal shapes on every rank:
  owned columns (petsc-contiguous), ghost columns (neighbours owned
  elsewhere), each rank's export buffer, and per-rank local edge lists
  (owned slots first, then ghost slots).  ``halo_exchange`` is one
  ``all_gather`` of the export buffers over the rank's ColumnGroup, then
  a static gather of the ghosts (the VecScatter forward mode on an
  arbitrary graph); with no group (one process, ndev = 1) the ghosts
  come from the rank's own exports.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpp_tpu_torch.constants import DENH2O, FMWH2O, GRAVITY_CONSTANT
from mpp_tpu_torch.parallel.sharding import all_gather_rows


class UGDM(NamedTuple):
    """Static per-rank distributed-grid maps (all [ndev, ...] tensors)."""
    ndev: int
    n_own: int                 # owned columns per rank (padded equal)
    n_export: int              # export-buffer width (max over ranks)
    n_ghost: int               # ghost width (max over ranks)
    n_edge: int                # local-edge width (max over ranks)
    own_global_nat: torch.Tensor  # [ndev, n_own] natural column id (-1 pad)
    own_mask: torch.Tensor        # [ndev, n_own] owned-slot validity
    export_idx: torch.Tensor      # [ndev, n_export] local slot to export
    ghost_src: torch.Tensor       # [ndev, n_ghost] index into the flattened
    #                               [ndev * n_export] all-gathered exports
    edge_a: torch.Tensor          # [ndev, n_edge] local slot (owned side a)
    edge_b: torch.Tensor          # [ndev, n_edge] local slot (owned or ghost)
    edge_w: torch.Tensor          # [ndev, n_edge] geometric weight
    edge_mask: torch.Tensor       # [ndev, n_edge]
    nat2petsc: torch.Tensor       # [ncol] AO: natural id -> petsc id
    petsc2nat: torch.Tensor       # [ncol] AO: petsc id -> natural id
    # per-connection geometry of the physical lateral Darcy flux
    # (ConnectionSetType.F90:15-48; MPPVSFMALM_Initialize.F90:588-795)
    edge_dist_a: torch.Tensor     # [ndev, n_edge] own-side half distance
    edge_dist_b: torch.Tensor     # [ndev, n_edge] other-side half distance
    edge_area: torch.Tensor       # [ndev, n_edge] face width (x dz a level)
    edge_dzc: torch.Tensor        # [ndev, n_edge] elevation z_a - z_b

    def to(self, device) -> "UGDM":
        """The maps on ``device``."""
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})

    # ------------------------------------------------------------------
    # staging: natural-order CLM arrays <-> the padded petsc layout
    # ------------------------------------------------------------------
    def natural_to_sharded(self, arr_nat):
        """[ncol_natural, ...] -> [ndev * n_own, ...] padded petsc layout
        (the reference's natural->petsc AO + local scatter); numpy in,
        numpy out, or a tensor in, a tensor on its device out."""
        og = self.own_global_nat.reshape(-1).cpu().numpy()
        mask = og >= 0
        shape = (self.ndev * self.n_own,) + tuple(arr_nat.shape[1:])
        if isinstance(arr_nat, torch.Tensor):
            out = arr_nat.new_zeros(shape)
            out[torch.as_tensor(mask, device=out.device)] = \
                arr_nat[torch.as_tensor(og[mask], device=out.device)]
            return out
        arr_nat = np.asarray(arr_nat)
        out = np.zeros(shape, arr_nat.dtype)
        out[mask] = arr_nat[og[mask]]
        return out

    def sharded_to_natural(self, arr_sh):
        """Inverse of :meth:`natural_to_sharded` (petsc->natural AO)."""
        og = self.own_global_nat.reshape(-1).cpu().numpy()
        mask = og >= 0
        ncol = int(self.petsc2nat.shape[0])
        shape = (ncol,) + tuple(arr_sh.shape[1:])
        if isinstance(arr_sh, torch.Tensor):
            out = arr_sh.new_zeros(shape)
            out[torch.as_tensor(og[mask], device=out.device)] = \
                arr_sh[torch.as_tensor(mask, device=arr_sh.device)]
            return out
        arr_sh = np.asarray(arr_sh)
        out = np.zeros(shape, arr_sh.dtype)
        out[og[mask]] = arr_sh[mask]
        return out

    # ------------------------------------------------------------------
    # the rank's view: x_own is this rank's [n_own, ...] block
    # ------------------------------------------------------------------
    def _rank(self, group):
        if group is None:
            if self.ndev != 1:
                raise ValueError(f"a UGDM of {self.ndev} ranks needs the "
                                 "ColumnGroup of its ranks")
            return 0
        if group.world_size != self.ndev:
            raise ValueError(f"UGDM of {self.ndev} ranks on a group of "
                             f"{group.world_size}")
        return group.rank

    def halo_exchange(self, x_own, group=None):
        """x extended with its ghost columns: [n_own + n_ghost, ...].

        One all_gather of the (small) export buffers over ``group`` moves
        every boundary column; the ghosts are then gathered with static
        indices (the VecScatter G2L forward mode,
        UnstructuredGridType.F90:609-670)."""
        p = self._rank(group)
        dev = x_own.device
        exports = x_own[self.export_idx[p].to(dev)]     # [n_export, ...]
        flat = exports if group is None else all_gather_rows(exports, group)
        ghosts = flat[self.ghost_src[p].to(dev)]        # [n_ghost, ...]
        return torch.cat([x_own, ghosts], dim=0)

    def lateral_source(self, x_own, conductance, group=None):
        """Operator-split lateral Darcy-type source per owned column:
        halo exchange, flux = -w K (x_a - x_b) per edge, added to the
        owned endpoint (GoveqnRichardsODEPressureType.F90:2615-2747
        semantics on an arbitrary adjacency)."""
        p = self._rank(group)
        dev = x_own.device
        x_ext = self.halo_exchange(x_own, group)
        a = self.edge_a[p].to(dev)
        b = self.edge_b[p].to(dev)
        w = (self.edge_w[p] * self.edge_mask[p]).to(dev, x_own.dtype)
        flux = -conductance * w * (x_ext[a] - x_ext[b])
        return torch.zeros_like(x_own).index_add(0, a, flux)

    def lateral_darcy_source(self, P_own, kr_own, perm_own, dz_own,
                             group=None, den=None, vis=8.904156e-4):
        """Per-connection, per-level lateral Darcy flux as an
        operator-split source [kmol/s] per owned cell.

        The physical lateral flux of the reference's ALM path
        (``GoveqnRichardsODEPressureType.F90:2615-2747`` with the
        two-point ``RichardsFlux``, RichardsMod.F90:118-340, constant
        density): distance-weighted harmonic permeability, upwinded
        relative permeability, gravity from the columns' elevation
        difference, face area = edge width x mean layer thickness.

        Args (all [n_own, nz], this rank's block): pressure, relative
        permeability, permeability, layer thickness.  The ghost values
        move with one halo exchange of the stacked fields."""
        if den is None:
            den = DENH2O / FMWH2O
        p = self._rank(group)
        dev, dt = P_own.device, P_own.dtype
        ext = self.halo_exchange(
            torch.stack([P_own, kr_own, perm_own, dz_own], dim=-1), group)
        a = self.edge_a[p].to(dev)
        b = self.edge_b[p].to(dev)
        col = lambda t: t[p].to(dev, dt)[:, None]
        Pa, Pb = ext[a, :, 0], ext[b, :, 0]
        kra, krb = ext[a, :, 1], ext[b, :, 1]
        pa, pb = ext[a, :, 2], ext[b, :, 2]
        dza, dzb = ext[a, :, 3], ext[b, :, 3]
        da, db = col(self.edge_dist_a), col(self.edge_dist_b)
        Dq = pa * pb / (da * pb + db * pa)
        # gravity: dist * unit_z * (-g) with the a->b unit vector, i.e.
        # (z_b - z_a) * (-g) = -edge_dzc * (-g)
        grav = den * FMWH2O * col(self.edge_dzc) * GRAVITY_CONSTANT
        dphi = Pa - Pb + grav
        ukvr = torch.where(dphi >= 0.0, kra, krb) / vis
        area = col(self.edge_area) * 0.5 * (dza + dzb)
        flux = -Dq * ukvr * dphi * area * den * col(self.edge_mask)
        return torch.zeros_like(P_own).index_add(0, a, flux)


@dataclasses.dataclass
class UGrid:
    """Global unstructured column graph in natural (application) order.

    ``edges`` is [nedge, 2] (undirected, natural ids); ``edge_weight``
    carries the geometric factor area/dist per edge (the reference keeps
    dist/area per connection, ConnectionSetType.F90:15-48)."""
    ncol: int
    edges: np.ndarray
    edge_weight: Optional[np.ndarray] = None
    #: full connection distance per edge (dist_up+dist_dn); default 1
    edge_dist: Optional[np.ndarray] = None
    #: lateral face width per edge (area per unit layer thickness)
    edge_area: Optional[np.ndarray] = None
    #: column surface elevation [ncol] (hillslope gravity term)
    col_elev: Optional[np.ndarray] = None

    def __post_init__(self):
        self.edges = np.asarray(self.edges, np.int64).reshape(-1, 2)
        ne = self.edges.shape[0]
        if self.edge_weight is None:
            self.edge_weight = np.ones(ne)
        self.edge_weight = np.asarray(self.edge_weight, np.float64)
        if self.edge_dist is None:
            self.edge_dist = np.ones(ne)
        self.edge_dist = np.asarray(self.edge_dist, np.float64)
        if self.edge_area is None:
            self.edge_area = np.asarray(self.edge_weight, np.float64).copy()
        self.edge_area = np.asarray(self.edge_area, np.float64)
        if self.col_elev is None:
            self.col_elev = np.zeros(self.ncol)
        self.col_elev = np.asarray(self.col_elev, np.float64)
        if self.edges.size and (self.edges.min() < 0
                                or self.edges.max() >= self.ncol):
            raise ValueError("edge endpoint out of range")

    @staticmethod
    def regular_2d(nx: int, ny: int, dx: float = 1.0, dy: float = 1.0):
        """4-neighbour grid-of-columns adjacency (the hillslope layout of
        vsfm_spac_on_hillslope / ALM ldomain)."""
        ids = np.arange(nx * ny).reshape(ny, nx)
        e, w = [], []
        e.append(np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], 1))
        w.append(np.full(e[-1].shape[0], dy / dx))
        e.append(np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], 1))
        w.append(np.full(e[-1].shape[0], dx / dy))
        return UGrid(nx * ny, np.concatenate(e), np.concatenate(w))

    def partition(self, ndev: int,
                  petsc_order: Optional[np.ndarray] = None) -> UGDM:
        """Contiguous block partition in petsc order -> static UGDM maps
        (create_ugrid/create_ugdm analog, UnstructuredGridType.F90:76,481).

        ``petsc_order[i]`` = natural id of the column at petsc position i
        (identity by default; pass a locality permutation, e.g. from a
        space-filling curve, to cut the halo width).  The maps are built
        in host numpy; the UGDM holds them as CPU tensors."""
        ncol = self.ncol
        if petsc_order is None:
            petsc_order = np.arange(ncol)
        petsc_order = np.asarray(petsc_order, np.int64)
        nat2petsc = np.empty(ncol, np.int64)
        nat2petsc[petsc_order] = np.arange(ncol)

        n_own = -(-ncol // ndev)                 # ceil, padded equal
        owner_of_petsc = np.minimum(np.arange(ncol) // n_own, ndev - 1)
        owner = np.empty(ncol, np.int64)         # by natural id
        owner[petsc_order] = owner_of_petsc
        local_slot = np.empty(ncol, np.int64)
        local_slot[petsc_order] = np.arange(ncol) - owner_of_petsc * n_own

        own_global = np.full((ndev, n_own), -1, np.int64)
        own_global[owner, local_slot] = np.arange(ncol)
        own_mask = own_global >= 0

        # per-rank ghost sets: neighbour columns owned elsewhere
        ea, eb = self.edges[:, 0], self.edges[:, 1]
        ghosts = []
        for d in range(ndev):
            need = set()
            for a, b in zip(ea, eb):
                if owner[a] == d and owner[b] != d:
                    need.add(int(b))
                if owner[b] == d and owner[a] != d:
                    need.add(int(a))
            ghosts.append(sorted(need))
        # export set per rank = union of its columns ghosted by others
        exp_sets = [set() for _ in range(ndev)]
        for d in range(ndev):
            for g in ghosts[d]:
                exp_sets[owner[g]].add(g)
        exports = [sorted(s) for s in exp_sets]

        n_export = max(1, max(len(s) for s in exports))
        n_ghost = max(1, max(len(g) for g in ghosts))
        export_idx = np.zeros((ndev, n_export), np.int64)
        # flattened all-gather position of every exported natural id
        exp_pos = {}
        for d in range(ndev):
            for j, g in enumerate(exports[d]):
                export_idx[d, j] = local_slot[g]
                exp_pos[g] = d * n_export + j
        ghost_src = np.zeros((ndev, n_ghost), np.int64)
        ghost_slot = [dict() for _ in range(ndev)]   # natural id -> ext slot
        for d in range(ndev):
            for j, g in enumerate(ghosts[d]):
                ghost_src[d, j] = exp_pos[g]
                ghost_slot[d][g] = n_own + j

        # per-rank local edge lists: one directed copy per owned endpoint
        dev_edges = [[] for _ in range(ndev)]
        for (a, b), wgt, dist, ar in zip(self.edges, self.edge_weight,
                                         self.edge_dist, self.edge_area):
            dzc_ab = self.col_elev[a] - self.col_elev[b]
            for s, t, dzc in ((a, b, dzc_ab), (b, a, -dzc_ab)):
                d = owner[s]
                t_loc = local_slot[t] if owner[t] == d else ghost_slot[d][t]
                dev_edges[d].append((local_slot[s], t_loc, wgt, dist, ar,
                                     dzc))
        n_edge = max(1, max(len(e) for e in dev_edges))
        edge_a = np.zeros((ndev, n_edge), np.int64)
        edge_b = np.zeros((ndev, n_edge), np.int64)
        edge_w = np.zeros((ndev, n_edge))
        edge_mask = np.zeros((ndev, n_edge))
        edge_dist_a = np.full((ndev, n_edge), 1.0)
        edge_dist_b = np.full((ndev, n_edge), 1.0)
        edge_area = np.zeros((ndev, n_edge))
        edge_dzc = np.zeros((ndev, n_edge))
        for d, es in enumerate(dev_edges):
            for j, (s, t, wgt, dist, ar, dzc) in enumerate(es):
                edge_a[d, j] = s
                edge_b[d, j] = t
                edge_w[d, j] = wgt
                edge_mask[d, j] = 1.0
                edge_dist_a[d, j] = dist / 2.0
                edge_dist_b[d, j] = dist / 2.0
                edge_area[d, j] = ar
                edge_dzc[d, j] = dzc

        t = torch.as_tensor
        return UGDM(
            ndev=ndev, n_own=int(n_own), n_export=int(n_export),
            n_ghost=int(n_ghost), n_edge=int(n_edge),
            own_global_nat=t(own_global), own_mask=t(own_mask),
            export_idx=t(export_idx), ghost_src=t(ghost_src),
            edge_a=t(edge_a), edge_b=t(edge_b), edge_w=t(edge_w),
            edge_mask=t(edge_mask), nat2petsc=t(nat2petsc),
            petsc2nat=t(petsc_order), edge_dist_a=t(edge_dist_a),
            edge_dist_b=t(edge_dist_b), edge_area=t(edge_area),
            edge_dzc=t(edge_dzc))


def lateral_darcy_source_global(ug: UGrid, P_nat, kr_nat, perm_nat, dz_nat,
                                den=None, vis=8.904156e-4):
    """Serial (no-collective) reference of :meth:`UGDM.lateral_darcy_source`
    over the GLOBAL natural-order arrays [ncol, nz] (tensors, on their
    device): the sharded path's cross-check."""
    if den is None:
        den = DENH2O / FMWH2O
    P, kr, perm, dz = P_nat, kr_nat, perm_nat, dz_nat
    src = torch.zeros_like(P)
    if ug.edges.size == 0:
        return src
    f = lambda a: torch.as_tensor(a, dtype=P.dtype, device=P.device)
    a = torch.as_tensor(ug.edges[:, 0], device=P.device)
    b = torch.as_tensor(ug.edges[:, 1], device=P.device)
    dist_h = f(ug.edge_dist)[:, None] / 2.0
    area_w = f(ug.edge_area)[:, None]
    dzc = f(ug.col_elev[ug.edges[:, 0]] - ug.col_elev[ug.edges[:, 1]])[:, None]
    Pa, Pb = P[a], P[b]
    Dq = perm[a] * perm[b] / (dist_h * perm[b] + dist_h * perm[a])
    grav = den * FMWH2O * dzc * GRAVITY_CONSTANT
    dphi = Pa - Pb + grav
    ukvr = torch.where(dphi >= 0.0, kr[a], kr[b]) / vis
    area = area_w * 0.5 * (dz[a] + dz[b])
    flux = -Dq * ukvr * dphi * area * den
    return src.index_add(0, a, flux).index_add(0, b, -flux)
