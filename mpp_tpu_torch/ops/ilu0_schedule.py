"""The ILU(0) schedule of one CSR sparsity: its parts, the plain forms'
flattened steps and levels, the kernels' programs and the launch rule.

Built once a sparsity on the host (numpy), by ``batched/ilu_gmres.
BatchedILU0``; read by ``hopper_kernels.ilu0_factor`` / ``ilu0_apply`` and
their plain forms.

**Parts.**  The rows split into the connected components of the sparsity
(the symmetric pattern).  Components never read each other's slots, so
they are binned into *parts* that the kernels run independently (the grid
is systems x parts): next fit, deepest component first, a component
joining the open part while the part's cost (the warp rounds of its steps
and levels, ``ceil(width / 32)`` each) stays at most the deepest
component's and its slots at most ``PART_NNZ``.  A part's steps and
levels are the whole schedule's restricted to its rows, empty ones
dropped, in the same order: inside a component the order of operations is
unchanged, so the factor stays bit for bit and the apply's row sums keep
their order.  A one-component sparsity is one part.

**The plain forms' schedule** (``factor`` / ``apply``, ``sections``,
``ptrs``): the parts' steps and levels walked in lockstep (step s of the
merged schedule is step s of every part that has one), flattened into two
int32 arrays as ``hopper_kernels.ilu0_factor_plain`` / ``ilu0_apply_plain``
read them.  With one part it is the whole sparsity's wavefront schedule.

**The kernels' programs** (``program``), one int32 array a kernel and
form, laid out as ``csrc/ilu0_kernels.cu`` reads it: a header, a table of
parts, then each part's sections in local numbering (its slots and rows
numbered from 0, pads one past the last):

* staged: the part's whole step (level) stream, copied into shared memory
  once a block and shared by the block's systems, whose values (and, for
  the apply, y) are staged there too;
* streamed: the stream cut into chunks of at most a ring stage, each with
  its lists: for the factor the slots it touches first (gathered into
  shared-memory *cells* before it runs) and last (written back after),
  the cells numbered by a greedy colouring of the slots' live chunks; for
  the apply the f values it reads (gathered into the stage beside it).

**The rule** (:meth:`ILU0Schedule.plan`): a kernel runs its staged form
when the largest part's program and one system's values fit the staged
form's shared memory, else its streamed form; the staged form's lanes a
system G the smallest power of two from MIN_LANES to 32 that gives the
slowest part the fewest rounds (``ceil(width / G)`` a step or level),
32 / G systems a warp in lockstep (``__syncwarp`` between steps), its
systems a block the count that keeps the most systems resident on an
SM.  The limits come from the kernel
library (``mpp_ilu0_limit``), so the rule and the kernels cannot drift.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

#: lanes a warp round covers (the unit of a part's cost)
WARP = 32
#: the most slots a part takes by merging components (a component alone
#: may hold more)
PART_NNZ = 2048
#: the staged form's widest block (threads)
MAX_THREADS = 256
#: the fewest lanes a system takes: at most 4 systems share a warp's
#: instruction stream, so the ~31 systems that fit an SM's shared memory at
#: (q)'s TH column run as 8 warps that hide each other's latency (its f64
#: apply 0.195 ms at G = 8 against 0.289 at G = 2, the factor no slower)
MIN_LANES = 8
#: the H100's shared memory an SM (bytes) and what a block reserves of it,
#: its resident warps and blocks: the occupancy the rule maximises
SM_SMEM, BLOCK_RESERVED, SM_WARPS, SM_BLOCKS = 233472, 1024, 64, 32
#: header and table entries of a program (``csrc/ilu0_kernels.cu``)
HEAD, FIELDS = 8, 8
#: ``mpp_ilu0_limit`` queries, in its order
LIMITS = ("staged_bytes", "stage_words", "stage_values", "stages",
          "factor_cells", "apply_rows")


def components(indptr, indices):
    """Connected component of each row of the (symmetrised) pattern,
    numbered 0.. in order of each component's first row: minimum-label
    hooking and pointer jumping, vectorised."""
    n = len(indptr) - 1
    r = np.repeat(np.arange(n), np.diff(indptr))
    c = np.asarray(indices, np.int64)
    lab = np.arange(n)
    while True:
        a, b = lab[r], lab[c]
        if np.array_equal(a, b):
            return np.unique(lab, return_inverse=True)[1].reshape(-1)
        np.minimum.at(lab, np.maximum(a, b), np.minimum(a, b))
        while True:
            nxt = lab[lab]
            if np.array_equal(nxt, lab):
                break
            lab = nxt


def _rounds(w):
    return -(-np.asarray(w, np.int64) // WARP)


def _group(keys, nkeys):
    """(order, bounds): ``order`` sorts ``keys`` stably, the entries of key
    k are ``order[bounds[k]:bounds[k + 1]]``."""
    order = np.argsort(keys, kind="stable")
    return order, np.searchsorted(keys[order], np.arange(nkeys + 1))


def _pad4(n):
    return -(-n // 4) * 4


def _odd(n):
    return n | 1


class _Pack:
    """An int32 program: header, part table, then 4-word aligned
    sections."""

    def __init__(self, nparts):
        self.words = [np.zeros(HEAD + FIELDS * nparts, np.int64)]
        self.size = HEAD + FIELDS * nparts
        self.head = self.words[0]
        self.head[0], self.head[4] = nparts, HEAD

    def add(self, a):
        """Append section ``a`` (4-word aligned); returns its offset."""
        a = np.asarray(a, np.int64).ravel()
        off = _pad4(self.size)
        if off > self.size:
            self.words.append(np.zeros(off - self.size, np.int64))
        self.words.append(a)
        self.size = off + a.size
        return off

    def part(self, p, *fields):
        self.head[HEAD + FIELDS * p:HEAD + FIELDS * p + len(fields)] = fields

    def done(self):
        out = np.concatenate(self.words + [np.zeros(_pad4(self.size)
                                                    - self.size, np.int64)])
        if out.size >= 2 ** 31 or (out.size and out.max() >= 2 ** 31):
            raise ValueError(f"ILU(0) program of {out.size} words exceeds "
                             "int32")
        return out.astype(np.int32)


def _pack_flat(counts, sections):
    """The plain forms' int32 array: the ``counts``, the offsets of the
    named ``sections`` (in order), then the sections.  Returns (array,
    {name: (start, stop)})."""
    head = len(counts) + len(sections)
    spans, o = {}, head
    for name, a in sections:
        spans[name] = (o, o + len(a))
        o += len(a)
    if o >= 2 ** 31:
        raise ValueError(f"ILU(0) schedule of {o} entries exceeds int32")
    out = np.zeros(o, np.int64)
    out[:len(counts)] = counts
    out[len(counts):head] = [lo for lo, _ in spans.values()]
    for name, a in sections:
        lo, hi = spans[name]
        out[lo:hi] = a
    return out.astype(np.int32), spans


def _cat(arrs):
    """The int64 arrays (or lists) ``arrs`` flattened and joined."""
    arrs = [a.ravel() if isinstance(a, np.ndarray) else
            np.asarray(a, np.int64).ravel() for a in arrs]
    return np.concatenate(arrs).astype(np.int64, copy=False) if arrs else \
        np.zeros(0, np.int64)


def _ptr(sizes):
    return np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])


def _runs(items, size, cap_words, cap_values):
    """``items`` cut into consecutive runs whose summed ``size(item)`` =
    (words, values) stay within the caps (a run holds one item at least):
    the rows of one step or level are independent, so each run of them is
    a step or level of its own; runs of records are a ring's chunks."""
    runs, cur, wu, vu = [], [], 0, 0
    for it in items:
        w, v = size(it)
        if cur and (wu + w > cap_words or vu + v > cap_values):
            runs.append(cur)
            cur, wu, vu = [], 0, 0
        cur.append(it)
        wu, vu = wu + w, vu + v
    return runs + ([cur] if cur else [])


def _item_at(off, counts, lead, width):
    """Where the items of each record go: record r's ``counts[r]`` items of
    ``width`` words each start ``lead`` words past ``off[r]``."""
    rec = np.repeat(np.arange(len(counts)), counts)
    rank = np.arange(rec.size) - np.repeat(_ptr(counts)[:-1], counts)
    return off[rec] + lead + width * rank


def _fits(words, stage_words, values, stage_values):
    """Raise ValueError unless a chunk of ``words`` program words and
    ``values`` gathered values fits a ring stage (a single row wider than a
    stage cannot be streamed)."""
    if _pad4(words) > stage_words or values > stage_values:
        raise ValueError(f"ILU(0): a row's chunk of {words} words and "
                         f"{values} values exceeds a ring stage of "
                         f"{stage_words} words and {stage_values} values")


def _trim(pos, col, nnz):
    """A level's padded table cut to its widest real row (at least 1)."""
    w = max(int((pos < nnz).sum(axis=1).max(initial=0)), 1)
    return pos[:, :w], col[:, :w]


class ILU0Schedule:
    """The ILU(0) schedule of one CSR sparsity (see the module docstring).

    ``steps``: the IKJ steps in wavefront order, each ``(lp, ld, pij, pik,
    pkj)``: slots ``lp`` take the multipliers ``f[lp] / f[ld]``, then
    ``f[pij] -= f[pik] * f[pkj]`` (``pik`` the multiplier's slot).
    ``fwd`` / ``bwd``: the levels of the forward / back sweep, each ``(rows,
    pos, col)`` with ``pos`` / ``col`` ``[rows, W]`` padded with slot
    ``nnz`` / column ``n``; ``dpos``: per back-sweep level, its rows'
    diagonal slots.

    ``parts``: per part a dict of its ``rows`` and ``slots`` (global, sorted)
    and its ``steps`` / ``fwd`` / ``bwd`` / ``dpos`` in the format above
    (global numbering).  ``factor`` / ``apply``: the plain forms' arrays
    (the parts in lockstep), read through ``sections`` and ``ptrs``."""

    def __init__(self, indptr, indices, steps, fwd, bwd, dpos):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.n = n = len(self.indptr) - 1
        self.nnz = nnz = int(self.indices.size)
        self.row_of_slot = np.repeat(np.arange(n), np.diff(self.indptr))
        comp = components(self.indptr, self.indices) if n else \
            np.zeros(0, np.int64)
        self.ncomponents = int(comp.max(initial=-1)) + 1
        self.part_of_row = self._bin(comp, steps, fwd, bwd)
        self.parts = self._restrict(steps, fwd, bwd, dpos)
        self._flatten()
        self._programs, self._plans, self._dev = {}, {}, {}

    # ---- parts ------------------------------------------------------------

    def _entries(self, steps, fwd, bwd):
        """Every step's and level's items as (kind, index, row): lp entries
        and pairs of step s (kinds 0, 1), rows of forward / back level L
        (kinds 2, 3)."""
        ros = self.row_of_slot
        out = []
        for kind, k in ((0, 0), (1, 2)):
            idx = [np.full(len(st[k]), s) for s, st in enumerate(steps)]
            sl = _cat([st[k] for st in steps])
            out.append((kind, _cat(idx), ros[sl] if sl.size else sl))
        for kind, levels in ((2, fwd), (3, bwd)):
            idx = [np.full(len(lv[0]), L) for L, lv in enumerate(levels)]
            out.append((kind, _cat(idx), _cat([lv[0] for lv in levels])))
        return out

    def _bin(self, comp, steps, fwd, bwd):
        """Part of each row: components binned next fit, deepest first."""
        C = self.ncomponents
        if C <= 1:
            return np.zeros(self.n, np.int64)
        # the width of every (kind, index) a component touches
        nidx = max(len(steps), len(fwd), len(bwd), 1)
        keys = []
        for kind, idx, rows in self._entries(steps, fwd, bwd):
            keys.append((kind * nidx + idx) * C + comp[rows])
        u, w = np.unique(_cat(keys), return_counts=True)
        kc, kk = u % C, u // C
        order, bounds = _group(kc, C)
        # every row is in a back-sweep level, so no component is empty
        cost = np.add.reduceat(_rounds(w[order]), bounds[:-1])
        nnz_c = np.bincount(comp[self.row_of_slot], minlength=C)
        limit = int(cost.max())
        part_of_comp = np.empty(C, np.int64)
        width, pcost, pnnz, p = {}, 0, 0, -1
        for c in np.argsort(-cost, kind="stable"):
            sel = order[bounds[c]:bounds[c + 1]]
            ck, cw = kk[sel].tolist(), w[sel].tolist()
            if p >= 0 and pnnz + nnz_c[c] <= PART_NNZ:
                extra = sum(-(-(width.get(k, 0) + x) // WARP)
                            - -(-width.get(k, 0) // WARP)
                            for k, x in zip(ck, cw))
                if pcost + extra <= limit:
                    for k, x in zip(ck, cw):
                        width[k] = width.get(k, 0) + x
                    pcost, pnnz = pcost + extra, pnnz + nnz_c[c]
                    part_of_comp[c] = p
                    continue
            p += 1
            width = dict(zip(ck, cw))
            pcost, pnnz = int(cost[c]), int(nnz_c[c])
            part_of_comp[c] = p
        return part_of_comp[comp]

    def _restrict(self, steps, fwd, bwd, dpos):
        """Each part's steps and levels: the whole schedule's restricted to
        its rows, empty ones dropped, widths trimmed."""
        P = int(self.part_of_row.max(initial=-1)) + 1
        ros, pr = self.row_of_slot, self.part_of_row
        if P == 1:
            return [dict(rows=np.arange(self.n), slots=np.arange(self.nnz),
                         steps=[tuple(np.asarray(a, np.int64) for a in st)
                                for st in steps],
                         fwd=[(r, *_trim(pp, c, self.nnz))
                              for r, pp, c in fwd],
                         bwd=[(r, *_trim(pp, c, self.nnz))
                              for r, pp, c in bwd],
                         dpos=[np.asarray(d, np.int64) for d in dpos])]
        parts = [dict(rows=np.nonzero(pr == p)[0], steps=[], fwd=[], bwd=[],
                      dpos=[]) for p in range(P)]
        for p, part in enumerate(parts):
            part["slots"] = np.nonzero(pr[ros] == p)[0]
        for st in steps:
            lp, ld, pij, pik, pkj = (np.asarray(a, np.int64) for a in st)
            ol, bl = _group(pr[ros[lp]], P)
            op, bp = _group(pr[ros[pij]], P)
            for p in np.nonzero(bl[1:] > bl[:-1])[0]:
                a, q = ol[bl[p]:bl[p + 1]], op[bp[p]:bp[p + 1]]
                parts[p]["steps"].append((lp[a], ld[a], pij[q], pik[q],
                                          pkj[q]))
        for key, levels, dps in (("fwd", fwd, None), ("bwd", bwd, dpos)):
            for L, (rows, pos, col) in enumerate(levels):
                o, b = _group(pr[rows], P)
                for p in np.nonzero(b[1:] > b[:-1])[0]:
                    a = o[b[p]:b[p + 1]]
                    tp, tc = _trim(pos[a], col[a], self.nnz)
                    parts[p][key].append((rows[a], tp, tc))
                    if dps is not None:
                        parts[p]["dpos"].append(np.asarray(dps[L])[a])
        return parts

    # ---- the plain forms' lockstep schedule ---------------------------------

    def _flatten(self):
        parts, n, nnz = self.parts, self.n, self.nnz
        S = max([len(p["steps"]) for p in parts] + [0])
        steps = parts[0]["steps"] if len(parts) == 1 else \
            [tuple(_cat([p["steps"][s][i] for p in parts
                         if s < len(p["steps"])]) for i in range(5))
             for s in range(S)]

        def lockstep(key):
            out, dp = [], []
            for L in range(max([len(p[key]) for p in parts] + [0])):
                lv = [(p[key][L], p["dpos"][L] if key == "bwd" else None)
                      for p in parts if L < len(p[key])]
                if len(lv) == 1:
                    out.append(lv[0][0])
                    dp.append(lv[0][1])
                    continue
                W = max(t[0][1].shape[1] for t in lv)
                tot = sum(len(t[0][0]) for t in lv)
                pos = np.full((tot, W), nnz, np.int64)
                col = np.full((tot, W), n, np.int64)
                o = 0
                for (rows, pp, cc), _ in lv:
                    pos[o:o + len(rows), :pp.shape[1]] = pp
                    col[o:o + len(rows), :cc.shape[1]] = cc
                    o += len(rows)
                out.append((_cat([t[0][0] for t in lv]), pos, col))
                if key == "bwd":
                    dp.append(_cat([t[1] for t in lv]))
            return out, dp

        fwd, _ = lockstep("fwd")
        bwd, dpos = lockstep("bwd")
        nl = [len(st[0]) for st in steps]
        npair = [len(st[2]) for st in steps]
        self.factor, fspans = _pack_flat(
            [len(steps)],
            [("lp_ptr", _ptr(nl)), ("pair_ptr", _ptr(npair))]
            + [(k, _cat([st[i] for st in steps]))
               for i, k in enumerate(("lp", "ld", "pij", "pik", "pkj"))])

        def sweep(tag, levels):
            return [(tag + "row_ptr", _ptr([len(lv[0]) for lv in levels])),
                    (tag + "tab_ptr", _ptr([lv[1].size for lv in levels])),
                    (tag + "width", [lv[1].shape[1] for lv in levels]),
                    (tag + "rows", _cat([lv[0] for lv in levels])),
                    (tag + "pos", _cat([lv[1] for lv in levels])),
                    (tag + "col", _cat([lv[2] for lv in levels]))]
        self.apply, aspans = _pack_flat([len(fwd), len(bwd)],
                                        sweep("f_", fwd) + sweep("b_", bwd)
                                        + [("dpos", _cat(dpos))])
        self._spans = {"factor": fspans, "apply": aspans}
        # the pointer sections on the host, for the plain forms' loops
        self.ptrs = {k: [int(v) for v in arr[lo:hi]]
                     for arr, spans in ((self.factor, fspans),
                                        (self.apply, aspans))
                     for k, (lo, hi) in spans.items()
                     if k.endswith(("_ptr", "width"))}

    def on(self, device):
        """(factor, apply) plain schedules as tensors on ``device``: int64
        index tensors for the plain forms' gathers."""
        device = torch.device(device)
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.as_tensor(a, dtype=torch.int64, device=device)
                for a in (self.factor, self.apply))
        return self._dev[key]

    def sections(self, device, which, *names):
        """Sections ``names`` of the ``which`` ("factor" or "apply") plain
        schedule on ``device`` as int64 index tensors."""
        t = self.on(device)[which == "apply"]
        return [t[slice(*self._spans[which][k])] for k in names]

    # ---- the kernels' programs --------------------------------------------

    def widths(self, kind):
        """Per part, the items of each phase: a step's lp entries and its
        pairs ("factor"), a level's rows ("apply")."""
        if kind == "factor":
            return [[n for st in p["steps"] for n in (len(st[0]), len(st[2]))
                     if n] for p in self.parts]
        return [[len(lv[0]) for lv in p["fwd"] + p["bwd"]]
                for p in self.parts]

    def lanes(self, kind):
        """The staged form's lanes a system G: the power of two (MIN_LANES
        to WARP) whose slowest part takes the fewest rounds, ``ceil(width
        / G)`` a phase; ties go to the smaller G (more systems a warp)."""
        widths = [np.asarray(w, np.int64) for w in self.widths(kind)]
        best = None
        for G in (1 << i for i in range(MIN_LANES.bit_length() - 1,
                                        WARP.bit_length())):
            est = max([int((-(-w // G)).sum()) for w in widths] + [0])
            if best is None or est < best[0]:
                best = (est, G)
        return best[1]

    def _local(self, p):
        """Global -> local slot and row maps of part ``p`` (pads map to one
        past the part's last)."""
        part = self.parts[p]
        ls = np.full(self.nnz + 1, -1, np.int64)
        ls[part["slots"]] = np.arange(len(part["slots"]))
        ls[self.nnz] = len(part["slots"])
        lr = np.full(self.n + 1, -1, np.int64)
        lr[part["rows"]] = np.arange(len(part["rows"]))
        lr[self.n] = len(part["rows"])
        return ls, lr

    @staticmethod
    def _steps_stream(recs, cell, dummy):
        """The words of factor records ``recs`` and each record's offset in
        them (one past the last at the end).  A record (p, d, pij, pik,
        pkj) holds rows p with divisors d (-1: the multiplier is already
        in p) and their pairs (pik one of p); its words are [rows, width,
        (p, d) x rows, (pij, pkj) x rows x width], a row's pairs in order,
        padded with ``dummy``; slots go through ``cell``."""
        nr = np.array([len(r[0]) for r in recs], np.int64)
        npr = np.array([len(r[2]) for r in recs], np.int64)
        P, D = _cat([r[0] for r in recs]), _cat([r[1] for r in recs])
        Q, IK, KJ = (_cat([r[i] for r in recs]) for i in (2, 3, 4))
        rstep = np.repeat(np.arange(len(recs)), nr)
        big = int(max(P.max(initial=0), IK.max(initial=0))) + 1
        key = rstep * big + P
        order = np.argsort(key, kind="stable")
        row = order[np.searchsorted(key[order], np.repeat(
            np.arange(len(recs)), npr) * big + IK)]
        cnt = np.bincount(row, minlength=P.size)
        rfirst = _ptr(nr)[:-1]
        w = np.maximum.reduceat(cnt, rfirst) if P.size else nr * 0
        off = _ptr(2 + 2 * nr + 2 * nr * w)
        words = np.empty(off[-1], np.int64)
        words[off[:-1]], words[off[:-1] + 1] = nr, w
        at = _item_at(off, nr, 2, 2)
        words[at] = cell[P]
        words[at + 1] = np.where(D >= 0, cell[D], -1)
        base = off[:-1] + 2 + 2 * nr
        words[_item_at(np.append(base, 0), 2 * nr * w, 0, 1)] = dummy
        rbase = base[rstep] + 2 * (np.arange(P.size) - rfirst[rstep]) \
            * w[rstep]
        o = np.argsort(row, kind="stable")
        rank = np.empty(row.size, np.int64)
        rank[o] = np.arange(row.size) - np.repeat(_ptr(cnt)[:-1], cnt)
        at = rbase[row] + 2 * rank
        words[at], words[at + 1] = cell[Q], cell[KJ]
        return words, off

    @staticmethod
    def _levels_stream(recs, fv, lr):
        """The words of levels ``recs`` ((rows, pos, col), diagonal slots or
        None) as [rows, width, rows through ``lr``, (pos through ``fv``,
        col through ``lr``) x rows x width, back levels: the diagonals
        through ``fv``], and each level's offset (one past the last at the
        end)."""
        nr = np.array([len(r[0][0]) for r in recs], np.int64)
        w = np.array([r[0][1].shape[1] for r in recs], np.int64)
        bk = np.array([r[1] is not None for r in recs], np.int64)
        off = _ptr(2 + nr * (1 + 2 * w + bk))
        words = np.empty(off[-1], np.int64)
        words[off[:-1]], words[off[:-1] + 1] = nr, w
        words[_item_at(off, nr, 2, 1)] = lr[_cat([r[0][0] for r in recs])]
        at = _item_at(off + 2 + np.append(nr, 0), nr * w, 0, 2)
        words[at] = fv[_cat([r[0][1] for r in recs])]
        words[at + 1] = lr[_cat([r[0][2] for r in recs])]
        words[_item_at(off + 2 + np.append(nr * (1 + 2 * w), 0), nr * bk,
                       0, 1)] = fv[_cat([r[1] for r in recs
                                         if r[1] is not None])]
        return words, off

    def program(self, kind, form, limits=None):
        """The int32 program of kernel ``kind`` ("factor" / "apply") in
        ``form`` ("staged" / "streamed"; the streamed form's chunks follow
        ``limits``, a dict of ``mpp_ilu0_limit`` values by LIMITS name
        with the element size's ``stage_values``).  Cached."""
        key = (kind, form) if form == "staged" else \
            (kind, form, limits["stage_words"], limits["stages"],
             limits["stage_values"] if kind == "apply" else 0)
        if key not in self._programs:
            build = {("factor", "staged"): self._factor_staged,
                     ("apply", "staged"): self._apply_staged,
                     ("factor", "streamed"): self._factor_streamed,
                     ("apply", "streamed"): self._apply_streamed}
            self._programs[key] = build[kind, form](limits)
        return self._programs[key]

    def _factor_staged(self, _):
        """Head [nparts, max program words, value stride, 0, table]; a part
        [slots_off, nnz_p, program_off, program words, steps]; its steps
        as :meth:`_steps_stream` records in local slots, the pads' dummy
        one past the part's last slot."""
        pk = _Pack(len(self.parts))
        wmax = nmax = 0
        for p, part in enumerate(self.parts):
            ls, _ = self._local(p)
            words, _ = self._steps_stream(part["steps"], ls,
                                          len(part["slots"]))
            so = pk.add(part["slots"])
            po = pk.add(words)
            pk.part(p, so, len(part["slots"]), po, _pad4(words.size),
                    len(part["steps"]))
            wmax, nmax = max(wmax, _pad4(words.size)), \
                max(nmax, len(part["slots"]))
        pk.head[1:3] = wmax, _odd(nmax + 1)
        return dict(words=pk.done(), prog_words=wmax, stride=_odd(nmax + 1))

    def _apply_staged(self, _):
        """Head [nparts, max program words, stride, y offset, table]; a part
        [rows_off, n_p, slots_off, nnz_p, program_off, program words,
        forward levels, back levels]; a level [rows, width, rows' local
        ids, (f slot, column) x rows x width, back levels: the rows'
        diagonal slots]; pads read the zero one past the part's last slot
        and row."""
        pk = _Pack(len(self.parts))
        wmax = nmax = rmax = 0
        for p, part in enumerate(self.parts):
            ls, lr = self._local(p)
            words, _ = self._levels_stream(
                [(lv, None) for lv in part["fwd"]]
                + list(zip(part["bwd"], part["dpos"])), ls, lr)
            ro = pk.add(part["rows"])
            so = pk.add(part["slots"])
            po = pk.add(words)
            pk.part(p, ro, len(part["rows"]), so, len(part["slots"]), po,
                    _pad4(words.size), len(part["fwd"]), len(part["bwd"]))
            wmax = max(wmax, _pad4(words.size))
            nmax, rmax = max(nmax, len(part["slots"])), \
                max(rmax, len(part["rows"]))
        y_off = nmax + 1
        pk.head[1:4] = wmax, _odd(y_off + rmax + 1), y_off
        return dict(words=pk.done(), prog_words=wmax,
                    stride=_odd(y_off + rmax + 1))

    def _step_pieces(self, st, cap):
        """Step ``st`` as :meth:`_steps_stream` records of at most ``cap``
        words: whole if it fits, else its rows (independent) in runs, a row
        with more pairs than a record holds in pieces, the pieces after its
        first (which divides) going on in later records without a divisor
        (their multiplier read from its slot)."""
        lp, ld, pij, pik, pkj = st
        order = np.argsort(lp, kind="stable")
        row = order[np.searchsorted(lp[order], pik)]
        cnt = np.bincount(row, minlength=len(lp))
        if 2 + 2 * len(lp) * (1 + cnt.max(initial=0)) <= cap:
            return [st]
        o = np.argsort(row, kind="stable")
        cut = _ptr(cnt)
        m = (cap - 4) // 2
        # pieces[k]: the k-th piece of every row that has one, as (p, d,
        # its pairs' positions in st)
        pieces = [[]]
        for r in range(len(lp)):
            mine = o[cut[r]:cut[r + 1]]
            for k in range(max(1, -(-len(mine) // m))):
                if k == len(pieces):
                    pieces.append([])
                pieces[k].append((lp[r], ld[r] if k == 0 else -1,
                                  mine[k * m:(k + 1) * m]))
        recs = []
        for level in pieces:
            for run in _runs(level, lambda t: (2 + 2 * len(t[2]), 0),
                             cap - 2, 1):
                # a run's records are padded to its widest row
                wide = max(len(t[2]) for t in run)
                while 2 + len(run) * (2 + 2 * wide) > cap:
                    recs.append(run[:1])
                    run = run[1:]
                    wide = max([len(t[2]) for t in run] + [0])
                if run:
                    recs.append(run)
        return [(np.array([t[0] for t in rec], np.int64),
                 np.array([t[1] for t in rec], np.int64),
                 pij[_cat([t[2] for t in rec])],
                 pik[_cat([t[2] for t in rec])],
                 pkj[_cat([t[2] for t in rec])]) for rec in recs]

    def _factor_streamed(self, limits):
        """Head [nparts, max cells, 0, 0, table]; a part [chunks, chunk
        table offset, untouched slots offset, their count, cells]; a chunk
        [words offset, words, steps, gathers offset, gathers, write-backs
        offset, write-backs]; a gather / write-back (cell, global slot);
        records (:meth:`_step_pieces`) as in the staged form, in cells,
        the pads' dummy the last cell."""
        SW, NS = limits["stage_words"], limits["stages"]
        pk = _Pack(len(self.parts))
        cmax = 0
        for p, part in enumerate(self.parts):
            recs = [r for st in part["steps"]
                    for r in self._step_pieces(st, SW - 3)]
            size = np.diff(self._steps_stream(recs, np.arange(self.nnz),
                                              0)[1])
            chunks = _runs(range(len(recs)), lambda i: (int(size[i]), 0),
                           SW - 3, 1)
            # live chunks of each slot, then cells by a greedy colouring: a
            # cell is free for slot b once slot a's write-back has read it
            # (after chunk last(a) + 1's barrier, before the fetch of chunk
            # last(a) + NS), so first(b) >= last(a) + NS
            of_rec = np.repeat(np.arange(len(chunks)),
                               [len(run) for run in chunks])
            sl = _cat([a for r in recs for a in (r[0], r[1], r[2], r[4])])
            ch = np.repeat(of_rec, [2 * len(r[0]) + 2 * len(r[2])
                                    for r in recs])
            keep = sl >= 0          # the divisors of continued rows are -1
            sl, ch = sl[keep], ch[keep]
            first = np.full(self.nnz, len(chunks), np.int64)
            last = np.full(self.nnz, -1, np.int64)
            np.minimum.at(first, sl, ch)
            np.maximum.at(last, sl, ch)
            touched = np.nonzero(last >= 0)[0]
            cell = np.full(self.nnz, -1, np.int64)
            free, ncells = [], 0
            for s in touched[np.argsort(first[touched], kind="stable")]:
                if free and free[0][0] <= first[s]:
                    _, c = heapq.heappop(free)
                else:
                    c, ncells = ncells, ncells + 1
                cell[s] = c
                heapq.heappush(free, (int(last[s]) + NS, c))
            og, bg = _group(first[touched], len(chunks))
            ow, bw = _group(last[touched], len(chunks))
            # the pads' dummy: one more cell, after the coloured ones
            words_all, off = self._steps_stream(recs, cell, ncells)
            ncells += 1
            table = np.zeros((len(chunks), FIELDS), np.int64)
            for j, run in enumerate(chunks):
                words = words_all[off[run[0]]:off[run[-1] + 1]]
                _fits(words.size, SW, 0, 0)
                got = touched[og[bg[j]:bg[j + 1]]]
                gone = touched[ow[bw[j]:bw[j + 1]]]
                table[j, :7] = (pk.add(words), _pad4(words.size), len(run),
                                pk.add(np.stack([cell[got], got], 1)),
                                got.size,
                                pk.add(np.stack([cell[gone], gone], 1)),
                                gone.size)
            untouched = part["slots"][last[part["slots"]] < 0]
            pk.part(p, len(chunks), pk.add(table), pk.add(untouched),
                    untouched.size, ncells)
            cmax = max(cmax, ncells)
        pk.head[1] = cmax
        return dict(words=pk.done(), cells=cmax)

    def _level_pieces(self, rows, pos, col, dp, cap_words, cap_values):
        """A sweep level as records of at most ``cap_words`` words and
        ``cap_values`` gathered values: runs of rows (independent) padded to
        their own widest row; a row too wide for a record alone goes in
        pieces, one record each in order, every back piece but the last
        dividing by one (slot ``nnz + 1``, stage value 1), so y_i loses its
        pieces' sums one after another."""
        back = dp is not None
        w = (pos < self.nnz).sum(1)
        out, cur, W, vals = [], [], 0, 0

        def flush():
            if cur:
                a = np.asarray(cur)
                out.append(((rows[a], pos[a, :max(W, 1)], col[a, :max(W, 1)]),
                            dp[a] if back else None))
        for r in range(len(rows)):
            wr = int(w[r])
            if 3 + 2 * wr + back > cap_words or wr + back > cap_values:
                m = min((cap_words - 3 - back) // 2, cap_values - back)
                for k in range(0, wr, m):
                    d = None if not back else np.array(
                        [dp[r] if k + m >= wr else self.nnz + 1])
                    out.append(((rows[r:r + 1], pos[r:r + 1, k:k + m],
                                 col[r:r + 1, k:k + m]), d))
                continue
            W2 = max(W, wr)
            if cur and (2 + (len(cur) + 1) * (1 + 2 * max(W2, 1) + back)
                        > cap_words or vals + wr + back > cap_values):
                flush()
                cur, W, vals, W2 = [], 0, 0, wr
            cur.append(r)
            W, vals = W2, vals + wr + back
        flush()
        return out

    def _apply_streamed(self, limits):
        """Head [nparts, 0, 0, 0, table]; a part [rows_off, n_p, chunks,
        chunk table offset, forward levels]; a chunk [words offset, words,
        levels, gathers offset, gathers]; a gather a global slot, its value
        landing at stage value 2 + its index (value 0 is the pads' zero,
        1 a one); levels as in the staged form (cut by
        :meth:`_level_pieces`), their f slots indices into the chunk's
        values."""
        SW, SV = limits["stage_words"], limits["stage_values"]
        pk = _Pack(len(self.parts))
        rmax = 0
        for p, part in enumerate(self.parts):
            _, lr = self._local(p)
            nf = len(part["fwd"])
            recs = []          # (level, its diagonal slots or None)
            for L, (rows, pos, col) in enumerate(part["fwd"] + part["bwd"]):
                dp = None if L < nf else np.asarray(part["dpos"][L - nf])
                recs += self._level_pieces(rows, pos, col, dp, SW - 3,
                                           SV - 2)
            nfwd = sum(1 for r in recs if r[1] is None)

            size = [(2 + len(rows) * (1 + 2 * pos.shape[1] + (dp is not None)),
                     int((pos < self.nnz).sum())
                     + (0 if dp is None else int((dp < self.nnz).sum())))
                    for (rows, pos, _), dp in recs]
            chunks = _runs(range(len(recs)), size.__getitem__, SW - 3,
                           SV - 2)
            table = np.zeros((len(chunks), FIELDS), np.int64)
            # stage value 0 is the pads' zero, 1 the one of back pieces
            fvix = np.zeros(self.nnz + 2, np.int64)
            fvix[self.nnz + 1] = 1
            for j, run in enumerate(chunks):
                mine = recs[run[0]:run[-1] + 1]
                got = _cat([r[0][1] for r in mine]
                           + [r[1] for r in mine if r[1] is not None])
                got = got[got < self.nnz]
                fvix[got] = 2 + np.arange(got.size)
                words, _ = self._levels_stream(mine, fvix, lr)
                _fits(words.size, SW, got.size, SV - 2)
                table[j, :5] = (pk.add(words), _pad4(words.size), len(run),
                                pk.add(got), got.size)
            pk.part(p, pk.add(part["rows"]), len(part["rows"]), len(chunks),
                    pk.add(table), nfwd)
            rmax = max(rmax, len(part["rows"]))
        return dict(words=pk.done(), rows=rmax)

    # ---- the rule -----------------------------------------------------------

    def plan(self, kind, elem, B, limits):
        """The launch of kernel ``kind`` on ``B`` systems of ``elem``-byte
        values under the kernel library's ``limits`` (see the module
        docstring): a dict with ``form``, ``lanes`` (G), ``systems`` (a
        block), ``threads``, ``blocks``, ``smem`` (bytes) and the
        program; the streamed forms also their on-chip cells / rows and
        the spill each (system, part) keeps in global memory past them."""
        key = (kind, elem, B, tuple(sorted(limits.items())))
        if key in self._plans:
            return self._plans[key]
        P = len(self.parts)
        staged = self.program(kind, "staged")
        per_sys = staged["stride"] * elem
        prog = 4 * staged["prog_words"]
        if prog + per_sys <= limits["staged_bytes"]:
            G = self.lanes(kind)
            S = WARP // G
            best = None
            for k in range(1, min(B, MAX_THREADS // G) + 1):
                smem = prog + k * per_sys
                if smem > limits["staged_bytes"]:
                    break
                warps = -(-k // S)
                resident = k * min(SM_BLOCKS, SM_WARPS // warps,
                                   SM_SMEM // (smem + BLOCK_RESERVED))
                if best is None or resident > best[0]:
                    best = (resident, k)
            k = best[1]
            threads = WARP * -(-k // S)
            plan = dict(form="staged", lanes=G, systems=k, threads=threads,
                        blocks=-(-B // k) * P, smem=prog + k * per_sys,
                        program=staged)
        else:
            prog = self.program(kind, "streamed", limits)
            ring = limits["stages"] * (4 * limits["stage_words"] + (
                elem * limits["stage_values"] if kind == "apply" else 0))
            need = prog["cells"] if kind == "factor" else prog["rows"] + 1
            cap = limits["factor_cells" if kind == "factor"
                         else "apply_rows"]
            on_chip = min(need, cap)
            plan = dict(form="streamed", lanes=WARP, systems=1, threads=64,
                        blocks=B * P, smem=ring + on_chip * elem,
                        program=prog, on_chip=on_chip,
                        spill=max(0, need - cap))
        self._plans[key] = plan
        return plan

    def program_on(self, plan, device):
        """``plan``'s program as an int32 tensor on ``device`` (cached)."""
        key = (id(plan["program"]), str(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(plan["program"]["words"],
                                             device=device)
        return self._dev[key]
