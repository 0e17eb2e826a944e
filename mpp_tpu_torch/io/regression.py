"""Regression-file writer/reader in the reference's exact format (the
port's copy of ``mpp_tpu/io/regression.py``, host numpy).

Writer reproduces ``src/driver/standalone/util/regression.F90:76-120``:
sections ``[name]`` with ``category``, ``min``/``max``/``mean`` and sampled
cells, every value printed with Fortran ``e21.13`` (mantissa in [0.1,1),
13 digits), values with |v|<1e-50 flushed to zero, and the reference's
cell-sampling stride ``int(n/num_cells)`` starting at cell 1.

Reader parses both our output and the reference ``.regression.baseline``
golden files for tolerance comparison (the contract of
``regression_tests/regression_tests.py:666-720``).

``write_data`` takes a numpy array or a tensor on any device; a tensor
crosses to the host through one ``.cpu()`` when it is written.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch


def format_e21_13(v: float) -> str:
    """Fortran ``e21.13`` edit descriptor."""
    if abs(v) < 1e-50:
        v = 0.0
    if v == 0.0:
        return "0.0000000000000E+00".rjust(21)
    s = f"{abs(v):.12E}"          # d.dddddddddddd[E±ee] — 13 significant digits
    mant, exp = s.split("E")
    digits = mant.replace(".", "")
    e = int(exp) + 1
    sign = "-" if v < 0 else ""
    return f"{sign}0.{digits}E{e:+03d}".rjust(21)


class RegressionWriter:
    """Equivalent of ``regression_type`` (regression.F90:7-33)."""

    def __init__(self, base_filename: str, num_cells: int):
        self.filename = base_filename + ".regression"
        self.num_cells = num_cells
        self._lines: List[str] = []

    def write_data(self, name: str, category: str, data) -> None:
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, dtype=np.float64)
        out = self._lines
        out.append(f"[{name}]")
        out.append(f"category = {category}")
        out.append(f"min = {format_e21_13(float(data.min()))}")
        out.append(f"max = {format_e21_13(float(data.max()))}")
        out.append(f"mean = {format_e21_13(float(data.sum() / data.size))}")
        if self.num_cells > 0:
            ncl = min(self.num_cells, data.size)
            inc = data.size // ncl
            for cell in range(0, data.size, inc):
                out.append(f"cell {cell + 1:4d} = {format_e21_13(float(data[cell]))}")
        out.append("")

    def close(self) -> None:
        with open(self.filename, "w") as f:
            f.write("\n".join(self._lines) + "\n")


_SECTION_RE = re.compile(r"^\[(.+)\]$")
_KV_RE = re.compile(r"^([^=]+?)\s*=\s*(.+?)\s*$")


def parse_regression(text: str) -> Dict[str, Dict[str, object]]:
    """Parse sections {name: {category, values: {key: float}}}."""
    sections: Dict[str, Dict[str, object]] = {}
    cur = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        m = _SECTION_RE.match(line)
        if m:
            cur = {"category": None, "values": {}}
            sections[m.group(1)] = cur
            continue
        m = _KV_RE.match(line)
        if m and cur is not None:
            key, val = m.group(1).strip(), m.group(2).strip()
            if key == "category":
                cur["category"] = val
            else:
                cur["values"][re.sub(r"\s+", " ", key)] = float(val)
    return sections


def compare_to_baseline(ours: str, baseline: str,
                        tolerances: Dict[str, Tuple[float, str]]
                        ) -> List[str]:
    """Compare two regression texts; returns list of failure strings.

    ``tolerances`` maps category -> (tol, kind) with kind in
    {absolute, relative, percent} (regression_tests.py:686 semantics).
    """
    ours_s = parse_regression(ours)
    base_s = parse_regression(baseline)
    failures: List[str] = []
    for name, bsec in base_s.items():
        if name not in ours_s:
            failures.append(f"missing section [{name}]")
            continue
        osec = ours_s[name]
        cat = bsec["category"]
        tol, kind = tolerances.get(cat, tolerances.get("default", (1e-12, "absolute")))
        for key, bval in bsec["values"].items():
            if key not in osec["values"]:
                failures.append(f"[{name}] missing key {key}")
                continue
            oval = osec["values"][key]
            if kind == "absolute":
                delta = abs(oval - bval)
            elif kind == "relative":
                delta = abs(oval - bval) / (abs(bval) if bval != 0 else 1.0)
            else:  # percent
                delta = 100.0 * abs(oval - bval) / (abs(bval) if bval != 0 else 1.0)
            if delta > tol:
                failures.append(
                    f"[{name}] {key}: ours={oval!r} baseline={bval!r} "
                    f"delta={delta:.3e} > {kind} tol {tol:.1e}")
    return failures


def load_suite_tolerances(cfg_path: str, test_name: str
                          ) -> Dict[str, Tuple[float, str]]:
    """Read per-suite ``.cfg`` tolerances with per-test overrides
    (e.g. regression_tests/vsfm/vsfm.cfg)."""
    # Harness defaults: every known category starts at 1e-16 absolute
    # (regression_tests.py:777-788 Tolerances._DEFAULT_EPSILON)
    tols: Dict[str, Tuple[float, str]] = {
        c: (1.0e-16, "absolute")
        for c in ("general", "temperature", "pressure", "velocity")}
    overrides: Dict[str, Tuple[float, str]] = {}
    section = None
    with open(cfg_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _SECTION_RE.match(line)
            if m:
                section = m.group(1)
                continue
            m = _KV_RE.match(line)
            if not m:
                continue
            key, val = m.group(1).strip(), m.group(2).split()
            entry = (float(val[0]), val[1] if len(val) > 1 else "absolute")
            if section == "default_tolerances":
                tols[key] = entry
            elif section == test_name:
                overrides[key] = entry
    tols.update(overrides)
    return tols
