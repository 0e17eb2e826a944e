"""Config ingestion and the NaN-debug switch (counterpart of
``mpp_tpu/config.py``).

* :func:`read_namelist`: a minimal Fortran-namelist parser.  The reference
  drives every standalone problem from Fortran namelists
  (``standalone_mpp.F90:69-123``); the CLI ingests the same ``.namelist``
  files.  Host Python, as in the JAX package.
* The NaN-debug switch.  The JAX package turns on ``jax_debug_nans``; the
  port has no such tracer, so the switch is a module flag read by the
  solvers: when it is armed, the serial SNES and the batched steppers run
  :func:`check_finite` on each residual and each Newton update and raise
  ``FloatingPointError`` naming the stage.  When it is off the checks
  return at once and add no host sync.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict

import torch


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("'") or tok.startswith('"'):
        return tok.strip("'\"")
    low = tok.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    tok_f = re.sub(r"[dD]", "e", tok)
    try:
        if re.fullmatch(r"[+-]?\d+", tok):
            return int(tok)
        return float(tok_f)
    except ValueError:
        return tok


def read_namelist(path_or_text: str) -> Dict[str, Dict[str, Any]]:
    """Parse groups ``&name ... /`` into {group: {key: value}}; the
    argument is the namelist's text (it holds a newline or an ``&``) or
    the path of its file."""
    if "\n" in path_or_text or "&" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    groups: Dict[str, Dict[str, Any]] = {}
    cur = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            cur = {}
            groups[line[1:].strip().lower()] = cur
            continue
        if line.startswith("/"):
            cur = None
            continue
        if cur is not None and "=" in line:
            key, val = line.split("=", 1)
            vals = [v for v in re.split(r"[,\s]+", val.strip()) if v]
            if len(vals) == 1:
                cur[key.strip().lower()] = _parse_value(vals[0])
            else:
                cur[key.strip().lower()] = [_parse_value(v) for v in vals]
    return groups


#: armed by :func:`enable_nan_debug`; read by :func:`check_finite`
DEBUG_NANS = False


def enable_nan_debug(mode: str = "debug_nans") -> None:
    """``debug_nans`` arms the NaN trap; ``disable`` disarms it."""
    global DEBUG_NANS
    if mode == "debug_nans":
        DEBUG_NANS = True
    elif mode == "disable":
        DEBUG_NANS = False
    else:
        raise ValueError(f"unknown NaN-debug mode '{mode}'")


def maybe_enable_nan_debug_from_env() -> bool:
    """Honor MPP_DEBUG_NANS=1 (also checked by the CLI's --debug-nans)."""
    if os.environ.get("MPP_DEBUG_NANS", "") not in ("", "0", "false"):
        enable_nan_debug()
        return True
    return False


def check_finite(stage: str, *values) -> None:
    """With the trap armed, raise ``FloatingPointError`` naming ``stage``
    if any of ``values`` (tensors or numpy arrays) holds a NaN or an inf.
    Disarmed, return at once (no host sync)."""
    if not DEBUG_NANS:
        return
    for v in values:
        t = torch.as_tensor(v)
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"non-finite value in {stage} (MPP_DEBUG_NANS trap)")
