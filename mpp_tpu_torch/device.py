"""The device rule of the port's entry points.

Entry points (``entry``, ``alm_vsfm_initialize``, ``gather_inputs``,
``_serial_dyn``, the serial drop-in ``step_dt``) default to the card,
``"cuda"``.  The CPU runs only when the caller asks for it with
``device="cpu"``; a CUDA device on a machine without a usable card raises
and never falls back.
"""
from __future__ import annotations

import torch


def device_of(device) -> torch.device:
    """``device`` as a ``torch.device``; raise RuntimeError if it is a CUDA
    device and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev
