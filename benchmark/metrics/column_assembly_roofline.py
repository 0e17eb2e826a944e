"""The column assembly kernel's share of its roofline over the traced steps:
every launch's bound over its device time.  A launch's bound is its bytes
at 3.35 TB/s: each input read once (the recorded shapes of the wrapper's
arrays: a [ncol, m] input ncol * m values, an [m] one shared by every
column m values) and each output written once (F, the three bands or all
four, [ncol, nz] each, by the mode the launch's kernel name carries).

A program without the kernel's wrapper has nothing to wrap: the metric then
reads nothing and is left out of the result."""
import roofline

KERNEL = "column_assemble_kernel"
#: outputs a launch writes, by the mode in its kernel's name
OUTPUTS = {"AsmResidual": 1, "AsmBands": 3, "AsmBoth": 4}


def _wrap():
    from mpp_tpu_torch.ops import hopper_kernels as hk
    name = "vsfm_column_assemble"
    return (name,) if hasattr(hk, name) else ()


WRAP = _wrap()


def launch_bytes(shapes, dtype, mode):
    """Bytes of one launch: the recorded input ``shapes`` (P's first) read
    once, the ``mode``'s outputs written once."""
    ncol, nz = shapes[0]
    read = 0
    for s in shapes:
        k = 1
        for d in s:
            k *= d
        read += k
    return (read + OUTPUTS[mode] * ncol * nz) * roofline.ELEM[dtype]


def read(run):
    calls = run.calls.get("vsfm_column_assemble")
    if not calls:
        return None
    names = [n for n, _, _ in run.trace.device if KERNEL in n]
    if len(names) != len(calls):
        return None
    works = []
    for (shapes, dtype), name in zip(calls, names):
        mode = next((m for m in OUTPUTS if m in name), None)
        if mode is None:
            return None
        works.append((launch_bytes(shapes, dtype, mode), 0,
                      roofline.PEAK_OPS_S))
    return roofline.launch_share(run.trace, (KERNEL,), works, calls[0][1])
