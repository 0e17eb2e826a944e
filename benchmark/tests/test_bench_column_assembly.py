"""``column_assembly_roofline``'s arithmetic on a synthetic trace and
recorded calls: each launch's bytes by its mode, the share over the
launches' device time, and nothing read where launches or calls are
missing."""
import types

import pytest

import devtrace
import roofline
import run

NAME = "void mpp::column_assemble_kernel<{}, mpp::{}>(mpp::ColumnAssembleArgs)"


def _reader():
    return run.metric_reader("column_assembly_roofline")


def _run(device, calls):
    t = devtrace.Trace(device=list(device), host=[], window=(0.0, 1.0))
    return types.SimpleNamespace(
        trace=t, records=[{}],
        calls={"vsfm_column_assemble": calls} if calls is not None else {})


# the recorded shapes of one call: P, dt, seven [ncol, nz] soil fields,
# por_base, perm, vol, temperature, the faces' three [ncol, nz - 1] arrays
# and the shared [nz - 1] unit vectors, the seepage face's [ncol, 1] value
# and geometry and shared [1] unit vector, the sinks' [ncol, 34] values,
# then (F modes) accum_prev and src
NCOL, NZ = 8, 15


def _shapes(mode):
    cell, face, bc = (NCOL, NZ), (NCOL, NZ - 1), (NCOL, 1)
    s = [cell, (NCOL, 1)] + [cell] * 7 + [cell] * 4 + [face] * 3 + \
        [(NZ - 1,)] + [bc] * 4 + [(1,)]
    if mode != "AsmBands":
        s += [(NCOL, 34), cell, cell]
    return s


def _values(shapes):
    n = 0
    for s in shapes:
        k = 1
        for d in s:
            k *= d
        n += k
    return n


@pytest.mark.parametrize("dtype,elem", [("float64", 8), ("float32", 4)])
def test_bytes_by_mode(dtype, elem):
    r = _reader()
    for mode, outputs in (("AsmResidual", 1), ("AsmBands", 3),
                          ("AsmBoth", 4)):
        shapes = _shapes(mode)
        assert r.launch_bytes(shapes, dtype, mode) == \
            (_values(shapes) + outputs * NCOL * NZ) * elem


def test_share_over_the_launches():
    r = _reader()
    modes = ("AsmResidual", "AsmBands", "AsmBoth", "AsmResidual")
    # launches of 1, 2, 3 and 4 us, other kernels between them
    device, calls, bound = [], [], 0.0
    for i, mode in enumerate(modes):
        device.append(("thomas_kernel<double>", 0.1 * i, 0.1 * i + 0.01))
        device.append((NAME.format("double", mode), 0.1 * i + 0.02,
                       0.1 * i + 0.02 + (i + 1) * 1e-6))
        calls.append((_shapes(mode), "float64"))
        bound += r.launch_bytes(_shapes(mode), "float64", mode) \
            / roofline.HBM_BYTES_S
    got = r.read(_run(device, calls))
    assert got == pytest.approx(100.0 * bound / 10e-6)
    # the bound is bytes alone: no operations enter it
    assert bound == pytest.approx(sum(
        roofline.bound_s(r.launch_bytes(s, d, m), 0, d)
        for (s, d), m in zip(calls, modes)))


def test_nothing_read_without_every_launch_or_call():
    r = _reader()
    launch = (NAME.format("double", "AsmBoth"), 0.0, 1e-4)
    call = (_shapes("AsmBoth"), "float64")
    assert r.read(_run([launch], [])) is None
    assert r.read(_run([launch], None)) is None
    assert r.read(_run([launch, launch], [call])) is None
    assert r.read(_run([], [call])) is None
    unnamed = ("void mpp::column_assemble_kernel<double, X>()", 0.0, 1e-4)
    assert r.read(_run([unnamed], [call])) is None
    assert r.read(_run([launch], [call])) == pytest.approx(
        100.0 * r.launch_bytes(*call, "AsmBoth") / roofline.HBM_BYTES_S
        / 1e-4)


def test_wraps_only_what_the_program_has(monkeypatch):
    from mpp_tpu_torch.ops import hopper_kernels as hk
    assert _reader().WRAP == ("vsfm_column_assemble",)
    monkeypatch.delattr(hk, "vsfm_column_assemble")
    assert _reader().WRAP == ()
