"""The port's host builders against the JAX package's native C++ runtime
layer (``mpp_tpu.native``): the five equivalences of tests/test_native.py,
each with the port's pure-Python builder in the place of the numpy
reference.

The port does not build the C++ library: it builds CSR templates
(``ops/sparse.csr_template``), structured-mesh connections
(``dtypes/mesh``) and PETSc binary Vecs (``io/petsc_vec``) in Python on
the host.  These tests hold those builders to the native outputs element
for element.
"""
import numpy as np
import pytest

from mpp_tpu import native
from mpp_tpu_torch.constants import ConnKind
from mpp_tpu_torch.dtypes import mesh as tmesh
from mpp_tpu_torch.io import petsc_vec as tvec
from mpp_tpu_torch.ops.sparse import csr_template

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library failed to build")


def test_csr_template_matches_native():
    rng = np.random.default_rng(0)
    for n_rows, n_cols, ncoo in [(7, 7, 40), (100, 100, 1000), (3, 5, 1)]:
        rows = rng.integers(0, n_rows, ncoo).astype(np.int64)
        cols = rng.integers(0, n_cols, ncoo).astype(np.int64)
        indptr, indices, slots = native.csr_template_native(
            n_rows, n_cols, rows, cols)
        tpl = csr_template(n_rows, n_cols, rows, cols)
        np.testing.assert_array_equal(tpl.indptr, indptr)
        np.testing.assert_array_equal(tpl.indices, indices)
        np.testing.assert_array_equal(tpl.slots, slots)


def test_csr_template_rejects_out_of_range():
    for rows, cols in (([5], [0]), ([0], [4]), ([-1], [0])):
        rows, cols = np.array(rows, np.int64), np.array(cols, np.int64)
        with pytest.raises(ValueError):
            native.csr_template_native(4, 4, rows, cols)
        with pytest.raises(ValueError):
            csr_template(4, 4, rows, cols)


def test_structured_connections_match_native():
    for idir, nat_dir in [(ConnKind.IN_X_DIR, 1), (ConnKind.IN_Y_DIR, 2),
                          (ConnKind.IN_Z_DIR, 3)]:
        id_up, id_dn, dup, ddn, area = native.structured_connections_native(
            3, 4, 5, 0.5, 0.25, 2.0, nat_dir)
        cs = tmesh._internal_conns_along_dir(3, 4, 5, 0.5, 0.25, 2.0, idir)
        np.testing.assert_array_equal(cs.id_up, id_up)
        np.testing.assert_array_equal(cs.id_dn, id_dn)
        np.testing.assert_array_equal(cs.dist_up, dup)
        np.testing.assert_array_equal(cs.dist_dn, ddn)
        np.testing.assert_array_equal(cs.area, area)


def test_petsc_vec_codec_matches_native(tmp_path):
    x = np.linspace(-3.0, 7.5, 17)
    y = np.array([1.5, -2.25])
    # native writes, the port reads
    p = str(tmp_path / "native.bin")
    assert native.petsc_vec_write_native(p, x)
    assert native.petsc_vec_write_native(p, y, append=True)
    np.testing.assert_array_equal(tvec.read_vec(p), x)
    got = tvec.read_vecs(p)
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], y)
    # the port writes, native reads; the bytes are the same
    q = str(tmp_path / "port.bin")
    tvec.write_vec(q, x)
    tvec.write_vec(q, y, append=True)
    data0, off = native.petsc_vec_read_native(q, 0)
    np.testing.assert_array_equal(data0, x)
    data1, _ = native.petsc_vec_read_native(q, off)
    np.testing.assert_array_equal(data1, y)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_structured_mesh_matches_native_mesh():
    """The port's structured_mesh equals the JAX package's, whose
    connections come from the native builder."""
    from mpp_tpu.constants import ConnKind as JConnKind
    from mpp_tpu.dtypes import mesh as jmesh
    for tdir, jdir in ((ConnKind.IN_Z_DIR, JConnKind.IN_Z_DIR),
                       (ConnKind.IN_XYZ_DIR, JConnKind.IN_XYZ_DIR)):
        jm = jmesh.structured_mesh("t", 1.0, 1.5, 2.0, 3, 4, 5, jdir)
        tm = tmesh.structured_mesh("t", 1.0, 1.5, 2.0, 3, 4, 5, tdir)
        assert len(tm.intrn_conn_sets) == len(jm.intrn_conn_sets)
        for a, b in zip(tm.intrn_conn_sets, jm.intrn_conn_sets):
            for f in ("id_up", "id_dn", "dist_up", "dist_dn", "area",
                      "itype"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f)
        for f in ("xc", "yc", "zc", "dx", "dy", "dz", "area_xy", "vol"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                          err_msg=f)
    ids = tmesh.compute_cell_ids(3, 4, 5)
    cs = tmesh.structured_mesh("t", 1.0, 1.5, 2.0, 3, 4, 5,
                               ConnKind.IN_Z_DIR).intrn_conn_sets[0]
    exp_up = [ids[kk, jj, ii] for ii in range(3) for jj in range(4)
              for kk in range(4)]
    np.testing.assert_array_equal(cs.id_up, exp_up)
