"""The port's host tools against the JAX package's, bit for bit.

``nsdp_tpu_torch.native`` (its own copy of the C++ source, built with the
flags of ``nsdp_tpu/native/Makefile``), ``nsdp_tpu_torch.meshing`` and the
flow/arrow functions of ``nsdp_tpu_torch.utils.visualize``, on the same
inputs made from a numpy seed as ``nsdp_tpu.native``, ``nsdp_tpu.meshing``
and ``nsdp_tpu.utils.visualize``: arrays equal bit for bit, files byte for
byte.  A native build that fails raises.
"""

import numpy as np
import pytest
from scipy.spatial import KDTree

from nsdp_tpu import meshing as jax_meshing
from nsdp_tpu import native as jax_native
from nsdp_tpu.utils import visualize as jax_visualize
from nsdp_tpu_torch import meshing, native
from nsdp_tpu_torch.utils import visualize


def _same(got, want):
    """Nested tuples/lists of arrays equal bit for bit, dtypes included."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = lambda a: a.reshape(-1).view(np.uint8)
    np.testing.assert_array_equal(bits(got), bits(want))


def _sphere_volume(n=24, r=0.35):
    xs = np.linspace(0, 1, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return ((gx - 0.5) ** 2 + (gy - 0.5) ** 2 + (gz - 0.5) ** 2) - r * r


# ---------------------------------------------------------------- native


@pytest.mark.parametrize("n_points,n_queries,scale", [
    (1, 7, 1.0), (9, 40, 1.0), (2000, 500, 1.0), (30000, 3000, 1e-2),
])
def test_nearest_neighbors_match_jax(n_points, n_queries, scale):
    rng = np.random.RandomState(n_points)
    points = (scale * rng.randn(n_points, 3)).astype(np.float32)
    queries = (scale * rng.randn(n_queries, 3)).astype(np.float32)
    got = native.nearest_neighbor_distances(queries, points, return_index=True)
    _same(got, jax_native.nearest_neighbor_distances(queries, points, return_index=True))
    _same(native.nearest_neighbor_distances(queries, points), got[0])
    # the same neighbours as scipy's float64 search; the distances its
    # float64 ones rounded to float32 up to the float32 sum's rounding
    d, i = KDTree(points).query(queries)
    np.testing.assert_array_equal(got[1], i)
    np.testing.assert_allclose(got[0], d, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["sphere", "noise", "empty", "level"])
def test_marching_tetrahedra_match_jax(case):
    rng = np.random.RandomState(1)
    grid, level = {
        "sphere": (_sphere_volume(20, 0.3), 0.0),
        "noise": (rng.randn(9, 11, 7), 0.1),
        "empty": (np.ones((6, 6, 6)), 0.0),
        "level": (np.sqrt(_sphere_volume(16, 0.0)), 0.3),
    }[case]
    got = native.marching_cubes(grid, level)
    _same(got, jax_native.marching_cubes(grid, level))
    assert (len(got[0]) == 0) == (case == "empty")


@pytest.mark.parametrize("shape", [(4, 2), (12,), (2, 3, 1)])
def test_nearest_neighbors_refuse_rows_that_are_not_points(shape):
    """The C side reads three floats a row: anything else is refused before
    a pointer is passed."""
    good = np.zeros((4, 3), np.float32)
    for queries, points in ((np.zeros(shape), good), (good, np.zeros(shape))):
        with pytest.raises(ValueError, match="must be"):
            native.nearest_neighbor_distances(queries, points)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails, or is missing, raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    for cxx, match in (("false", "native build failed"),
                       (str(tmp_path / "no-such-compiler"), "cannot run")):
        monkeypatch.setattr(native, "CXX", cxx)
        with pytest.raises(RuntimeError, match=match):
            native.nearest_neighbor_distances(np.zeros((1, 3)), np.zeros((1, 3)))
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_build_is_keyed_by_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libnsdp_native-")
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-g",))
    assert native.library_path() != path
    with open(native.SOURCE) as f, open(jax_native._DIR + "/src/nsdp_native.cpp") as g:
        code = lambda lines: [ln for ln in lines if not ln.startswith("//")]
        assert code(f) == code(g)  # the same C++, comments aside


# ---------------------------------------------------------------- meshing


def _plane_volumes(n=9, ss=4):
    plane = lambda x: np.tanh(8.0 * (x - 0.52))
    xs_c, xs_f = np.linspace(0, 1, n), np.linspace(0, 1, n + (n - 1) * ss)
    vx = plane(np.meshgrid(xs_f, xs_c, xs_c, indexing="ij")[0])
    vy = plane(np.meshgrid(xs_c, xs_f, xs_c, indexing="ij")[0])
    vz = plane(np.meshgrid(xs_c, xs_c, xs_f, indexing="ij")[0])
    return vx, vy, vz, 0.0


def _binary(n=16, r=0.3):
    return _sphere_volume(n, r) < 0


def _scalar_f(x, y, z):
    if np.ndim(x):  # the per-point fallback
        raise TypeError
    return (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 - 0.1


MESHING = {
    "marching_cubes": lambda m: m.marching_cubes(_sphere_volume(18), 0.0),
    "marching_cubes_color": lambda m: m.marching_cubes_color(
        _sphere_volume(14), np.random.RandomState(3).rand(14, 14, 14, 3), 0.0),
    "marching_cubes_func": lambda m: m.marching_cubes_func(
        (0.0, -0.5, 0.0), (1.0, 1.0, 1.2), 12, 10, 14,
        lambda x, y, z: (x - 0.5) ** 2 + y ** 2 + (z - 0.5) ** 2 - 0.2, 0.0),
    "marching_cubes_func_scalar": lambda m: m.marching_cubes_func(
        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 8, 8, 8, _scalar_f, 0.0),
    "marching_cubes_color_func": lambda m: m.marching_cubes_color_func(
        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 12, 12, 12, _scalar_f,
        lambda x, y, z: np.sin(x), lambda x, y, z: y * z, _scalar_f, 0.0),
    "marching_cubes_super_sampling": lambda m: m.marching_cubes_super_sampling(
        *_plane_volumes()),
    "signed_distance_function": lambda m: m.signed_distance_function(_binary(), 3),
    "smooth_constrained": lambda m: m.smooth_constrained(_binary(), band_radius=3,
                                                         max_iters=40),
    "smooth_gaussian": lambda m: m.smooth_gaussian(_binary(), sigma=1.5),
    "smooth_auto": lambda m: m.smooth(_binary(12, 0.3)),
    "smooth_gaussian_dispatch": lambda m: m.smooth(_binary(12), method="gaussian", sigma=2),
}


@pytest.mark.parametrize("name", sorted(MESHING))
def test_meshing_matches_jax(name):
    got, want = MESHING[name](meshing), MESHING[name](jax_meshing)
    _same(got, want)


def test_meshing_exports_all_of_the_jax_api():
    assert meshing.__all__ == jax_meshing.__all__
    assert all(callable(getattr(meshing, n)) for n in meshing.__all__)


@pytest.mark.parametrize("name,ext,colored", [
    ("export_obj", "obj", False), ("export_off", "off", False),
    ("export_mesh", "ply", True), ("export_mesh", "obj", True),
])
def test_exporters_match_jax_byte_for_byte(tmp_path, name, ext, colored):
    verts, faces = meshing.marching_cubes(_sphere_volume(12), 0.0)
    if colored:
        rgb = np.random.RandomState(0).rand(len(verts), 3).astype(np.float32)
        verts = np.concatenate([verts, rgb], axis=1)
    getattr(meshing, name)(verts, faces, str(tmp_path / f"port.{ext}"))
    getattr(jax_meshing, name)(verts, faces, str(tmp_path / f"jax.{ext}"))
    assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()


@pytest.mark.parametrize("call", ["color_channels", "func_args", "smooth_method"])
def test_meshing_refuses_what_jax_refuses(call):
    run = {
        "color_channels": lambda m: m.marching_cubes_color(
            _sphere_volume(8), np.zeros((8, 8, 8, 2)), 0.0),
        "func_args": lambda m: m.marching_cubes_func((1, 0, 0), (0, 1, 1), 8, 8, 8,
                                                     lambda x, y, z: x, 0.0),
        "smooth_method": lambda m: m.smooth(_binary(8), method="nope"),
    }[call]
    for module in (meshing, jax_meshing):
        with pytest.raises(ValueError):
            run(module)


# ---------------------------------------------------------------- visualize


def _flows(n=40, seed=5):
    rng = np.random.RandomState(seed)
    flows = rng.randn(n, 3)
    flows[0] = (0.0, 0.0, -2.0)  # antiparallel to +z: the 180 degree flip
    flows[1] = (0.0, 0.0, 3.0)  # parallel
    return rng.randn(n, 3), flows


VISUALIZE = {
    "vis_error_map": lambda v: v.vis_error_map(
        *(lambda r: (r.randn(30, 3).astype(np.float32), r.randint(0, 30, (20, 3)),
                     0.2 * r.rand(30)))(np.random.RandomState(2))),
    "_unit_arrow": lambda v: v._unit_arrow(7, 0.01, 0.02, 0.1, 0.05),
    "_rotations_to": lambda v: v._rotations_to(_flows()[1]),
    "_assemble_arrows": lambda v: v._assemble_arrows(*_flows(), resolution=6),
    "vis_flow_volume_arrow": lambda v: v.vis_flow_volume_arrow(
        np.random.RandomState(4).randn(8 ** 3, 3),
        np.random.RandomState(6).rand(8 ** 3) > 0.7, dim=8, bbox_size=1.2, resolution=5),
    "vis_flow_surface_arrow": lambda v: v.vis_flow_surface_arrow(
        *_flows(), (np.arange(40) % 3 == 0).astype(np.float32)[:, None], resolution=8),
}


@pytest.mark.parametrize("name", sorted(VISUALIZE))
def test_visualize_matches_jax(name):
    _same(VISUALIZE[name](visualize), VISUALIZE[name](jax_visualize))


@pytest.mark.parametrize("stride", [1, 3])
def test_export_flow_field_matches_jax_byte_for_byte(tmp_path, stride):
    src, flows = _flows(25)
    dst = src + 0.1 * flows
    visualize.export_flow_field(str(tmp_path / "port.ply"), src, dst, stride)
    jax_visualize.export_flow_field(str(tmp_path / "jax.ply"), src, dst, stride)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
