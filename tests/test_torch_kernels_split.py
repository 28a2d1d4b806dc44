"""The split designs of K3 (FPS) and K4 (kNN) on the card, emulated in numpy.

Above ``SMEM_POINTS`` points the FPS kernel runs one thread-block cluster of
C blocks per cloud, block r holding the range ``[r * per, (r + 1) * per)``
(``per = ceil(N / C)``): each step every block takes the arg-max over its
range, then every block the arg-max over the C picks by global index.  K4
with W warps a query splits the cloud into W parts, part p the points ``e``
with ``(e // 32) % W == p`` (lane ``e % 32`` of warp p scans it): each
part's k best by (d2, index), then a merge of the parts' lists by (d2,
index); with two passes the lists first lose every point above a bound,
the k-th smallest of each warp's 32 lane minima, least over the warps.
The numpy emulations below
follow those rules step by step and are held against the port's plain
versions and the JAX package (``furthest_point_sample_xla``,
``furthest_point_sample_pallas`` and ``knn_pallas`` in interpret mode), on
clouds built to break them: exact duplicates on both sides of a range or
part boundary, masked points, a part with fewer than k points, a mask that
covers a whole part, an all-invalid cloud.  The wrappers' choice of variant
and geometry is pinned here too; the kernels themselves are held against
the plain versions on the card in ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.ops.fps import furthest_point_sample_xla
from nsdp_tpu.ops.fps_pallas import furthest_point_sample_pallas
from nsdp_tpu.ops.knn_pallas import knn_pallas
from nsdp_tpu_torch.ops import fps as port_fps
from nsdp_tpu_torch.ops import knn as port_knn

# ---------------------------------------------------------------- FPS (K3)


@pytest.mark.parametrize("n,kind,c", [
    (1024, "shared", 1), (14496, "shared", 1), (14497, "cluster", 8), (40962, "cluster", 8),
    (50000, "cluster", 8), (115712, "cluster", 8), (115713, "global", 1), (200000, "global", 1),
])
def test_fps_variant_by_cloud_size(n, kind, c):
    """Shared memory up to 14,496 points; a cluster of 8 blocks (the
    fastest size on an H100 at 14,497, 40,962 and 50,000 points) up to 8 x
    14,464 points; the global variant above."""
    assert port_fps.SMEM_POINTS == 14496 and port_fps.CLUSTER_BLOCK_POINTS == 14464
    assert port_fps.CLUSTER_POINTS == 8 * 14464
    assert port_fps.variant(n) == (kind, c)
    if kind == "cluster":
        assert -(-n // c) <= port_fps.CLUSTER_BLOCK_POINTS


def fps_by_ranges(xyz: np.ndarray, npoint: int, c: int) -> np.ndarray:
    """FPS as the cluster kernel computes it: each step the arg-max of the
    running min-distance over each of the c ranges (ties to the lowest
    index; a range without a valid point offers (-1, N)), then over the
    ranges' picks by value, ties to the lowest global index; N (no valid
    point anywhere) picks 0.  float32 throughout, ``(x*x + y*y) + z*z``."""
    B, n, _ = xyz.shape
    per = -(-n // c)
    out = np.zeros((B, npoint), np.int32)
    for b in range(B):
        x, y, z = (xyz[b, :, i] for i in range(3))
        valid = (x * x + y * y) + z * z > np.float32(1e-3)
        md = np.full(n, 1e10, np.float32)
        last = 0
        for s in range(1, npoint):
            dx, dy, dz = x - x[last], y - y[last], z - z[last]
            md = np.where(valid, np.minimum(md, (dx * dx + dy * dy) + dz * dz), md)
            picks = []
            for r in range(c):
                lo, hi = r * per, min(n, (r + 1) * per)
                cand = lo + np.flatnonzero(valid[lo:hi])
                picks.append((md[cand].max(), cand[np.argmax(md[cand])]) if len(cand) else
                             (np.float32(-1.0), n))
            _, last = max(picks, key=lambda vi: (vi[0], -vi[1]))
            last = 0 if last == n else last
            out[b, s] = last
    return out


def _fps_clouds():
    """(B, N, 3) clouds whose picks cross the ranges' boundaries of C = 2,
    4 and 8 blocks at N = 2400 (ranges of 1200, 600 and 300 points)."""
    rng = np.random.RandomState(11)
    n = 2400
    dup = rng.randn(2, n, 3).astype(np.float32)
    for i, j in ((299, 300), (599, 600), (1199, 1200), (1799, 2100)):  # boundary pairs
        dup[:, j] = dup[:, i] = rng.randn(3).astype(np.float32) * 4.0  # far out: picked early
    tiled = np.tile(rng.randn(1, n // 4, 3).astype(np.float32), (1, 4, 1))  # a copy in each quarter
    masked = rng.randn(2, n, 3).astype(np.float32)
    masked[0, 600:1200] = 0.0  # a whole range of C = 4 invalid
    masked[1, ::3] = 1e-2  # |p|^2 = 3e-4: never picked, index 0 among them
    invalid = np.full((1, n, 3), 1e-2, np.float32)
    return {"boundary_duplicates": dup, "tiled": tiled, "masked": masked, "all_invalid": invalid}


@pytest.mark.parametrize("case", ["boundary_duplicates", "tiled", "masked", "all_invalid"])
@pytest.mark.parametrize("c", [2, 4, 8])
def test_fps_range_split_matches_jax(case, c):
    """The range split's picks == the port's plain FPS == the JAX package's
    XLA and Pallas (interpret) FPS, index for index."""
    xyz = _fps_clouds()[case]
    npoint = 40
    got = fps_by_ranges(xyz, npoint, c)
    plain = port_fps.furthest_point_sample_plain(torch.from_numpy(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, np.asarray(furthest_point_sample_xla(jnp.asarray(xyz),
                                                                            npoint)))
    np.testing.assert_array_equal(got, np.asarray(
        furthest_point_sample_pallas(jnp.asarray(xyz), npoint, interpret=True)))
    if case == "all_invalid":
        assert not got.any()
    if case == "tiled":  # a tie every step, across ranges: the lowest copy wins
        assert (got < xyz.shape[1] // 4).all()
    if case == "masked":
        assert not np.isin(got[0, 1:], np.arange(600, 1200)).any()
        assert not (got[1, 1:] % 3 == 0).any()


def test_fps_range_split_at_a_cluster_size_matches_jax():
    """At 14,497 points (the smallest cluster cloud, ranges of 1,813), with
    exact copies of one far point on both sides of the fourth boundary
    (7,251 | 7,252) and points at the origin, a whole range among them: the
    range split == the plain FPS == the JAX XLA FPS."""
    n = 14497
    kind, c = port_fps.variant(n)
    per = -(-n // c)
    assert (kind, c, per) == ("cluster", 8, 1813)
    rng = np.random.RandomState(5)
    xyz = rng.randn(1, n, 3).astype(np.float32)
    xyz[0, 4 * per - 1] = xyz[0, 4 * per] = np.float32([50.0, -40.0, 30.0])
    xyz[0, 100:2000] = 0.0
    got = fps_by_ranges(xyz, 24, c)
    assert got[0, 1] == 4 * per - 1
    np.testing.assert_array_equal(
        got, port_fps.furthest_point_sample_plain(torch.from_numpy(xyz), 24).numpy())
    np.testing.assert_array_equal(got, np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), 24)))


# ---------------------------------------------------------------- kNN (K4)


@pytest.mark.parametrize("site,B,Nq,M,w,two", [
    ("probe", 1, 1, 32, 1, False),  # one query against 32 points, one a lane
    ("sa_level0", 1, 500, 5000, 2, True),
    ("sa_level1", 1, 100, 500, 4, False),
    ("sa_level0_b8", 8, 500, 5000, 1, True),
    ("sa_level1_b8", 8, 100, 500, 1, False),
    ("begin_block_b8", 8, 5000, 5000, 1, True),
    ("large_cloud", 1, 2000, 20000, 1, True),
])
def test_knn_geometry_at_the_sites(site, B, Nq, M, w, two):
    """Warps a query and the bound pass at K4's sites (the set
    abstraction's grouping at serving's B = 1 and training's B = 8, the
    begin block's 5000 x 5000, a 20,000-point cloud) on an H100 (132
    SMs): one warp where the queries are 4 an SM or more or the cloud is
    small, more where so few queries would leave the card idle; the bound
    pass where each lane scans 32 points or more."""
    assert port_knn.split_warps(B, Nq, M, sms=132) == w
    assert port_knn.two_pass(M, w) is two


def test_knn_split_warps_bounds():
    """Never more than a block's 8 warps, never a part under 64 points,
    never fewer than one warp, one from 4 queries an SM; fewer SMs, fewer
    warps."""
    for B, Nq, M in ((1, 1, 10 ** 6), (1, 7, 127), (1, 7, 128), (64, 5000, 10 ** 5), (1, 1, 1)):
        w = port_knn.split_warps(B, Nq, M)
        assert w in (1, 2, 4, 8) and (w == 1 or M >= 64 * w)
    assert port_knn.split_warps(1, 1, 10 ** 6) == 8
    assert port_knn.split_warps(1, 7, 127) == 1 and port_knn.split_warps(1, 7, 128) == 2
    assert port_knn.split_warps(1, 264, 5000) == 4 and port_knn.split_warps(1, 265, 5000) == 2
    assert port_knn.split_warps(1, 527, 5000) == 2 and port_knn.split_warps(1, 528, 5000) == 1
    assert port_knn.split_warps(1, 500, 5000, sms=16) < port_knn.split_warps(1, 500, 5000)


def knn_by_parts(q: np.ndarray, p: np.ndarray, k: int, w: int, mask=None, bound=False):
    """kNN as the split kernel computes it: d2 = penalty + sum_c (q_c -
    p_c)^2 in float32, in that order; with ``bound``, every point above
    tau dropped, tau the least over the parts of the k-th smallest of their
    32 lanes' nearest distances; each part's k best by (d2, index) (fewer
    where a part holds fewer points); then the parts' lists merged by (d2,
    index) -> ((B, Nq, k) int32, (B, Nq, k) float32)."""
    M = p.shape[1]
    pen = np.zeros(p.shape[:2], np.float32) if mask is None else (
        (mask == 0).astype(np.float32) * np.float32(1e30))
    d2 = np.broadcast_to(pen[:, None, :], (q.shape[0], q.shape[1], M))
    for c in range(3):
        diff = q[:, :, None, c] - p[:, None, :, c]
        d2 = d2 + diff * diff
    part, lane = (np.arange(M) // 32) % w, np.arange(M) % 32
    if bound:
        tau = np.full(d2.shape[:2], np.inf, np.float32)
        for pp in range(w):
            nearest = np.stack([d2[..., (part == pp) & (lane == ln)].min(-1, initial=np.inf)
                                for ln in range(32)], -1)
            tau = np.minimum(tau, np.sort(nearest, -1)[..., k - 1])
        d2 = np.where(d2 <= tau[..., None], d2, np.float32(np.inf))  # dropped: never chosen
    cand_i, cand_d = [], []
    for pp in range(w):
        e = np.flatnonzero(part == pp)
        best = np.argsort(d2[..., e], axis=-1, kind="stable")[..., :k]  # ties: lower index
        cand_i.append(e[best])
        cand_d.append(np.take_along_axis(d2[..., e], best, axis=-1))
    cand_i, cand_d = np.concatenate(cand_i, -1), np.concatenate(cand_d, -1)
    order = np.lexsort((cand_i, cand_d), axis=-1)[..., :k]
    return (np.take_along_axis(cand_i, order, -1).astype(np.int32),
            np.take_along_axis(cand_d, order, -1))


def _knn_case(case, w):
    """(query, points, k, mask) for a case, the parts those of w warps."""
    rng = np.random.RandomState(21)
    mask = None
    if case == "tiled":  # 8 copies of 50 points: every tie crosses parts
        p = np.tile(rng.randn(1, 50, 3).astype(np.float32), (1, 8, 1))
        q = np.concatenate([p[:, :20], rng.randn(1, 20, 3).astype(np.float32)], 1)
        k = 32
    elif case == "masked":
        p = rng.randn(2, 300, 3).astype(np.float32)
        q = rng.randn(2, 30, 3).astype(np.float32)
        mask = (rng.rand(2, 300) > 0.3).astype(np.float32)
        k = 10
    elif case == "short_part":  # part 1 holds 8 points, parts 2-7 none
        p = rng.randn(1, 40, 3).astype(np.float32)
        q = rng.randn(1, 25, 3).astype(np.float32)
        k = 16
    else:  # "masked_part": every point of part 0 masked (all of them at w = 1)
        p = rng.randn(1, 300, 3).astype(np.float32)
        q = p[:, :24] + np.float32(1e-3)
        mask = ((np.arange(300) // 32) % w != 0).astype(np.float32)[None]
        k = 16
    return q, p, k, mask


@pytest.mark.parametrize("case", ["tiled", "masked", "short_part", "masked_part"])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
@pytest.mark.parametrize("bound", [False, True], ids=["one_pass", "two_pass"])
def test_knn_part_split_matches_jax(case, w, bound):
    """The part split's neighbours, with and without the bound pass ==
    ``knn_plain`` (indices and distances bit for bit) == ``knn_pallas`` in
    interpret mode (indices; distances within its test's rtol 1e-6: XLA on
    the CPU may contract its sum into FMAs)."""
    q, p, k, mask = _knn_case(case, w)
    got_i, got_d = knn_by_parts(q, p, k, w, mask, bound)
    assert np.isfinite(got_d).all()  # no dropped point among the k nearest
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    ref_i, ref_d = port_knn.knn_plain(t(q), t(p), k, return_dist=True, kv_mask=t(mask))
    np.testing.assert_array_equal(got_i, ref_i.numpy())
    np.testing.assert_array_equal(got_d, ref_d.numpy())
    jax_i, jax_d = knn_pallas(jnp.asarray(q), jnp.asarray(p), k, tile=128, return_dist=True,
                              interpret=True, kv_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got_i, np.asarray(jax_i))
    np.testing.assert_allclose(got_d, np.asarray(jax_d), rtol=1e-6, atol=0)
    if case == "tiled":  # the lowest copy of each tie first
        assert (got_i[0, :20, 0] == np.arange(20)).all()
        assert (got_i[0, :20, :8] == np.arange(20)[:, None] + 50 * np.arange(8)).all()
    if case == "masked_part" and w > 1:  # masked points only after every unmasked one
        part0 = (got_i // 32) % w == 0
        assert not part0[..., :k].any()
