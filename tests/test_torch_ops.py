"""nsdp_tpu_torch ops == nsdp_tpu ops on the CPU, plus the port's hygiene.

The JAX side runs as its own tests run it here: the Pallas kernels in
interpret mode (and the XLA FPS).  The port runs its plain PyTorch versions
(CPU tensors).  ``tests/test_torch_kernels.py`` holds the CUDA kernels
against those plain versions on the card.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsdp_tpu.ops.attention_pallas import fused_vector_attention as jax_attention
from nsdp_tpu.ops.fps import furthest_point_sample_xla
from nsdp_tpu.ops.fps_pallas import furthest_point_sample_pallas
from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops import fps as port_fps
from nsdp_tpu_torch.ops import gather as port_gather
from nsdp_tpu_torch.ops import knn as port_knn
from tests.test_torch_kernels import _attention_case, _clouds, _port_attention

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- FPS


@pytest.mark.parametrize("case", ["random", "origin_skip", "all_invalid"])
def test_fps_matches_jax(case, rng):
    xyz, npoint = _clouds(rng)[case]
    got = port_fps.furthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (xyz.shape[0], npoint)
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint, interpret=True))
    xla = np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    if case == "all_invalid":
        assert not got.numpy().any()


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["pos_only", "table", "proj", "global"])
def test_attention_matches_jax(mode, masked, rng):
    a, w = _attention_case(rng, mode, masked)
    j = lambda x: None if x is None else jnp.asarray(x)
    kw = {key: j(v) for key, v in a.items() if key not in ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a", "k")}
    ref = jax_attention(
        j(a["xyz_q"]), j(a["kv_xyz"]), j(a["q_feats"]), j(a["K_a"]), j(a["V_a"]),
        *[j(x) for x in w], k=a["k"], tile=128, interpret=True, **kw,
    )
    got = _port_attention(a, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_attention_clamps_k_and_validates(rng):
    a, w = _attention_case(rng, "table", False)
    a_small = dict(a, xyz_q=a["xyz_q"][:, :5], kv_xyz=a["kv_xyz"][:, :5],
                   q_feats=a["q_feats"][:, :5], K_a=a["K_a"][:, :5],
                   V_a=a["V_a"][:, :5], k=16)
    assert _port_attention(a_small, w).shape == (2, 5, 12)  # k = min(16, M)
    with pytest.raises(ValueError, match="global token"):
        _port_attention(dict(a, q_feats=None, K_a=None, V_a=None,
                             k_glob=a["q_feats"][:, 0], v_glob=a["q_feats"][:, 0]), w)
    with pytest.raises(ValueError, match="projection mode"):
        _port_attention(dict(a, kv_feats=a["K_a"], wk=w[2], wv=w[2]), w)


def test_mask_penalty_is_finite():
    p = port_attention.mask_penalty(torch.tensor([[1.0, 0.0, 2.0]]))
    assert p.tolist() == [[0.0, np.float32(1e30), 0.0]]


# ---------------------------------------------------------------- hygiene


def _port_sources():
    """The port's modules, and the tests that run on the card, where the
    JAX package is not installed (and the ranks those tests start)."""
    on_card = ("test_torch_kernels.py", "test_torch_graphs.py", "test_torch_card.py",
               "torch_parallel_runner.py")
    return sorted((REPO / "nsdp_tpu_torch").rglob("*.py")) + [REPO / "tests" / n for n in on_card]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    # the JAX package, and the repository's JAX entry points at its root
    banned = ("jax", "jaxlib", "flax", "optax", "joblib", "nsdp_tpu", "bench", "__graft_entry__",
              "scripts")
    sources = _port_sources()
    assert len(sources) > 10 and all(p.exists() for p in sources)
    assert REPO / "nsdp_tpu_torch" / "bench.py" in set(sources)
    assert {REPO / "nsdp_tpu_torch" / "training" / f"{m}.py"
            for m in ("optim", "steps", "checkpoints", "partial_load")} <= set(sources)
    assert {REPO / "nsdp_tpu_torch" / "ops" / f"{m}.py"
            for m in ("knn", "gather", "geometry", "pointnet2_compat")} <= set(sources)
    assert {REPO / "nsdp_tpu_torch" / "data" / f"{m}.py"
            for m in ("__init__", "datasets", "loader", "transforms", "synthetic")} <= set(sources)
    assert {REPO / "nsdp_tpu_torch" / "utils" / f"{m}.py"
            for m in ("meshio", "metrics", "generation", "logger", "visualize")} <= set(sources)
    assert {REPO / "nsdp_tpu_torch" / f"{m}.py" for m in ("test", "run", "train")} <= set(sources)
    assert {REPO / "nsdp_tpu_torch" / m for m in ("training/async_ckpt.py",
                                                  "utils/profiling.py")} <= set(sources)
    assert {REPO / "nsdp_tpu_torch" / "parallel" / f"{m}.py"
            for m in ("__init__", "dist", "multihost")} <= set(sources)
    assert REPO / "nsdp_tpu_torch" / "utils" / "msgpack_reader.py" in set(sources)
    assert {REPO / "nsdp_tpu_torch" / m
            for m in ("native/__init__.py", "meshing.py")} <= set(sources)
    preprocess = {REPO / "nsdp_tpu_torch" / "preprocess" / f"{m}.py"
                  for m in ("__init__", "__main__", "anime", "normalize", "flow", "watertight",
                            "poisson", "pipeline")}
    assert preprocess == set((REPO / "nsdp_tpu_torch" / "preprocess").glob("*.py"))
    assert preprocess <= set(sources)
    offenders = [
        f"{p.relative_to(REPO)}: {mod}"
        for p in sources
        for mod in _imported_modules(p)
        if mod.split(".")[0] in banned
    ]
    assert offenders == []


def test_wrappers_dispatch_on_device(rng):
    """CPU tensors take the plain versions and never count a launch."""
    a, w = _attention_case(rng, "pos_only", False)
    counters = (port_attention.fused_vector_attention, port_fps.furthest_point_sample,
                port_knn.knn, port_gather.gather_rows)
    before = [f.launches for f in counters]
    _port_attention(a, w)
    kv = torch.from_numpy(a["kv_xyz"])
    port_fps.furthest_point_sample(kv, 4)
    idx = port_knn.knn(kv[:, :5], kv, 3)
    port_gather.gather_rows(kv, idx)
    assert [f.launches for f in counters] == before
    with pytest.raises(RuntimeError, match="no FPS kernel"):
        port_fps.furthest_point_sample(torch.zeros(1, 4, 3, device="meta"), 2)


def test_fps_above_the_shared_memory_cloud_matches_jax():
    """A cloud above the kernel's shared-memory size (the card's second
    variant): the port's FPS at N = 15,000 with points at the origin (never
    picked), and a cloud whose first point is at the origin too, index for
    index against the JAX package's XLA FPS."""
    assert port_fps.SMEM_POINTS == 14496
    rng = np.random.RandomState(3)
    xyz = rng.randn(2, 15000, 3).astype(np.float32)
    xyz[0, 100:400] = 0.0
    xyz[1, ::7] = 0.0  # index 0 included
    got = port_fps.furthest_point_sample(torch.from_numpy(xyz), 64)
    ref = np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), 64))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.isin(got.numpy()[0, 1:], np.arange(100, 400)).any()
