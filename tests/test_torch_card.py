"""The port on the card as a whole program: what the kernel and graph tests
do not hold.

Every test here needs a CUDA device and skips without one.  The module
imports nothing of JAX, so it runs where JAX is not installed, with the
other on-card tests:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py \\
        tests/test_torch_graphs.py tests/test_torch_card.py

Held here: the tensor-core instructions in each kernel's SASS; K1's output
bits at the main path's sites (``K1_DIGESTS``) and its narrow mode there,
K1 on a 40,962-vertex mesh; K2 against its plain version in float64 at
the training sites; a checkpoint resumed on the card; ablation A's halves
against the CPU; the entry points ``test``, ``run`` and ``train`` on
small fixtures; ranks sharing the card (two gloo ranks against one
process by halves, in float32 and float64; one NCCL rank, eager and
captured, at the shipped widths); bfloat16 and remat trained on the card
and a bfloat16 evaluation's every attention call.
"""

import contextlib
import copy
import hashlib
import json
import linecache
import os
import re
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch
import yaml

from nsdp_tpu_torch import graphs as port_graphs
from nsdp_tpu_torch import run as port_run
from nsdp_tpu_torch import test as port_test
from nsdp_tpu_torch import train as port_train
from nsdp_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    generate_userhandle_dataset,
    synthetic_config,
)
from nsdp_tpu_torch.graphs import Graphs
from nsdp_tpu_torch.models import build_model, init_random
from nsdp_tpu_torch.nn import blocks
from nsdp_tpu_torch.ops import _build
from nsdp_tpu_torch.ops import attention as port_attention
from nsdp_tpu_torch.ops import fps as port_fps
from nsdp_tpu_torch.training import (
    load_checkpoints,
    make_steps,
    optimizer_factory,
    save_checkpoints,
)
from nsdp_tpu_torch.training.steps import (
    _batch_norms,
    _double_bn_update,
    _snapshot,
    compute_l2_error,
)
from nsdp_tpu_torch.utils import meshio
from tests.test_torch_graphs import (
    _assert_same_state,
    _group,
    _hold_step,
    _state,
    config,
    launch_counters,
    launched_since,
    rel_err,
    replayed,
    shipped_config,
    short_name,
    train_batch,
    STEP_LAUNCHES,
    SERVE_LAUNCHES,
)
from tests.torch_parallel_runner import launch, plain_on_card

K1_TOL = dict(rtol=1e-4, atol=1e-5)
E2E_TOL = dict(rtol=1e-3, atol=2e-4)  # the served outputs' (PERF.md, section 2)
LINES_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_torch_train_cli.py's
# K1's narrow mode against its plain version: the relative L2 gap at most
# this share of the plain narrow version's gap to the plain float32 one
K1_NARROW_SHARE = 0.25
# the narrow mode's kernels on the tensor cores, and the float32 mode's own,
# which a narrow call must not launch (the selection and the broadcast
# query's global logits, knn_kernel and glob_logits_kernel, are shared)
NARROW_KERNELS = ("attn_mma16_kernel", "weight_frags16_kernel")
F32_ONLY_KERNELS = ("attn_kernel", "attn_bcast_kernel", "weights_in_out_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def surface(rng, n: int) -> np.ndarray:
    """A closed blobby surface around the origin (every point is an FPS
    candidate: |p|^2 ~ 1)."""
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta, phi = np.arccos(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    r = 1.0 + 0.25 * np.sin(3 * theta) * np.cos(2 * phi)
    return (v * r[:, None] * np.array([1.0, 0.7, 1.3])).astype(np.float32)


def trainer(cfg, device, seed=0, group=None, graphs=None):
    """(model, schedule, optimizer, steps) of ``cfg`` with seeded weights."""
    model = init_random(build_model(cfg, device=device), seed)
    schedule, opt = optimizer_factory(cfg["training"], model.parameters())
    return model, schedule, opt, make_steps(model, cfg["model"]["type"], opt, device=device,
                                            group=group, graphs=graphs)


# ------------------------------------------------ tensor-core instructions

# each tensor-core kernel (source, name, K1's broadcast engine) by the
# instruction its products must use: K2's row kernel and K1's broadcast
# engine <0, NW, NWG> (where no backward follows) on wgmma (HGMMA), K2's
# weight gradients and K1's narrow mode on mma.sync (HMMA); K1's FFMA
# broadcast engine <RT, 0, 0> on neither
TENSOR_CORE_KERNELS = [
    ("attention_bwd", "bwd_rows_kernel", None, "HGMMA"),
    ("attention_bwd", "wgrad_kernel", None, "HGMMA"),
    ("attention", "attn_mma16_kernel", None, "HMMA"),
    ("attention", "attn_bcast_kernel", "tc", "HGMMA"),
    ("attention", "attn_bcast_kernel", "ffma", None),
]


def bcast_engine(fn: str):
    """``"tc"`` for a tensor-core instantiation of K1's broadcast kernel
    (``attn_bcast_kernel<RT, NW, NWG>``, NW > 0), ``"ffma"`` for an FFMA
    one (NW = 0), None for any other kernel."""
    m = re.fullmatch(r"attn_bcast_kernel<(-?\d+), (-?\d+), (-?\d+)>", fn)
    return None if m is None else "tc" if int(m.group(2)) > 0 else "ffma"


def sass_counts(source):
    """{kernel instantiation: {"HGMMA": n, "HMMA": n}} of the library of
    ``csrc/<source>.cu``, from ``cuobjdump --dump-sass``."""
    _build.build([source])
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = short_name(line.split("Function : ")[1].strip())
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("source,kernel,engine,op", TENSOR_CORE_KERNELS,
                         ids=[f"{k}-{e}" if e else k for _, k, e, _ in TENSOR_CORE_KERNELS])
def test_tensor_core_kernels_carry_their_instructions(source, kernel, engine, op, cuda):
    counts = sass_counts(source)
    found = {fn: n for fn, n in counts.items()
             if fn.split("<")[0] == kernel and bcast_engine(fn) == engine}
    assert found, f"csrc/{source}.cu has no {kernel} ({engine}) among {sorted(counts)}"
    for fn, n in found.items():
        if op is None:
            assert n["HGMMA"] + n["HMMA"] == 0, f"{fn} has tensor-core instructions: {n}"
        else:
            assert n[op] > 0, f"{fn} has no {op} instruction: {n}"


# ------------------------------------------------------- K1 at its sites

# the attention launches of one full evaluation at Q = 65536, then the other
# shapes the served requests give it (a masked request, the 4096 bucket):
# (name, Nq, M, k, D, mode, masked)
K1_SITES = [
    ("bwd_encoder_begin", 5000, 5000, 10, 120, "pos_only", False),
    ("fwd_encoder_begin", 5000, 5000, 10, 120, "featured", False),
    ("set_abstraction_0", 500, 5000, 16, 120, "featured", False),
    ("transformer_downs_0", 500, 500, 16, 120, "featured", False),
    ("set_abstraction_1", 100, 500, 16, 256, "featured", False),
    ("transformer_downs_1", 100, 100, 16, 256, "featured", False),
    ("decoder_queries", 65536, 100, 7, 200, "global", False),
    ("decoder_surface", 5000, 100, 7, 200, "global", False),
    ("bwd_encoder_begin_masked", 5000, 5000, 10, 120, "pos_only", True),
    ("fwd_encoder_begin_masked", 5000, 5000, 10, 120, "featured", True),
    ("set_abstraction_0_masked", 500, 5000, 16, 120, "featured", True),
    ("decoder_queries_4096", 4096, 100, 7, 200, "global", False),
]
# sites where the narrow mode also runs in float16 (D = 256, the largest
# shared memory, and the decoder)
K1_F16_SITES = ("decoder_surface", "set_abstraction_1")

# SHA-256 of K1's output bytes at each site on the inputs of
# ``k1_main_path``, recorded on an NVIDIA H100 80GB HBM3 (700 W), nvcc 12.9,
# PyTorch 2.11.0+cu128: from ``attn_kernel`` at every site but the three
# decoder sites, whose broadcast query takes the broadcast path's
# tensor-core engine (no backward follows here).  Any change to K1 must keep
# every output bit.  Record them again only after a deliberate change to
# K1's arithmetic, or for a new CUDA toolkit (``expf`` and the compiler's
# code may round differently): a failing site prints its new digest.
K1_DIGESTS = {
    "bwd_encoder_begin": "0f813f2e526850b2645e4a4f8b64f53827365780cd70f2a6b678761a47d0906a",
    "fwd_encoder_begin": "89c11eeb11c5efaaaa45b84192774019dc24aafac5a60a537ed269111c5c9fb9",
    "set_abstraction_0": "429d10a264b95cb5f52a149222302bee4a7e998f3727849d2bd02a27b9ea3422",
    "transformer_downs_0": "03f31e72842aeb64e1fae8187710970d622afa2bca4942db9ab4c36d00317ea8",
    "set_abstraction_1": "a6c69f49a02b6f4f8f2913235850ee41ff97afc0433c6091733d492762b73aa6",
    "transformer_downs_1": "4f09aba4f2c94fea3778bc8e47db535c5348afd84d5787b75e143ea5cca4b65a",
    "decoder_queries": "25177285924b90cf6a2b6534160d20b28961b20c537a27adc5a81bfb43258e78",
    "decoder_surface": "feca5302b66dc086a944f3a473078a9b3b383ee6088389a3dff4a9f188597d94",
    "bwd_encoder_begin_masked": "a9a9f25aa2e26c03526915c457edfebb2367e0ba07d36994341b649496e3a6d9",
    "fwd_encoder_begin_masked": "19e1a33006b07a85318415d51bfa0f2c04dbbf2368c0704b076849dac1cb6cd7",
    "set_abstraction_0_masked": "14f6bd24d40db98eae96a69fa85132afadd66dff2f2dd4603535153f1840fbb5",
    "decoder_queries_4096": "b223ffcf4d8d7c78b5192a11bf6af32b00e9a26c1fec2be48182608e428a113c",
}


def clouds_of(points, device):
    """``points`` (N, 3), the indices of its 500 FPS centres and of their
    100 (by K3 on ``device``): the clouds of the encoders' levels."""
    fps = lambda x, n: port_fps.furthest_point_sample(
        torch.as_tensor(x[None], device=device), n)[0].cpu().numpy()
    fps_500 = fps(points, 500)
    return points, fps_500, fps(points[fps_500], 100)


def k1_draw(rng, clouds, site, B=1):
    """The attention's numpy arguments at ``site``: the main path's clouds
    (the same cloud in every batch item), random features and weights
    drawn from ``rng``."""
    name, nq, m, k, d, mode, masked = site
    surf, fps_500, fps_100 = clouds
    rep = lambda x: np.repeat(np.asarray(x, np.float32)[None], B, axis=0)
    cloud = {len(surf): surf, 500: surf[fps_500], 100: surf[fps_500][fps_100]}
    kv = cloud[m]
    if name.startswith("set_abstraction"):
        xyz_q, kv = -cloud[nq], -kv  # FPS centres; the set abstraction negates both sets
    elif mode == "global":
        xyz_q = rng.uniform(-1.3, 1.3, (nq, 3)) if nq != 5000 else surf
    else:
        xyz_q = kv
    w = [rng.randn(3, d) * 0.5, rng.randn(d) * 0.1, rng.randn(d, d) / np.sqrt(d),
         rng.randn(d) * 0.1, rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1,
         rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1]
    a = dict(xyz_q=rep(xyz_q), kv_xyz=rep(kv), weights=w, k=k)
    if mode != "pos_only":
        a["K_a"], a["V_a"] = rng.randn(B, m, d), rng.randn(B, m, d)
        # the decoder's query is one broadcast row
        a["q_feats"] = rng.randn(B, 1 if mode == "global" else nq, d)
        if mode == "global":
            a["k_glob"], a["v_glob"] = rng.randn(B, d), rng.randn(B, d)
    if masked:
        a["kv_mask"] = np.ones((B, m))
        a["kv_mask"][:, -m // 10:] = 0.0
    return a


def k1_args(a, device):
    """``k1_draw``'s arguments in float32 on ``device``: the weights as the
    modules pass them (transposed views of nn.Linear's (out, in) weights),
    a broadcast query expanded -> (positional arguments, keywords)."""
    t = lambda x: None if x is None else torch.as_tensor(np.asarray(x, np.float32), device=device)
    q = t(a.get("q_feats"))
    if q is not None and q.shape[1] == 1:
        q = q.expand(-1, a["xyz_q"].shape[1], -1)
    weights = [t(x.T).t() if x.ndim == 2 else t(x) for x in a["weights"]]
    pos = (t(a["xyz_q"]), t(a["kv_xyz"]), q, t(a.get("K_a")), t(a.get("V_a")), *weights)
    kw = {key: t(a[key]) for key in ("k_glob", "v_glob", "kv_mask") if key in a}
    return pos, dict(kw, k=a["k"])


def k1_plain(pos, kw, compute_dtype=None):
    penalty = port_attention.mask_penalty(kw["kv_mask"]) if "kv_mask" in kw else None
    return port_attention.fused_vector_attention_plain(
        *pos, kw["k"], kw.get("k_glob"), kw.get("v_glob"), penalty, compute_dtype=compute_dtype)


@pytest.fixture(scope="module")
def k1_main_path():
    """{site: ``k1_draw``'s arguments} in the order of ``K1_SITES``, all
    drawn from one ``RandomState(0)`` after the surface, as the digests
    were recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.RandomState(0)
    clouds = clouds_of(surface(rng, 5000), "cuda")
    return {site[0]: k1_draw(rng, clouds, site) for site in K1_SITES}


@pytest.mark.gpu
@pytest.mark.parametrize("site", [s[0] for s in K1_SITES])
def test_k1_keeps_its_output_bits(site, cuda, k1_main_path):
    """K1 at each site of the main path within ``K1_TOL`` of its plain
    version, and bit for bit its recorded output (``K1_DIGESTS``)."""
    pos, kw = k1_args(k1_main_path[site], cuda)
    with torch.inference_mode():
        got = port_attention.fused_vector_attention(*pos, **kw)
        torch.testing.assert_close(got, k1_plain(pos, kw), **K1_TOL)
    sha = hashlib.sha256(got.contiguous().cpu().numpy().tobytes()).hexdigest()
    assert sha == K1_DIGESTS[site], f"a bit of K1's output moved; DIGESTS {site}: {sha}"


# K1 where an encoder conditions on every vertex of a 40,962-vertex mesh
# (``run`` on a user-handle config): the begin blocks at N = M, and the
# first set abstraction from 500 FPS centres
MESH_K1_SITES = [
    ("bwd_encoder_begin", 40962, 40962, 10, 120, "pos_only", False),
    ("fwd_encoder_begin", 40962, 40962, 10, 120, "featured", False),
    ("set_abstraction_0", 500, 40962, 16, 120, "featured", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("site", MESH_K1_SITES, ids=[s[0] for s in MESH_K1_SITES])
def test_k1_on_a_mesh_of_40962_vertices(site, cuda, tmp_path):
    """K1 within ``K1_TOL`` of its plain version on the vertices of
    ``generate_userhandle_dataset``'s 40,962-vertex mesh."""
    fx = generate_userhandle_dataset(str(tmp_path), subdivisions=6)
    verts = meshio.load_mesh(os.path.join(fx["dataset_dir"], "cat0", "0000",
                                          "model_normalized.obj"))[0]
    pos, kw = k1_args(k1_draw(np.random.RandomState(5), clouds_of(verts, cuda), site), cuda)
    with torch.inference_mode():
        torch.testing.assert_close(port_attention.fused_vector_attention(*pos, **kw),
                                   k1_plain(pos, kw), **K1_TOL)


def device_kernels(fn):
    """The names of the CUDA kernels ``torch.profiler`` records over
    ``fn()``, without return type, namespaces and template arguments; a
    session that delivers no device activity runs ``fn`` again (three
    times at most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
                 .split("::")[-1].replace("void ", "").strip()
                 for e in prof.events() if e.device_type == DeviceType.CUDA}
        if names:
            return names
    pytest.fail("the profiler recorded no device activity")


@pytest.mark.gpu
@pytest.mark.parametrize("site,dtype", [(s[0], torch.bfloat16) for s in K1_SITES]
                         + [(s, torch.float16) for s in K1_F16_SITES])
def test_k1_narrow_mode_at_the_sites(site, dtype, cuda, k1_main_path):
    """K1's narrow mode (``compute_dtype``) on the same arguments: one
    narrow launch, a relative L2 gap to the plain narrow version at most
    ``K1_NARROW_SHARE`` of that version's gap to the plain float32 one,
    and its device time only in the tensor-core kernels, none of the
    float32 mode's own."""
    pos, kw = k1_args(k1_main_path[site], cuda)
    run = lambda: port_attention.fused_vector_attention(*pos, **kw, compute_dtype=dtype)
    with torch.inference_mode():
        before = port_attention.fused_vector_attention.narrow_launches
        got = run()
        assert port_attention.fused_vector_attention.narrow_launches == before + 1
        ref = k1_plain(pos, kw, dtype)
        gap, err = rel_err(ref, k1_plain(pos, kw)), rel_err(got, ref)
        assert gap > 0 and err <= K1_NARROW_SHARE * gap, (err, gap)
        names = device_kernels(run)
    assert set(NARROW_KERNELS) <= names and not names & set(F32_ONLY_KERNELS), names


# ------------------------------------------------- K2 at the training sites

# the attention's backward at every site of the main path but the served
# 65,536-query decoder: the training sites (the stage-1 nets run the same
# shapes) and a few served ones
K2_SITES = [site for site in K1_SITES if site[0] != "decoder_queries"]
K2_GRADS = ("xyz_q", "kv_xyz", "q_feats", "K_a", "V_a", "delta_w0", "delta_b0", "delta_w1",
            "delta_b1", "gamma_w0", "gamma_b0", "gamma_w1", "gamma_b1", "k_glob", "v_glob")


def hold_gradient(what, card, f32, f64, partner_f64=None, factor=2.0, floor=1e-6):
    """One result from the card against the plain path's float32 and
    float64 ones: its relative L2 error against float64 at most ``factor``
    times the float32 path's, never required below ``floor``.  A gradient
    that vanishes analytically -- a bias cancelled by the slot softmax
    (``gamma_b1``) or by a train-mode BatchNorm right after it -- is
    rounding noise in float32 and ~0 in float64 (at most 1e-9 of its
    weight's gradient, ``partner_f64``): it is held absolutely, at most
    1e-4 of that scale."""
    if partner_f64 is not None:
        scale = float(partner_f64.abs().max())
        if float(f64.abs().max()) <= 1e-9 * scale:
            assert float(card.abs().max()) <= 1e-4 * scale, what
            return
    err, err_f32 = rel_err(card, f64), rel_err(f32, f64)
    assert err <= max(factor * err_f32, floor), f"{what}: {err:.3g} against float32's {err_f32:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("site", K2_SITES, ids=[s[0] for s in K2_SITES])
def test_k2_against_float64_at_the_training_sites(site, cuda):
    """K2 at batch 2 on the main path's clouds (``K2_SITES``): each gradient within twice
    the float32 plain version's relative L2 error against the plain version
    in float64 on the card (floor 1e-6); ``gamma_b1``'s absolutely."""
    rng = np.random.RandomState(1)
    pos, kw = k1_args(k1_draw(rng, clouds_of(surface(rng, 5000), cuda), site, B=2), cuda)
    ops = (*pos, kw.get("k_glob"), kw.get("v_glob"))
    penalty = port_attention.mask_penalty(kw["kv_mask"]) if "kv_mask" in kw else None
    idx = port_attention._launch(*ops[:13], kw["k"], ops[13], ops[14], penalty)[1]
    g = torch.as_tensor(rng.randn(2, site[1], site[4]).astype(np.float32), device=cuda)
    got = port_attention.fused_vector_attention_backward(*ops, idx, g)
    f32 = port_attention.fused_vector_attention_bwd_plain(*ops, idx, g)
    f64 = port_attention.fused_vector_attention_bwd_plain(
        *[None if t is None else t.double() for t in ops], idx, g.double())
    for name, x, y, z in zip(K2_GRADS, got, f32, f64):
        if x is not None:
            partner = f64[K2_GRADS.index("gamma_w1")] if name == "gamma_b1" else None
            hold_gradient(f"d {name}", x, y, z, partner)


# ------------------------------------------------------------ training


@pytest.mark.gpu
def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """The shipped stage-2 model after captured steps, saved and loaded
    into a fresh model: its state bit for bit, and the next loss within
    1e-6 relative of the captured model's."""
    cfg = shipped_config("arbitrary")
    rng = np.random.RandomState(3)
    model, schedule, opt, steps = trainer(cfg, cuda)
    lr = schedule.get_learning_rate(0)
    for _ in range(3):  # the eager first step, the capture, a replay
        steps["train_step"](train_batch(rng, 2, 5000, 5000), lr)
    save_checkpoints(4, model, opt, str(tmp_path))
    model2, _, opt2, steps2 = trainer(cfg, cuda, seed=1)
    assert load_checkpoints(model2, opt2, str(tmp_path)) == 5
    for (k, v), v2 in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(v, v2), k
    batch = train_batch(rng, 2, 5000, 5000)
    l1, l2 = steps["train_step"](batch, lr), steps2["train_step"](batch, lr)
    assert abs(l1 - l2) <= 1e-6 * abs(l1)


def hold_against_cpu(what, card, f32, f64):
    """A served output of the card against the plain path on the CPU in
    float32 and float64: within ``E2E_TOL`` of float32 or, where the
    float32 path itself errs beyond that against float64 (random weights
    amplify rounding by the output's scale), a largest absolute error
    against float64 at most twice float32's; and a relative L2 error
    against float64 at most twice float32's (floor 1e-6)."""
    worst, worst_f32 = [float((x.double() - f64).abs().max()) for x in (card, f32)]
    assert torch.allclose(card, f32, **E2E_TOL) or worst <= 2 * worst_f32, what
    assert rel_err(card, f64) <= max(2 * rel_err(f32, f64), 1e-6), what


@pytest.mark.gpu
def test_ablation_a_halves_against_the_cpu(cuda):
    """Configuration A at its published widths with seeded weights: the
    card's canonicalize and deform halves against the plain path on the
    CPU, on the same inputs (the deform half on the card's canonical pose,
    so every FPS and kNN selection sees the same coordinates), by
    :func:`hold_against_cpu`; then a tiny A's predict within ``E2E_TOL``."""
    cfg = shipped_config("A")
    card = init_random(build_model(cfg, device=cuda), 0)
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu, cpu64 = build_model(cfg, device="cpu"), build_model(cfg, device="cpu").double()
    cpu.load_state_dict(state)
    cpu64.load_state_dict(state)
    rng = np.random.RandomState(4)
    surf = surface(rng, 5000)[None]
    pts = rng.uniform(-1.3, 1.3, (1, 1024, 3)).astype(np.float32)
    handle = (surf[..., 2:] > 0.8).astype(np.float32)
    tgt = (surf + np.float32(0.2)) * handle
    g, c = (lambda a: torch.as_tensor(a, device=cuda)), torch.as_tensor
    c64 = lambda a: torch.as_tensor(a).double()
    with torch.inference_mode():
        sc_g, su_g = card.canonicalize(g(pts), g(surf))
        sc, su = sc_g.cpu(), su_g.cpu()
        f32, f64 = cpu.canonicalize(c(pts), c(surf)), cpu64.canonicalize(c64(pts), c64(surf))
        hold_against_cpu("space_cano", sc, f32[0], f64[0])
        hold_against_cpu("surf_cano", su, f32[1], f64[1])
        hold_against_cpu("deform", card.deform(sc_g, su_g, g(tgt), g(handle)).cpu(),
                         cpu.deform(sc, su, c(tgt), c(handle)),
                         cpu64.deform(sc.double(), su.double(), c64(tgt), c64(handle)))
        tiny = config(encoder="pointnet++")
        small_g, small_c = (init_random(build_model(tiny, device=d), 1) for d in (cuda, "cpu"))
        inp = np.concatenate([surface(rng, 32), rng.randn(32, 4)], -1).astype(np.float32)[None]
        q = rng.randn(1, 50, 3).astype(np.float32)
        torch.testing.assert_close(small_g.predict(g(q), g(inp)).cpu(),
                                   small_c.predict(c(q), c(inp)), **E2E_TOL)


# ----------------------------------------------------------- entry points


def write_config(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def weight_file(cfg, directory):
    """A model file with seeded weights whose deformed positions are O(1)
    (``out_scale``), as a trained model's."""
    directory.mkdir(parents=True, exist_ok=True)
    model = init_random(build_model(cfg, device="cpu"), 3, out_scale=0.01)
    _, opt = optimizer_factory(cfg["training"], model.parameters())
    save_checkpoints(0, model, opt, str(directory))
    return str(directory / "model_00000")


def progress(path):
    """(epoch, batch, {name: value}) of every progress line of a run's
    ``.txt``, but the wall-clock ``steps_per_sec``."""
    out = []
    with open(path) as f:
        for line in f:
            m = re.match(r"epoch: (-?\d+) - batch: (\d+) - (.*)$", line.strip())
            if m:
                values = dict(kv.split(": ") for kv in m.group(3).split(" - "))
                out.append((int(m.group(1)), int(m.group(2)), {
                    k: float(v) for k, v in values.items() if k != "steps_per_sec"}))
    return out


def same_progress(got, want):
    """Two runs' progress lines: the same epochs, batches and names, the
    values within ``LINES_TOL``."""
    assert [line[:2] for line in got] == [line[:2] for line in want] and got
    for (_, _, x), (_, _, y) in zip(got, want):
        assert sorted(x) == sorted(y)
        np.testing.assert_allclose([x[k] for k in y], list(y.values()), **LINES_TOL)


def same_outputs(card_dir, cpu_dir):
    """The card's experiment directory against the CPU's: the same files;
    progress lines within ``LINES_TOL``, deformed meshes and point clouds
    within ``E2E_TOL``, every other file byte for byte -> the number of
    deformed files."""
    files = [sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                    for f in fs) for root in (card_dir, cpu_dir)]
    assert files[0] == files[1]
    deformed = 0
    for rel in files[0]:
        a, b = os.path.join(card_dir, rel), os.path.join(cpu_dir, rel)
        if rel.endswith(".txt"):
            same_progress(progress(a), progress(b))
        elif os.sep + "deformed" + os.sep in rel:
            got, want = meshio.load_mesh(a)[0], meshio.load_mesh(b)[0]
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, **E2E_TOL, err_msg=rel)
            deformed += 1
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return deformed


def run_on_both(cli, cfg, root, argv=()):
    """``cli.main`` on the card (its default device) and on the CPU, each
    from the same draws of ``np.random`` -> (card, CPU) experiment
    directories."""
    dirs = []
    for device in ("cuda", "cpu"):
        cfg["experiment"]["out_dir"] = str(root / device)
        np.random.seed(7)  # the datasets draw from the global stream
        cli.main([write_config(cfg, root / f"{device}.yaml"), "--matmul_precision", "highest",
                  *argv, *(["--device", "cpu"] if device == "cpu" else [])])
        dirs.append(os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"]))
    return dirs


@pytest.mark.gpu
def test_evaluation_entry_points_on_the_card(cuda, tmp_path):
    """``python -m nsdp_tpu_torch.test`` and ``run`` on the card against
    the same runs on the CPU, from one weight file on small fixtures."""
    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=1, n_frames=3, n_surface=200,
                                    n_space=200)
    cfg = synthetic_config(fx)
    cfg["test"]["weight_file"] = weight_file(cfg, tmp_path / "test")
    assert same_outputs(*run_on_both(port_test, cfg, tmp_path / "test")) == 4
    uh = generate_userhandle_dataset(str(tmp_path / "mesh"))
    cfg = synthetic_config(uh, model_type="arbitrary", arbitrary=True)
    cfg["data"].update(type="tosca", mesh_file="model_normalized.obj", userhandle=dict(
        cliptail=False, head=True, tail=False, frontleftfoot=False, frontrightfoot=False,
        behindleftfoot=False, behindrightfoot=False, xtrans=-0.15, ytrans=-0.2, ztrans=-0.2))
    cfg["test"].update(iden_split="identity_unseen", motion_split="test_unseen_identities",
                       generate_pointcloud=False, weight_file=weight_file(cfg, tmp_path / "run"))
    assert same_outputs(*run_on_both(port_run, cfg, tmp_path / "run")) == 1


def run_files(directory):
    """The files of a run, ``modelbest_*`` without its loss."""
    return sorted(re.sub(r"^(modelbest_\d{5})_.*$", r"\1", f) for f in os.listdir(directory))


@contextlib.contextmanager
def caught_syncs():
    """-> the list that collects, as ``file:line``, every synchronising CUDA
    call made inside (``torch.cuda.set_sync_debug_mode("warn")``), but the
    training loop's one sanctioned synchronisation: the late read of the
    previous step's loss (``float(loss)`` in ``train.py``)."""
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs += [f"{w.filename}:{w.lineno}" for w in caught
              if "called a synchronizing" in str(w.message)
              and not (w.filename.endswith(os.path.join("nsdp_tpu_torch", "train.py"))
                       and "float(loss)" in linecache.getline(w.filename, w.lineno))]


def sync_recording(make_steps, record):
    """``make_steps`` whose train step collects in ``record["syncs"]``
    (:func:`caught_syncs`) the synchronising calls from the end of its
    second call (the capture) to the end of its third: the loader, the
    batch's upload and a whole replayed step."""
    def make(*args, **kwargs):
        steps = make_steps(*args, **kwargs)
        train = steps["train_step"]

        def train_step(batch, lr, fetch=True):
            loss = train(batch, lr, fetch)
            record["steps"] += 1
            if record["steps"] == 2:
                record["window"] = caught_syncs()
                record["syncs"] = record["window"].__enter__()
            elif record["steps"] == 3:
                record["window"].__exit__(None, None, None)
            return loss

        train_step.graphs = train.graphs
        steps["train_step"] = train_step
        return steps

    return make


@pytest.mark.gpu
def test_training_entry_point_on_the_card(cuda, tmp_path, monkeypatch):
    """``python -m nsdp_tpu_torch.train`` on the card: stage 1 against the
    same run on the CPU from one weight file (4 steps and 4 validation
    batches: the progress lines within ``LINES_TOL``, the same files); a
    backward net; stage 2 from both nets' files, no synchronising call
    over a replayed step and the loader's work before it
    (:func:`sync_recording`); then stage 2 resumed to a third epoch."""
    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=2, n_frames=4, n_surface=200,
                                    n_space=200)
    argv = ["--seed", "0", "--num_workers", "0"]
    names = ["model_00000", "model_00001", "modelbest_00001", "opt_00000", "opt_00001",
             "params.json", "stats.txt"]
    cfg = synthetic_config(fx)
    cfg["training"].update(num_sampled_pairs=4,
                           weight_file=weight_file(cfg, tmp_path / "forward"))
    card_dir, cpu_dir = run_on_both(port_train, cfg, tmp_path / "forward", argv)
    assert run_files(card_dir) == run_files(cpu_dir) == names
    lines = [progress(os.path.join(d, "stats.txt")) for d in (card_dir, cpu_dir)]
    assert len(lines[0]) == 8
    same_progress(*lines)
    last = {"forward": os.path.join(card_dir, "model_00001")}
    cfg = synthetic_config(fx, model_type="backward")
    cfg["experiment"]["out_dir"] = str(tmp_path / "backward")
    port_train.main([write_config(cfg, tmp_path / "backward.yaml"), *argv])
    last["backward"] = str(tmp_path / "backward" / cfg["experiment"]["name"] / "model_00001")
    cfg = synthetic_config(fx, model_type="arbitrary", arbitrary=True)
    cfg["experiment"]["out_dir"] = str(tmp_path / "stage2")
    cfg["training"].update(num_sampled_pairs=6, weight_forward_file=last["forward"],
                           weight_backward_file=last["backward"])
    directory = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    record = {"steps": 0}
    monkeypatch.setattr(port_train, "make_steps", sync_recording(port_train.make_steps, record))
    for epochs in (2, 3):
        cfg["training"]["epochs"] = epochs
        port_train.main([write_config(cfg, tmp_path / f"stage2_{epochs}.yaml"), *argv])
        if epochs == 2:
            assert record["syncs"] == [] and record["steps"] == 6
        lines = progress(os.path.join(directory, "stats.txt"))
        assert {e for e, _, _ in lines if e > 0} == ({1, 2} if epochs == 2 else {3})
        assert np.isfinite([v["loss"] for _, _, v in lines]).all()
    assert "model_00002" in os.listdir(directory)


# ---------------------------------------------------- ranks on the card


def stage2_step_by_halves(model, batch, dtype, cano, cot):
    """One stage-2 train step's gradients and running statistics, computed
    as the train step does but cut at the canonical pose
    (``FlowArbitrary.canonicalize`` / ``deform``): the deform half runs on
    the given canonicalised points ``cano``, and the canonicalize half's
    backward is seeded with the given cotangents ``cot``, so that every FPS
    and kNN selection sees the same coordinates on every path -> (loss,
    its own canonicalised points, the gradients at ``cano``)."""
    device = next(model.parameters()).device
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    inputs = t(batch["surface_samples_inputs"])
    model.train()
    model.zero_grad(set_to_none=True)
    bns = _batch_norms(model.model_canonicalize.encoder)
    saved = _snapshot(bns)
    space_cano, surf_cano = model.canonicalize(t(batch["space_samples_src"]), inputs[..., 0:3])
    sc, su = [t(c).detach().requires_grad_() for c in cano]
    pred = model.deform(sc, su, inputs[..., 3:6], inputs[..., 6:7])
    loss = compute_l2_error(pred, t(batch["space_samples_tgt"]))
    loss.backward()
    torch.autograd.backward([space_cano, surf_cano], [t(c) for c in cot])
    _double_bn_update(bns, saved)  # the compound EMA of the stage-2 step
    return float(loss.detach()), (space_cano.detach(), surf_cano.detach()), (sc.grad, su.grad)


def one_process_step(cuda, dtype, cano, cot):
    """The ranks' first step taken by one process on the card, from the
    same weights on the whole batch, by halves on the ranks' canonicalised
    points and their gradients (float64 through the plain path) -> its
    loss, its own canonicalised points, its gradients at the ranks', and
    its gradients and buffers keyed as the runner keys them."""
    model = init_random(build_model(shipped_config("arbitrary"), device=cuda), 2,
                        out_scale=0.01).to(dtype)
    batch = train_batch(np.random.RandomState(7), 8, 5000, 5000)
    with plain_on_card() if dtype == torch.float64 else contextlib.nullcontext():
        loss, own, grads = stage2_step_by_halves(model, batch, dtype, cano, cot)
    out = {f"grad/{k}": (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
           for k, p in model.named_parameters()}
    out.update({f"buffer/{k}": b.cpu() for k, b in model.named_buffers()})
    return dict(out, loss=loss, cano=[c.cpu() for c in own], cot=[g.cpu() for g in grads])


def gloo_ranks(tmp_path, dtype, launches, argv=(), timeout=600):
    """Two gloo ranks on the one card (``torch_parallel_runner card``), two
    stage-2 steps of the shipped model (B = 8, 4 rows a rank) in ``dtype``:
    each step launching ``launches`` K1 / K2 / K3 on each rank, the losses
    finite, and the ranks' losses, parameters, gradients, Adam state and
    buffers bit for bit equal after each step -> (the ranks' outputs, rank
    0's loss and state after the first step, the whole batch's
    canonicalised points and their gradients there)."""
    outs = launch("card", tmp_path, 2, [dtype, *argv], timeout=timeout)
    ranks = [torch.load(tmp_path / f"card{r}.pt", weights_only=False) for r in range(2)]
    for state in ranks:
        assert state["launches"] == [launches] * 2
        assert np.isfinite(state["losses"]).all()
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for step in ("step1", "step2"):
        assert sorted(ranks[0][step]) == sorted(ranks[1][step])
        for key in ranks[0][step]:
            if key not in ("cano", "cot"):
                assert torch.equal(ranks[0][step][key], ranks[1][step][key]), (step, key)
    # the ranks' canonicalised points make the whole batch's; a rank's
    # gradient there is that of the ranks' summed loss, one process's that
    # of their mean
    cano = [torch.cat([r["step1"]["cano"][i] for r in ranks]) for i in (0, 1)]
    cot = [torch.cat([r["step1"]["cot"][i] for r in ranks]) / 2 for i in (0, 1)]
    return outs, ranks[0]["losses"][0], ranks[0]["step1"], cano, cot


def running_stats(state):
    return [k for k in state if k.startswith("buffer/") and k.endswith(("running_mean",
                                                                         "running_var"))]


@pytest.mark.gpu
def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card (:func:`gloo_ranks`, float32 through
    the kernels).  After the first step, by halves cut at the canonical
    pose against one process on the card in float32 and the plain path in
    float64 (:func:`one_process_step`): the loss within 1e-4 relative;
    the canonicalised points, their gradients, every gradient and running
    statistic within 4 times float32's relative error against float64
    (floor 1e-4; a vanishing bias absolutely, :func:`hold_gradient`).
    Then ``python -m nsdp_tpu_torch.train`` on their group: both ranks
    print the same losses, and rank 0 alone writes the files, its progress
    lines once."""
    fx = generate_synthetic_dataset(str(tmp_path / "data"), n_identities=1,
                                    n_motions_per_identity=1, n_frames=5, n_surface=200,
                                    n_space=200)
    cfg = synthetic_config(fx)
    cfg["experiment"]["out_dir"] = str(tmp_path / "out")
    path = write_config(cfg, tmp_path / "cfg.yaml")
    outs, loss, got, cano, cot = gloo_ranks(
        tmp_path, "float32", STEP_LAUNCHES["arbitrary"][:3],
        [path, "--device", "cuda:0", "--seed", "0", "--num_workers", "0"], timeout=900)
    f32, f64 = (one_process_step(cuda, dtype, cano, cot) for dtype in (torch.float32,
                                                                        torch.float64))
    assert abs(loss - f32["loss"]) <= 1e-4 * abs(f32["loss"])
    rule = dict(factor=4.0, floor=1e-4)
    for i, what in enumerate(("space_cano", "surf_cano")):
        hold_gradient(what, cano[i], f32["cano"][i], f64["cano"][i], **rule)
        hold_gradient(f"d {what}", cot[i], f32["cot"][i], f64["cot"][i], **rule)
    grads = [k for k in got if k.startswith("grad/")]
    assert grads and sorted(grads) == sorted(k for k in f32 if k.startswith("grad/"))
    for key in grads:
        partner = f64.get(key[:-4] + "weight") if key.endswith(".bias") else None
        hold_gradient(key, got[key], f32[key], f64[key], partner, **rule)
    for key in running_stats(got):
        hold_gradient(key, got[key], f32[key], f64[key], **rule)

    printed = [[line for line in out.splitlines() if re.match(r"epoch: -?\d+ - batch", line)]
               for out in outs]
    losses = [re.findall(r" - loss: (\S+)", "\n".join(p)) for p in printed]
    assert losses[0] and losses[0] == losses[1]
    directory = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    with open(os.path.join(directory, "stats.txt")) as f:
        assert [line.strip() for line in f if line.startswith("epoch")] == printed[0]
    writes = [json.loads((tmp_path / f"writes{r}.json").read_text()) for r in range(2)]
    assert writes == [{"params": 1, "save": 2, "save_best": 1},
                      {"params": 0, "save": 0, "save_best": 0}]


@pytest.mark.gpu
def test_two_gloo_ranks_in_float64_equal_one_process_on_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card in float64 through the plain path
    (:func:`gloo_ranks`, no kernel launched) against one process from the
    same weights, by halves at the canonical pose: the canonicalised
    points, their gradients, every gradient and running statistic within
    1e-9 of its scale (a bias's scale includes its weight's gradient)."""
    _, loss, got, cano, cot = gloo_ranks(tmp_path, "float64", (0, 0, 0))
    one = one_process_step(cuda, torch.float64, cano, cot)
    assert abs(loss - one["loss"]) <= 1e-9 * abs(one["loss"])
    held = [(f"{what}{i}", x[i], one[what][i]) for what, x in (("cano", cano), ("cot", cot))
            for i in (0, 1)]
    held += [(key, got[key], one[key]) for key in got
             if key.startswith("grad/") or key in running_stats(got)]
    for key, x, want in held:
        scale = float(want.abs().max())
        if key.startswith("grad/") and key.endswith(".bias") and key[:-4] + "weight" in one:
            scale = max(scale, float(one[key[:-4] + "weight"].abs().max()))
        assert float((x - want).abs().max()) <= 1e-9 * max(scale, 1e-30), key


@contextlib.contextmanager
def k2_tape(tape, replay):
    """K2's calls recorded into ``tape`` as (inputs, outputs); with
    ``replay`` K2 still runs, its inputs and outputs are recorded as
    ``tape["replayed"]``, and the recorded outputs are returned in order:
    K2 scatters some gradients by float64 atomics in no fixed order, so a
    run replayed from the tape can be held bit for bit against the
    recorded one."""
    real = port_attention.fused_vector_attention_backward

    def taped(*args):
        out = real(*args)
        if not replay:
            tape["recorded"].append((args, out))
            return out
        tape["replayed"].append((args, out))
        return tape["recorded"][len(tape["replayed"]) - 1][1]

    taped.launches = real.launches  # the wrapper counts on its module's name
    port_attention.fused_vector_attention_backward = taped
    try:
        yield
    finally:
        port_attention.fused_vector_attention_backward = real
        real.launches = taped.launches


def no_syncs(fn):
    """``fn()``, which may not synchronise with the card
    (:func:`caught_syncs`)."""
    with caught_syncs() as syncs:
        out = fn()
    assert not syncs, syncs
    return out


def capture_stress(group, device, n=20):
    """``n`` captures, each of a program with all-reduces that stays open
    ~30 ms, each begun right after 50 eager all-reduces that nothing waits
    for (landing at several phases of ProcessGroupNCCL's watchdog loop), in
    ``torch.cuda.graph``'s default ``"global"`` capture mode, in which a
    CUDA call of another thread that is unsafe during a capture breaks it:
    none may break, and each replay equals the eager run."""
    import time

    x = torch.randn(256, 256, device=device)

    def program(x):
        y = x
        for i in range(600):
            y = torch.tanh(y * 1.0001)
            if i % 50 == 0:
                v = y.sum(0)
                torch.distributed.all_reduce(v, group=group)
                y = y + v * 1e-6
        return y

    graphs = Graphs(device)
    for i in range(n):
        for _ in range(50):
            torch.distributed.all_reduce(torch.ones(1000, device=device), group=group)
        assert torch.equal(graphs(f"stress {i}", program, x).clone(), program(x)), i
        time.sleep(0.05 * (i % 4))


@pytest.mark.gpu
def test_nccl_rank_eager_equals_no_group_on_the_card(cuda):
    """One NCCL rank, eager (``graphs=False``): two stage-2 steps of the
    shipped model (B = 8) bit for bit the steps without a group -- loss,
    parameters, gradients, Adam state, buffers -- with K2's outputs of the
    step without a group replayed into the grouped one and K2's inputs
    held bit for bit; no synchronising call from the end of the first
    grouped step to the end of the second; then :func:`capture_stress`.
    Weights of seed 2, whose canonicalised clouds keep FPS from repeating
    indices, so the gathers' backward adds in a fixed order."""
    cfg = shipped_config("arbitrary")
    rng = np.random.RandomState(7)
    # the batches go up first, as the training entry point uploads them
    batches = [{k: torch.as_tensor(v, device=cuda) for k, v in train_batch(rng, 8, 5000, 5000)
                .items()} for _ in range(2)]
    with _group("nccl", cuda) as group:
        (model_g, schedule, opt_g, steps_g), (model_n, _, opt_n, steps_n) = (
            trainer(cfg, cuda, seed=2, group=g, graphs=False) for g in (group, None))
        lr = schedule.get_learning_rate(0)
        for i, batch in enumerate(batches):
            tape = {"recorded": [], "replayed": []}
            with k2_tape(tape, replay=False):
                want = steps_n["train_step"](batch, lr, fetch=False)
            with k2_tape(tape, replay=True):
                step = lambda: steps_g["train_step"](batch, lr, fetch=False)
                got = no_syncs(step) if i else step()
            assert len(tape["recorded"]) == len(tape["replayed"]) > 0
            for (args0, _), (args1, _) in zip(tape["recorded"], tape["replayed"]):
                for x, y in zip(args0, args1):
                    assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            assert torch.equal(got, want)
            _assert_same_state(_state(model_g, opt_g), _state(model_n, opt_n))
        capture_stress(group, cuda)


@pytest.mark.gpu
def test_nccl_rank_replays_the_shipped_step_on_the_card(cuda, monkeypatch, tmp_path):
    """One NCCL rank, captured (``make_steps``' default under NCCL, the
    all-reduces inside the graph), at the shipped model's widths (B = 8,
    N = Q = 5000), beside the step captured without a group: each one's
    eager first step and its capture launch one step's kernels
    (``STEP_LAUNCHES``).  From the grouped step's state, a replayed step
    against the eager grouped step and against the replayed step without a
    group (:func:`_hold_step`, each with the eager step without a group as
    the second eager one), each replay's graph holding one step's kernel
    nodes; then no synchronising call from the end of one replayed grouped
    step to the end of the next."""
    monkeypatch.setattr(port_graphs, "KEEP_GRAPHS", True)
    cfg = shipped_config("arbitrary")
    rng = np.random.RandomState(7)
    b1, b2 = [{k: torch.as_tensor(v, device=cuda) for k, v in train_batch(rng, 8, 5000, 5000)
               .items()} for _ in range(2)]
    with _group("nccl", cuda) as group:
        runs = {key: trainer(cfg, cuda, seed=2, group=group if grouped else None, graphs=graphs)
                for key, grouped, graphs in (("captured grouped", True, None),
                                             ("captured", False, None),
                                             ("eager grouped", True, False),
                                             ("eager", False, False))}
        lr = runs["eager"][1].get_learning_rate(0)
        for key in ("captured grouped", "captured"):
            steps = runs[key][3]
            assert steps["train_step"].graphs is not None, key
            for batch in (b1, b2):  # the eager first step, the capture
                before = launch_counters()
                steps["train_step"](batch, lr, fetch=False)
                assert launched_since(before) == STEP_LAUNCHES["arbitrary"], key
        model, _, opt, steps = runs["captured grouped"]
        state = {k: v.clone() for k, v in model.state_dict().items()}
        opt_state = copy.deepcopy(opt.state_dict())
        held = {}
        for key, (m, _, o, s) in runs.items():
            if key != "captured grouped":
                m.load_state_dict(state)
                o.load_state_dict(copy.deepcopy(opt_state))
        for key, (m, _, o, s) in runs.items():
            if key.startswith("captured"):
                loss, got = replayed([s["train_step"].graphs],
                                     lambda: s["train_step"](b1, lr), tmp_path)
                assert got == STEP_LAUNCHES["arbitrary"], key
            else:
                loss = s["train_step"](b1, lr)
            held[key] = (loss, m, o)
        _hold_step([held["captured grouped"], held["eager grouped"], held["eager"]])
        _hold_step([held["captured grouped"], held["captured"], held["eager"]])
        no_syncs(lambda: steps["train_step"](b2, lr, fetch=False))


# ------------------------------------------------- bfloat16 and remat


def with_model(name, **model):
    cfg = shipped_config(name)
    cfg["model"].update(model)
    return cfg


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["forward", "arbitrary"])
def test_bf16_train_steps_on_the_card(cuda, name):
    """The shipped stage-1 ``forward`` and stage-2 ``arbitrary`` nets with
    ``compute_dtype: bfloat16``, captured: the eager first step and the
    capture each launch one step's K1 / K2 / K3 (``STEP_LAUNCHES``), the
    replays none by the wrappers; losses finite, the parameters moved and
    still float32."""
    model, schedule, _, steps = trainer(with_model(name, compute_dtype="bfloat16"), cuda)
    lr = schedule.get_learning_rate(0)
    rng = np.random.RandomState(5)
    before_params = [p.detach().clone() for p in model.parameters()]
    losses = []
    for i in range(4):
        before = launch_counters()
        losses.append(steps["train_step"](train_batch(rng, 2, 5000, 5000), lr))
        want = STEP_LAUNCHES[name] if i < 2 else (0,) * 5
        assert launched_since(before) == want, i
    assert np.isfinite(losses).all()
    assert max(float((p.detach() - q).abs().max())
               for p, q in zip(model.parameters(), before_params)) > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.gpu
def test_bf16_captured_stage2_step_equals_eager_on_the_card(cuda):
    """The shipped stage-2 net with ``compute_dtype: bfloat16`` at B = 2
    (N = Q = 5000), captured: from one state a replayed step against two
    eager ones, held as the float32 step is (``_hold_step``): the loss and
    every BatchNorm buffer bit for bit (the forward's kernels and cuBLAS's
    bfloat16 products run in a fixed order); each gradient and parameter
    bit for bit or, where K2's float64 atomics reorder its sums (a float32
    gradient that may then round to another bfloat16 on its way back to a
    narrow operand), within 4 times the two eager steps' own relative gap,
    floor 1e-4."""
    cfg = with_model("arbitrary", compute_dtype="bfloat16")
    model, schedule, opt, steps = trainer(cfg, cuda)
    twins = [trainer(cfg, cuda, graphs=False) for _ in range(2)]
    lr = schedule.get_learning_rate(0)
    rng = np.random.RandomState(13)
    batches = [train_batch(rng, 2, 5000, 5000) for _ in range(3)]
    steps["train_step"](batches[0], lr)  # the eager warm-up
    steps["train_step"](batches[1], lr)  # the capture, replayed once
    assert steps["train_step"].graphs.summary()["replays"] == 1
    for m, _, o, _ in twins:
        m.load_state_dict(model.state_dict())
        o.load_state_dict(copy.deepcopy(opt.state_dict()))
    _hold_step([(s["train_step"](batches[2], lr), m, o)
                for m, o, s in [(model, opt, steps), *[(m, o, s) for m, _, o, s in twins]]])
    assert steps["train_step"].graphs.summary()["replays"] == 2


@pytest.mark.gpu
def test_bf16_stage1_converges_on_the_card(cuda):
    """``scripts/check_precision_convergence.py``'s run on the card: 40
    stage-1 Adam steps (5e-4) at B = 8 on one batch from one seeded init,
    in float32 and in bfloat16: every loss finite, and the bfloat16
    trajectory ending below its start."""
    batch = train_batch(np.random.RandomState(3), 8, 5000, 5000)
    for dtype in ("float32", "bfloat16"):
        model = init_random(build_model(with_model("forward", compute_dtype=dtype), device=cuda),
                            0, out_scale=0.01)
        _, opt = optimizer_factory({"optimizer": "Adam", "lr": 5e-4}, model.parameters())
        steps = make_steps(model, "forward", opt, device=cuda)
        losses = [steps["train_step"](batch, 5e-4) for _ in range(40)]
        assert np.isfinite(losses).all(), dtype
    assert losses[-1] < losses[0]


@pytest.mark.gpu
def test_remat_step_equals_plain_on_the_card(cuda):
    """One stage-2 step (B = 8) of the shipped model with ``remat: true``
    against two without, eager from one state: the loss and every buffer
    bit for bit; every gradient and parameter bit for bit or, where K2's
    float64 atomics reorder, its relative L2 gap to the first step without
    remat at most 4 times the two steps' own (floor 1e-4); K1 / K2 / K3
    launches 34 / 17 / 8 a step under remat (each encoder and decoder
    forward runs again in the backward)."""
    batch = train_batch(np.random.RandomState(11), 8, 5000, 5000)
    runs = []
    for remat in (False, False, True):
        model, schedule, _, steps = trainer(with_model("arbitrary", remat=remat), cuda,
                                            graphs=False)
        before = launch_counters()
        loss = steps["train_step"](batch, schedule.get_learning_rate(0))
        want = (34, 17, 8, 0, 0) if remat else STEP_LAUNCHES["arbitrary"]
        assert launched_since(before) == want
        runs.append(dict(loss=loss, buffers=list(model.buffers()),
                         grads=[p.grad for p in model.parameters()],
                         params=[p.detach() for p in model.parameters()]))
    plain, again, remat = runs
    assert remat["loss"] == plain["loss"]
    assert all(torch.equal(a, b) for a, b in zip(remat["buffers"], plain["buffers"]))
    for what in ("grads", "params"):
        for r, p, q in zip(remat[what], plain[what], again[what]):
            if not torch.equal(r, p):
                assert rel_err(r, p) <= max(4.0 * rel_err(q, p), 1e-4), what


@contextlib.contextmanager
def recorded_attention(calls):
    """Every attention call of the model's blocks also appended to
    ``calls`` as (positional arguments, keywords, its narrow dtype, its
    output)."""
    real = blocks.fused_vector_attention

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, port_attention.context_dtype(), out))
        return out

    blocks.fused_vector_attention = recording
    try:
        yield
    finally:
        blocks.fused_vector_attention = real


@pytest.mark.gpu
def test_bf16_evaluation_holds_each_attention_call(cuda):
    """One evaluation of the shipped model at Q = 65,536 through
    ``predict(compute_dtype=torch.bfloat16)``: one evaluation's launches
    (``SERVE_LAUNCHES``), every K1 launch in the narrow mode, and each of
    its attention calls, on the arguments it got (the projection mode's
    included), within ``K1_NARROW_SHARE`` of the plain narrow version's gap
    to float32 on the CPU."""
    model = init_random(build_model(shipped_config("arbitrary"), device=cuda), 0)
    rng = np.random.RandomState(6)
    surf = surface(rng, 5000)
    handle = (surf[:, 2:] > 0.8).astype(np.float32)
    inputs = np.concatenate([surf, (surf + np.float32(0.25)) * handle, handle], -1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None], device=cuda)
    calls = []
    with torch.inference_mode():
        before, narrow = launch_counters(), port_attention.fused_vector_attention.narrow_launches
        with recorded_attention(calls):
            out = model.predict(t(rng.uniform(-1.3, 1.3, (65536, 3))), t(inputs),
                                compute_dtype=torch.bfloat16)
        launched = launched_since(before)
        assert launched == SERVE_LAUNCHES["arbitrary"]["deform"]
        assert port_attention.fused_vector_attention.narrow_launches - narrow == launched[0]
        assert len(calls) == launched[0] and torch.isfinite(out).all()
        cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
        for i, (args, kwargs, dtype, got) in enumerate(calls):
            assert dtype is not None, f"attention call {i} ran outside the narrow mode"
            args, kwargs = [cpu(a) for a in args], {k: cpu(v) for k, v in kwargs.items()}
            ref = port_attention.fused_vector_attention(*args, **kwargs, compute_dtype=dtype)
            gap = rel_err(ref, port_attention.fused_vector_attention(*args, **kwargs))
            assert gap > 0 and rel_err(got.cpu(), ref) <= K1_NARROW_SHARE * gap, i
