#!/usr/bin/env python3
"""Time K1 (the fused kNN attention) at phase 2's sites in one checkout, and
print its output digests, to compare two versions of K1 or record its digests.

    python3 ab_k1.py <checkout> [label] [--dtype bfloat16|float16 [--phases]]   # one CUDA card

Imports ``nsdp_tpu_torch`` from ``<checkout>`` and ``chip_smoke.py`` from
this script's directory, builds the checkout's attention and FPS kernels,
and runs K1 on exactly the inputs of ``chip_smoke.py``'s phase 2 (the same
seed, the same sites in the same order): per site the median call time
(CUDA events), the device time by CUDA kernel at the decoder sites
(``torch.profiler``), and the SHA-256 of the output against
``chip_smoke.K1_DIGESTS``; then K1's time per evaluation and a ``DIGESTS``
line, the table to paste into ``K1_DIGESTS`` when the digests must be
recorded again (``chip_smoke.py``'s docstring says when).  With
``--dtype`` it times K1's narrow-operand mode (``compute_dtype``) instead,
at every site, with the device time by kernel and the relative L2 gap to
the plain narrow version (as a share of that version's gap to float32,
``chip_smoke.K1_NARROW_SHARE``'s rule), and prints no digests.  Compare two
checkouts only within one call, in turns (parent, change, change, parent).

With ``--dtype`` and ``--phases`` it runs a copy of the checkout's package,
built in a temporary directory, whose ``attn_mma16_kernel`` stamps
``clock64()`` after each of its phases (a block barrier before each stamp)
in the first 64 blocks of batch item 0, and prints per site the mean
cycles of each phase: rows (neighbours, deltas), layer0 (fc_delta's 3-wide
layer), mma1, gather (pos into the values, fc_gamma's input and the values:
the K/V gathers), mma2, epi2, mma3, epi3, softmax.  The stamps' barriers
cost a little time of their own; the phases' shares are what it reads.
"""

import argparse
import importlib.util
import os
import sys

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("checkout")
parser.add_argument("label", nargs="?")
parser.add_argument("--dtype", choices=("bfloat16", "float16"), default=None)
parser.add_argument("--phases", action="store_true")
args = parser.parse_args()
checkout = os.path.abspath(args.checkout)
label = args.label or os.path.basename(checkout)
PHASES = ("rows", "layer0", "mma1", "gather", "mma2", "epi2", "mma3", "epi3", "softmax")


def instrumented(src: str) -> str:
    """``attention.cu`` with ``attn_mma16_kernel`` stamping ``clock64()``
    into a device array after each phase (``PHASES``) in the first 64 blocks
    of batch item 0, and ``nsdp_probe_clk`` copying the array out."""
    stamp = lambda i: ("  __syncthreads();\n  if (threadIdx.x == 0 && blockIdx.y == 0 &&"
                       f" blockIdx.x < 64) g_clk[blockIdx.x * 16 + {i}] = clock64();\n")
    a = src.index("attn_mma16_kernel(const Params p)")
    b = src.index("cudaError_t launch_narrow", a)
    k = src[a:b]
    anchors = [
        ("  const float* kv = p.kv_xyz + (size_t)b * M * 3;\n", 0, "after"),
        ("  // ---- fc_delta layer 0", 1, "before"),
        ("  float acc[", 2, "before"),
        ("mma16::rows_mma16<NW>(act, frag, D, ring, acc);\n", 3, "after"),
        ("  // ---- fc_gamma ---", 4, "before"),
        ("mma16::rows_mma16<NW>(act, frag + wstride, D, ring, acc);\n", 5, "after"),
        ("  mma16::rows_mma16<NW>(act, frag + 2 * wstride, D, ring, acc);\n", 6, "before"),
        ("  mma16::rows_mma16<NW>(act, frag + 2 * wstride, D, ring, acc);\n", 7, "after"),
        ("  // ---- per-channel softmax", 8, "before"),
    ]
    for text, i, where in anchors:
        if text not in k:
            cs.fail(f"--phases: the kernel no longer has the phase anchor {text.strip()!r}")
        k = k.replace(text, stamp(i) + text if where == "before" else text + stamp(i), 1)
    end = k.rindex("}\n")  # the kernel's end; thread 0 always reaches it
    k = k[:end] + stamp(9).replace("__syncthreads();", "") + k[end:]
    src = src[:a] + k + src[b:]
    src = src.replace("namespace {\n", "__device__ unsigned long long g_clk[64 * 16];\nnamespace {\n", 1)
    return src + ('\nextern "C" int nsdp_probe_clk(unsigned long long* h) {'
                  " return (int)cudaMemcpyFromSymbol(h, g_clk, sizeof(g_clk)); }\n")


if args.phases:
    if args.dtype is None:
        parser.error("--phases times the narrow kernel: give --dtype")
    import atexit
    import shutil
    import tempfile

    copy = tempfile.mkdtemp(prefix="ab_k1_phases_")
    atexit.register(shutil.rmtree, copy, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "nsdp_tpu_torch"), os.path.join(copy, "nsdp_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    sys.path.insert(0, copy)
else:
    sys.path.insert(0, checkout)
import numpy as np  # noqa: E402
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from nsdp_tpu_torch.ops import _build, attention, fps  # noqa: E402

if not torch.cuda.is_available():
    cs.fail("no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
if args.phases:
    source = _build.CSRC / "attention.cu"
    source.write_text(instrumented(source.read_text()))
_build.build(["attention", "fps"])
if args.phases:
    import ctypes

    probe = ctypes.CDLL(str(_build.library_path("attention")))
    probe.nsdp_probe_clk.argtypes = [ctypes.c_void_p]
dtype = getattr(torch, args.dtype) if args.dtype else None
rng = np.random.RandomState(0)  # phase 2's draws, in phase 2's order
surf = cs.surface(rng, 5000)
x = torch.as_tensor(surf[None], device="cuda")
fps_500 = fps.furthest_point_sample(x, 500)[0].cpu().numpy()
fps_100 = fps.furthest_point_sample(
    torch.as_tensor(surf[fps_500][None], device="cuda"), 100)[0].cpu().numpy()
total, digests = 0.0, {}
for site in cs.k1_sites():
    a = cs.k1_inputs(torch, rng, surf, fps_500, fps_100, site)
    kw = {key: a[key] for key in ("k_glob", "v_glob", "kv_mask") if key in a}
    pos = (a["xyz_q"], a["kv_xyz"], a["q_feats"], a["K_a"], a["V_a"], *a["weights"])
    narrow = {} if dtype is None else {"compute_dtype": dtype}
    run = lambda: attention.fused_vector_attention(*pos, k=a["k"], **kw, **narrow)
    with torch.inference_mode():
        out = run()
        if dtype is None:
            digests[site[0]] = digest = cs.k1_digest(out)
            want = cs.K1_DIGESTS.get(site[0])
            check = f"digest {digest[:16]} {'equal' if want == digest else 'DIFFERS'}"
        else:
            penalty = attention.mask_penalty(a["kv_mask"]) if "kv_mask" in a else None
            plain = lambda cd: attention.fused_vector_attention_plain(
                *pos, a["k"], a.get("k_glob"), a.get("v_glob"), penalty, compute_dtype=cd)
            ref = plain(dtype)
            check = f"gap share {cs.rel_err(out, ref) / cs.rel_err(ref, plain(None)):.4f}"
        del out
        ms = cs.time_ms(torch, run, 7)
        split = (cs.kernel_split(torch, run, 5)
                 if dtype is not None or site[0].startswith("decoder") else {})
    total += site[1] * ms
    print(f"AB {label} {args.dtype or 'float32'} {site[0]:<26} {ms:.4f} ms  {check}"
          f"  {cs.format_split(split)}", flush=True)
    if args.phases:
        with torch.inference_mode():
            run()
            torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * (64 * 16))()
        if probe.nsdp_probe_clk(clk) != 0:
            cs.fail("--phases: reading the clock stamps failed")
        slots = site[4]  # the phase-2 sites' global slot is a broadcast query's: no row
        blocks = min(64, -(-site[2] // (attention.NARROW_ROWS // slots)))
        cycles = np.diff(np.array(clk, np.float64).reshape(64, 16)[:blocks, :10], axis=1).mean(0)
        print(f"PHASES {label} {site[0]:<26} " + " ".join(
            f"{name} {c:.0f}" for name, c in zip(PHASES, cycles)) + f" total {cycles.sum():.0f}",
            flush=True)
print(f"AB {label} {args.dtype or 'float32'} K1 per evaluation {total:.4f} ms")
if dtype is None:
    print(f"DIGESTS {digests!r}")
