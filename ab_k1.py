#!/usr/bin/env python3
"""Time K1 (the fused kNN attention) at phase 2's sites in one checkout, and
print its output digests, to compare two versions of K1 or record its digests.

    python3 ab_k1.py <checkout> [label]      # needs one CUDA card

Imports ``nsdp_tpu_torch`` from ``<checkout>`` and ``chip_smoke.py`` from
this script's directory, builds the checkout's attention and FPS kernels,
and runs K1 on exactly the inputs of ``chip_smoke.py``'s phase 2 (the same
seed, the same sites in the same order): per site the median call time
(CUDA events), the device time by CUDA kernel at the decoder sites
(``torch.profiler``), and the SHA-256 of the output against
``chip_smoke.K1_DIGESTS``; then K1's time per evaluation and a ``DIGESTS``
line, the table to paste into ``K1_DIGESTS`` when the digests must be
recorded again (``chip_smoke.py``'s docstring says when).  Compare two
checkouts only within one call, in turns (parent, change, change, parent).
"""

import importlib.util
import os
import sys

checkout = os.path.abspath(sys.argv[1])
label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(checkout)
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
_build.build(["attention", "fps"])
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
    run = lambda: attention.fused_vector_attention(*pos, k=a["k"], **kw)
    with torch.inference_mode():
        digests[site[0]] = digest = cs.k1_digest(run())
        ms = cs.time_ms(torch, run, 7)
        split = cs.kernel_split(torch, run, 5) if site[0].startswith("decoder") else {}
    total += site[1] * ms
    want = cs.K1_DIGESTS.get(site[0])
    print(f"AB {label} {site[0]:<26} {ms:.4f} ms  digest {digest[:16]}"
          f" {'equal' if want == digest else 'DIFFERS'}  {cs.format_split(split)}", flush=True)
print(f"AB {label} K1 per evaluation {total:.4f} ms")
print(f"DIGESTS {digests!r}")
