"""Interactive editing with ``DeformationService`` and edit sessions.

The port's counterpart of ``examples/serve_interactive.py``: builds a tiny
arbitrary-pose model on synthetic data, opens an editing session over a
fixed source shape, and performs several handle drags -- each drag re-runs
only the forward half of the composition (the canonicalisation runs once
per session) -- then one full evaluation of the last drag to compare.

  python -m nsdp_tpu_torch.examples.serve_interactive [--workdir outputs/serve] \
      [--n_drags 4] [--device cpu]
"""

import argparse
import os
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(prog="nsdp_tpu_torch.examples.serve_interactive")
    parser.add_argument("--workdir", default="outputs/serve")
    parser.add_argument("--n_drags", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu' (the plain PyTorch path)")
    args = parser.parse_args(argv)

    from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config
    from nsdp_tpu_torch.serving import DeformationService

    print("== generating synthetic shapes ==")
    fixture = generate_synthetic_dataset(
        os.path.join(args.workdir, "data"), n_identities=1, n_motions_per_identity=1,
        n_frames=2, n_surface=256, n_space=256,
    )
    cfg = synthetic_config(fixture, model_type="arbitrary", arbitrary=True,
                           n_surface=256, n_space=256)
    cfg["model"]["fused_attention"] = True

    # seeded random weights: the demo shows the serving mechanics; pass
    # weight_file= (or DeformationService.from_config) for real edits
    print("== building service ==")
    svc = DeformationService(cfg, buckets=(512,), device=args.device, seed=0)

    rng = np.random.RandomState(0)
    surf = rng.randn(256, 3).astype(np.float32) * 0.2
    verts = rng.randn(400, 3).astype(np.float32) * 0.2  # "mesh vertices"

    print("== opening edit session (canonicalise once) ==")
    t0 = time.perf_counter()
    session = svc.edit_session(verts, surf)
    print(f"   session ready in {time.perf_counter() - t0:.2f}s")

    # drag the 'head' region (y above median) upward in increments
    handle = (surf[:, 1] > np.median(surf[:, 1])).astype(np.float32)
    for i in range(args.n_drags):
        target = surf.copy()
        target[:, 1] += 0.05 * (i + 1)
        t0 = time.perf_counter()
        deformed = session.drag(target * handle[:, None], handle)
        dt = time.perf_counter() - t0
        print(f"   drag {i + 1}: {deformed.shape[0]} verts deformed in {dt * 1e3:.1f} ms"
              f" (wall, incl. host transfer); mean |dv| = {np.abs(deformed - verts).mean():.4f}")

    print("== full evaluation of the last drag for comparison ==")
    mask = handle[:, None]
    inputs = np.concatenate([surf, target * mask, mask], axis=1)
    t0 = time.perf_counter()
    out = svc.deform(verts, inputs)
    gap = float(np.abs(out - deformed).max())
    print(f"   full deform: {time.perf_counter() - t0:.2f}s wall; max |session - full| = {gap:.2e}")
    return gap


if __name__ == "__main__":
    main()
