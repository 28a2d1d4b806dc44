"""End-to-end quickstart on synthetic data (no dataset download needed).

The port's counterpart of ``examples/quickstart.py``: generates a miniature
DeformingThings4D-shaped dataset (deforming icospheres, with the real
directory contract), trains the stage-1 forward deformation network briefly
through ``python -m nsdp_tpu_torch.train``, evaluates it through ``python -m
nsdp_tpu_torch.test``, and writes deformed meshes -- the same code paths as
the full pipelines.

  python -m nsdp_tpu_torch.examples.quickstart [--workdir outputs/quickstart] \
      [--epochs 8] [--device cpu]
"""

import argparse
import os

import yaml


def main(argv=None):
    parser = argparse.ArgumentParser(prog="nsdp_tpu_torch.examples.quickstart")
    parser.add_argument("--workdir", default="outputs/quickstart")
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default) or 'cpu' (the plain PyTorch path)")
    args = parser.parse_args(argv)

    from nsdp_tpu_torch import test as test_cli
    from nsdp_tpu_torch import train as train_cli
    from nsdp_tpu_torch.data.synthetic import generate_synthetic_dataset, synthetic_config

    print("== generating synthetic dataset ==")
    fixture = generate_synthetic_dataset(
        os.path.join(args.workdir, "data"), n_identities=2, n_motions_per_identity=1,
        n_frames=4, n_surface=400, n_space=500,
    )
    cfg = synthetic_config(fixture, model_type="forward")
    cfg["experiment"]["out_dir"] = os.path.join(args.workdir, "out")
    cfg["training"]["epochs"] = args.epochs
    cfg["training"]["save_frequency"] = max(args.epochs - 1, 1)
    cfg["validation"]["frequency"] = max(args.epochs - 1, 1)
    cfg_path = os.path.join(args.workdir, "quickstart.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    print("== training (stage-1 forward net) ==")
    train_cli.main([cfg_path, "--seed", "0", "--device", args.device])

    print("== evaluating + writing meshes ==")
    exp_dir = os.path.join(cfg["experiment"]["out_dir"], cfg["experiment"]["name"])
    latest = sorted(f for f in os.listdir(exp_dir) if f.startswith("model_"))[-1]
    cfg["test"]["weight_file"] = os.path.join(exp_dir, latest)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    test_cli.main([cfg_path, "--device", args.device])

    mesh_dir = os.path.join(exp_dir, cfg["test"]["motion_split"], "meshes", "deformed")
    print(f"\nDone. Deformed meshes in: {mesh_dir}")
    print("Files:", sorted(os.listdir(mesh_dir)))
    return mesh_dir


if __name__ == "__main__":
    main()
