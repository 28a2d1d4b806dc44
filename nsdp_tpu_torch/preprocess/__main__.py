"""Preprocessing CLI — the reference's shell scripts as subcommands.

  anime:          .anime binaries -> per-frame meshes
                  (convert_deform4d_anime_to_mesh.sh)
  deform4d:       normalise frames + generate flows
                  (preprocess_deform4d_seq.sh)
  deformtransfer: same with interval 1
                  (preprocess_deformtransfer_seq.sh)
  nocorr:         normalisation only, for TOSCA / dogrec
                  (preprocess_nocorr_{tosca,dogrec}.sh)

The counterpart of ``python -m nsdp_tpu.preprocess``, with every flag of
``nsdp_tpu/preprocess/__main__.py``:

  python -m nsdp_tpu_torch.preprocess deform4d --input_mesh_dir MESHES \
      --output_data_dir DATA --temp_lst templates.lst --seed 0

Preprocessing is host work in both packages (numpy, scipy, the native C++
KD-tree and mesher), so this entry point has no ``--device``: nothing here
runs on the card.  ``--max_threads`` / ``--n_proc`` are the worker count
(-1: every CPU, 1: this process), the workers started by ``spawn``.
"""

import argparse
import sys

from nsdp_tpu_torch.preprocess.pipeline import (
    convert_anime_folder,
    generate_flows,
    generate_nocorr,
    generate_sequences,
)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="nsdp_tpu_torch.preprocess")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("anime", help=".anime -> per-frame meshes")
    p.add_argument("--in_folder", required=True)
    p.add_argument("--mesh_folder", required=True)
    p.add_argument("--out_ext", default="obj")
    p.add_argument("--n_proc", type=int, default=-1)

    for name, default_interval in (("deform4d", 3), ("deformtransfer", 1)):
        p = sub.add_parser(name, help=f"full {name} pipeline")
        p.add_argument("--input_mesh_dir", required=True)
        p.add_argument("--output_data_dir", required=True)
        p.add_argument("--mesh_format", default="obj")
        p.add_argument("--interval", type=int, default=default_interval)
        p.add_argument("--temp_lst", required=True,
                       help="split .lst naming the identity template sequences")
        p.add_argument("--filter_lst", default=None)
        p.add_argument("--max_threads", type=int, default=-1)
        p.add_argument("--surface_count", type=int, default=100000)
        p.add_argument("--space_count", type=int, default=200000)
        p.add_argument("--seed", type=int, default=None)
        p.add_argument(
            "--make_watertight", action="store_true",
            help="closed-manifold remesh before normalisation (the shell's "
            "optional msh2df step, off by default upstream too)",
        )
        p.add_argument(
            "--watertight_spacing", type=float, default=0.02,
            help="SDF grid spacing for --make_watertight (msh2df -spacing; "
            "cost ~ (extent/spacing)^3)",
        )
        p.add_argument(
            "--watertight_method", default="sdf",
            choices=["sdf", "poisson"],
            help="'sdf' = the GAPS msh2df rasterisation (the commented "
            "make_watertight.sh variant); 'poisson' = the active meshlab "
            "screened-Poisson recipe (make_watertight.sh:19)",
        )
        p.add_argument(
            "--watertight_depth", type=int, default=8,
            help="grid resolution exponent for --watertight_method=poisson "
            "(the screened_poisson.mlx octree depth; n = 2^depth)",
        )

    p = sub.add_parser("nocorr", help="normalisation-only (TOSCA / dogrec)")
    p.add_argument("--input_mesh_dir", required=True)
    p.add_argument("--output_data_dir", required=True)
    p.add_argument("--mesh_format", default="off")
    p.add_argument("--filter_lst", default=None)
    p.add_argument("--max_threads", type=int, default=-1)

    args = parser.parse_args(argv)

    if args.command == "anime":
        n = convert_anime_folder(
            args.in_folder, args.mesh_folder, args.out_ext, args.n_proc
        )
        print(f"converted {n} .anime files")
    elif args.command in ("deform4d", "deformtransfer"):
        n = generate_sequences(
            args.input_mesh_dir,
            args.output_data_dir,
            args.mesh_format,
            args.interval,
            args.filter_lst,
            n_jobs=args.max_threads,
            make_watertight=args.make_watertight,
            watertight_spacing=args.watertight_spacing,
            watertight_method=args.watertight_method,
            watertight_depth=args.watertight_depth,
        )
        print(f"normalised {n} frames")
        m = generate_flows(
            args.input_mesh_dir,
            args.output_data_dir,
            args.temp_lst,
            args.mesh_format,
            args.interval,
            args.surface_count,
            args.space_count,
            n_jobs=args.max_threads,
            seed=args.seed,
        )
        print(f"generated flows for {m} frames")
    elif args.command == "nocorr":
        n = generate_nocorr(
            args.input_mesh_dir,
            args.output_data_dir,
            args.mesh_format,
            args.filter_lst,
            n_jobs=args.max_threads,
        )
        print(f"normalised {n} meshes")


if __name__ == "__main__":
    main(sys.argv[1:])
