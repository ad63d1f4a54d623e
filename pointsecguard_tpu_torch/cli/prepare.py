"""Data preparation CLI of the port (port of ``pointsecguard_tpu/cli/prepare.py``).

Mirrors the reference one-off preprocessing entry points:

- S3DIS (`collect_indoor3d_data.py` + `data_prepare_s3dis.py`):
    python -m pointsecguard_tpu_torch.cli.prepare --raw_root <S3DIS aligned root> \
        --out_root data/stanford_indoor3d [--randla_out data/randla_input_0.040]
- SemanticKITTI (`utils/data_prepare_semantickitti.py`):
    python -m pointsecguard_tpu_torch.cli.prepare --dataset semantickitti \
        --raw_root <dataset/sequences> --out_root <sequences_0.06> \
        --kitti_yaml <semantic-kitti.yaml>
- Semantic3D (`utils/data_prepare_semantic3d.py`):
    python -m pointsecguard_tpu_torch.cli.prepare --dataset semantic3d \
        --raw_root <original_data dir> --out_root <semantic3d root>

numpy and scipy only: it runs where the JAX package cannot be imported.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser("prepare")
    ap.add_argument("--dataset", choices=["s3dis", "semantickitti", "semantic3d"],
                    default="s3dis")
    ap.add_argument("--raw_root", type=str,
                    help="s3dis: Stanford3dDataset root (Area_*/room/Annotations); "
                         "semantickitti: dataset/sequences dir; "
                         "semantic3d: dir of .txt clouds (+ .labels)")
    ap.add_argument("--out_root", type=str, default="data/stanford_indoor3d")
    ap.add_argument("--randla_out", type=str, default=None,
                    help="s3dis only: also build the RandLA 0.04 m grid inputs here")
    ap.add_argument("--sub_grid_size", type=float, default=None,
                    help="working grid (default: 0.04 s3dis, 0.06 kitti/sem3d)")
    ap.add_argument("--kitti_yaml", type=str, default=None,
                    help="semantickitti: path to the dataset's semantic-kitti.yaml "
                         "(provides learning_map)")
    args = ap.parse_args(argv)

    if args.dataset == "semantickitti":
        from pointsecguard_tpu_torch.data.other_datasets import (
            parse_kitti_learning_map,
            prepare_semantickitti_root,
        )

        if not args.raw_root or not args.kitti_yaml:
            ap.error("--dataset semantickitti requires --raw_root and --kitti_yaml")
        done = prepare_semantickitti_root(
            args.raw_root, args.out_root, parse_kitti_learning_map(args.kitti_yaml),
            grid_size=args.sub_grid_size or 0.06,
        )
        print(f"prepared {len(done)} scans into {args.out_root}")
        return done

    if args.dataset == "semantic3d":
        from pointsecguard_tpu_torch.data.other_datasets import prepare_semantic3d_root

        if not args.raw_root:
            ap.error("--dataset semantic3d requires --raw_root")
        done = prepare_semantic3d_root(args.raw_root, args.out_root,
                                       final_grid=args.sub_grid_size or 0.06)
        print(f"prepared {len(done)} clouds into {args.out_root}")
        return done

    from pointsecguard_tpu_torch.data.randla import prepare_room
    from pointsecguard_tpu_torch.data.s3dis import collect_s3dis

    done = []
    if args.raw_root:
        written = collect_s3dis(args.raw_root, args.out_root)
        print(f"collected {len(written)} rooms into {args.out_root}")

    if args.randla_out:
        rooms = sorted(f for f in os.listdir(args.out_root) if f.endswith(".npy"))
        # sibling original_ply dir, reference layout (`data_prepare_s3dis.py:22`)
        original = os.path.join(os.path.dirname(args.randla_out), "original_ply")
        for r in rooms:
            name = prepare_room(os.path.join(args.out_root, r), args.randla_out,
                                sub_grid_size=args.sub_grid_size or 0.04,
                                original_dir=original)
            print(f"prepared {name}")
            done.append(name)
    return done


if __name__ == "__main__":
    main()
