"""Command line of the dataset preparation utilities, with
``scripts/prepare_data.py``'s subcommands and flags (host only):

    python -m vnet_tpu_torch.utils.prepare_data lits --src ./flat --tgt ./cases
    python -m vnet_tpu_torch.utils.prepare_data partition --data ./cases \
        --layers 64 --tgt ./chunks
    python -m vnet_tpu_torch.utils.prepare_data check --data ./cases
    python -m vnet_tpu_torch.utils.prepare_data binarize --data ./cases \
        --select 2 --mask 1 2
    python -m vnet_tpu_torch.utils.prepare_data fit_label --data ./cases \
        --dilation 5
    python -m vnet_tpu_torch.utils.prepare_data unzip --src ./zips --tgt ./cases
"""

from __future__ import annotations

import argparse
import os

from ...io import read_image, write_image
from .prepare import (binarize_labels, check_header_consistency,
                      fit_label_crop, lits_restructure, partition_z,
                      unzip_adam)


def iter_cases(data_dir):
    for case in sorted(os.listdir(data_dir)):
        cdir = os.path.join(data_dir, case)
        if os.path.isdir(cdir):
            yield case, cdir


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.utils.prepare_data")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("lits")
    s.add_argument("--src", required=True)
    s.add_argument("--tgt", required=True)

    s = sub.add_parser("check")
    s.add_argument("--data", required=True)
    s.add_argument("--image", default="image.nii")
    s.add_argument("--label", default="label.nii")

    s = sub.add_parser("partition")
    s.add_argument("--data", required=True)
    s.add_argument("--tgt", required=True)
    s.add_argument("--layers", type=int, default=64)
    s.add_argument("--image", default="image.nii")
    s.add_argument("--label", default="label.nii")

    s = sub.add_parser("binarize")
    s.add_argument("--data", required=True)
    s.add_argument("--select", nargs="*", type=int, required=True)
    s.add_argument("--mask", nargs="*", type=int, default=[])
    s.add_argument("--dilation", type=int, default=5)
    s.add_argument("--image", default="image.nii")
    s.add_argument("--label", default="label.nii")

    s = sub.add_parser("fit_label")
    s.add_argument("--data", required=True)
    s.add_argument("--dilation", type=int, default=5)
    s.add_argument("--image", default="image.nii")
    s.add_argument("--label", default="label.nii")

    s = sub.add_parser("unzip")
    s.add_argument("--src", required=True)
    s.add_argument("--tgt", required=True)

    args = p.parse_args(argv)

    if args.cmd == "lits":
        moved = lits_restructure(args.src, args.tgt)
        print(f"moved {len(moved)} files")
    elif args.cmd == "check":
        bad = check_header_consistency(args.data, args.image, args.label)
        for case, problems in bad.items():
            print(f"{case}: {', '.join(problems)}")
        print(f"{len(bad)} inconsistent case(s)")
    elif args.cmd == "partition":
        for case, cdir in iter_cases(args.data):
            img = read_image(os.path.join(cdir, args.image))
            lbl = read_image(os.path.join(cdir, args.label))
            for z, ic, lc in partition_z(img, lbl, args.layers):
                out = os.path.join(args.tgt, f"{case}_{z}")
                os.makedirs(out, exist_ok=True)
                write_image(ic, os.path.join(out, "image.nii.gz"))
                write_image(lc, os.path.join(out, "label.nii.gz"))
            print(f"partitioned {case}")
    elif args.cmd == "binarize":
        for case, cdir in iter_cases(args.data):
            lbl = read_image(os.path.join(cdir, args.label))
            img = (read_image(os.path.join(cdir, args.image))
                   if args.mask else None)
            out_lbl, out_img = binarize_labels(lbl, args.select, img,
                                               args.mask, args.dilation)
            write_image(out_lbl, os.path.join(cdir, "label_masked.nii.gz"))
            if out_img is not None:
                write_image(out_img, os.path.join(cdir, "image_masked.nii.gz"))
            print(f"binarized {case}")
    elif args.cmd == "fit_label":
        for case, cdir in iter_cases(args.data):
            img = read_image(os.path.join(cdir, args.image))
            lbl = read_image(os.path.join(cdir, args.label))
            ci, cl = fit_label_crop(img, lbl, args.dilation)
            write_image(ci, os.path.join(cdir, "image_cropped.nii.gz"))
            write_image(cl, os.path.join(cdir, "label_cropped.nii.gz"))
            print(f"cropped {case} -> {ci.GetSize()}")
    elif args.cmd == "unzip":
        out = unzip_adam(args.src, args.tgt)
        print(f"extracted {len(out)} archives")


if __name__ == "__main__":
    main()
