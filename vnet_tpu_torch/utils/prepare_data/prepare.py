"""Dataset preparation utilities — the port's copy of
``vnet_tpu/utils/prepare_data/prepare.py`` (host only; the command line is
``python -m vnet_tpu_torch.utils.prepare_data``).

Library (importable, parameterized) re-designs of the reference's
hardcoded-path scripts under the reference's `utils/prepare_data/`:

* ``lits_restructure`` — LiTS ``volume-N`` / ``segmentation-N`` flat files
  into per-case dirs with ``image.nii`` / ``label.nii`` (lits.py:6-30).
* ``binarize_labels`` — select label values -> binary label; optional
  dilation-mask applied to the image (binarize.py:16-78).
* ``unify_header`` — copy image geometry onto the label
  (unify_header.py:5-50).
* ``check_header_consistency`` — report cases whose image/label headers
  disagree (check_header_consistency.py:5-41).
* ``partition_z`` — split cases into fixed-depth z-chunks
  (image_partition.py:13-48).
* ``fit_label_crop`` — crop image+label to the label bounding box with a
  dilation margin (image_fit_label.py:17-40).
* ``unzip_adam`` — ADAM challenge zip extraction (adam_unzip.py:6-41).
"""

from __future__ import annotations

import os
import shutil
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ...io import MedicalImage, read_image


def lits_restructure(src_dir: str, tgt_dir: str) -> List[str]:
    """volume-12.nii -> 12/image.nii, segmentation-12.nii -> 12/label.nii."""
    moved = []
    for fname in sorted(os.listdir(src_dir)):
        if ".nii" not in fname:
            continue
        case = "".join(c for c in fname if c.isdigit())
        ext = ".nii.gz" if fname.endswith(".nii.gz") else ".nii"
        if "volume" in fname:
            tgt_name = "image" + ext
        elif "segmentation" in fname:
            tgt_name = "label" + ext
        else:
            continue
        os.makedirs(os.path.join(tgt_dir, case), exist_ok=True)
        tgt = os.path.join(tgt_dir, case, tgt_name)
        shutil.move(os.path.join(src_dir, fname), tgt)
        moved.append(tgt)
    return moved


def binarize_labels(label: MedicalImage, select_labels: Sequence[int],
                    image: Optional[MedicalImage] = None,
                    mask_labels: Sequence[int] = (),
                    mask_dilation: int = 5,
                    ) -> Tuple[MedicalImage, Optional[MedicalImage]]:
    """Select label values into a binary mask; optionally mask the image to
    the dilated union of ``mask_labels`` (binarize.py:37-78)."""
    out = np.zeros(label.data.shape, np.uint8)
    for v in select_labels:
        out[label.data == v] = 1
    label_out = label.like(out)

    image_out = None
    if mask_labels and image is not None:
        mask = np.zeros(label.data.shape, bool)
        for v in mask_labels:
            mask |= label.data == v
        if mask_dilation > 0:
            mask = ndimage.binary_dilation(mask, iterations=mask_dilation)
        image_out = image.like(
            np.where(mask, image.data, 0).astype(image.data.dtype))
    return label_out, image_out


def unify_header(image: MedicalImage, label: MedicalImage) -> MedicalImage:
    """Force the label onto the image's geometry (unify_header.py:5-50)."""
    return MedicalImage(label.data, image.spacing, image.origin,
                        image.direction)


def check_header_consistency(data_dir: str, image_filename: str = "image.nii",
                             label_filename: str = "label.nii",
                             tol: float = 1e-4) -> Dict[str, List[str]]:
    """case -> list of mismatched fields (check_header_consistency.py:5-41)."""
    bad = {}
    for case in sorted(os.listdir(data_dir)):
        cdir = os.path.join(data_dir, case)
        ipath = os.path.join(cdir, image_filename)
        lpath = os.path.join(cdir, label_filename)
        if not (os.path.isdir(cdir) and os.path.exists(ipath)
                and os.path.exists(lpath)):
            continue
        img, lbl = read_image(ipath), read_image(lpath)
        problems = []
        if img.GetSize() != lbl.GetSize():
            problems.append("size")
        if not np.allclose(img.spacing, lbl.spacing, atol=tol):
            problems.append("spacing")
        if not np.allclose(img.direction, lbl.direction, atol=tol):
            problems.append("direction")
        if not np.allclose(img.origin, lbl.origin, atol=tol):
            problems.append("origin")
        if problems:
            bad[case] = problems
    return bad


def partition_z(image: MedicalImage, label: MedicalImage,
                layers: int = 64) -> List[Tuple[int, MedicalImage, MedicalImage]]:
    """Split into (z_start, image_chunk, label_chunk) pieces of up to
    ``layers`` slices (image_partition.py:31-47)."""
    out = []
    depth = image.GetSize()[2]
    for k in range(0, depth, layers):
        size = min(layers, depth - k)
        img = MedicalImage(
            np.ascontiguousarray(image.data[:, :, k:k + size]),
            image.spacing, image.TransformIndexToPhysicalPoint((0, 0, k)),
            image.direction)
        lbl = MedicalImage(
            np.ascontiguousarray(label.data[:, :, k:k + size]),
            label.spacing, label.TransformIndexToPhysicalPoint((0, 0, k)),
            label.direction)
        out.append((k, img, lbl))
    return out


def fit_label_crop(image: MedicalImage, label: MedicalImage,
                   dilation: int = 5) -> Tuple[MedicalImage, MedicalImage]:
    """Crop both to the label bounding box grown by ``dilation`` voxels
    (image_fit_label.py:17-40)."""
    mask = label.data > 0
    if not mask.any():
        return image, label
    slices = ndimage.find_objects(mask.astype(np.uint8))[0]
    start = [max(s.start - dilation, 0) for s in slices]
    stop = [min(s.stop + dilation, dim)
            for s, dim in zip(slices, label.data.shape)]
    region = tuple(slice(a, b) for a, b in zip(start, stop))
    origin = image.TransformIndexToPhysicalPoint(tuple(start))
    img = MedicalImage(np.ascontiguousarray(image.data[region]),
                       image.spacing, origin, image.direction)
    lbl = MedicalImage(np.ascontiguousarray(label.data[region]),
                       label.spacing, origin, label.direction)
    return img, lbl


def unzip_adam(src_dir: str, tgt_dir: str) -> List[str]:
    """Extract every .zip in src_dir into tgt_dir/<zipname>/
    (adam_unzip.py:6-41)."""
    out = []
    for fname in sorted(os.listdir(src_dir)):
        if not fname.endswith(".zip"):
            continue
        case = fname[: -len(".zip")]
        dest = os.path.join(tgt_dir, case)
        os.makedirs(dest, exist_ok=True)
        with zipfile.ZipFile(os.path.join(src_dir, fname)) as zf:
            zf.extractall(dest)
        out.append(dest)
    return out
