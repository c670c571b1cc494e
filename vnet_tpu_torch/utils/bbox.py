"""Bounding-box extraction + rendering from label maps — the port's copy
of ``vnet_tpu/utils/bbox.py`` (host only), with the command line of
``scripts/bbox.py``:

    python -m vnet_tpu_torch.utils.bbox --image case/image.nii \
        --label case/label.nii --classes 1 2 --out_dir ./bbox_out

Re-design of the reference's `utils/bounding_box/bbox.py`: per axial
slice, per class value, connected components become 2D boxes, overlapping
boxes are merged by non-maximum suppression (IoU 0.5, bbox.py:10-64), and
slices render with the image + boxes + class names via matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage

from ..io import MedicalImage, read_image


@dataclass
class Box:
    x0: int
    y0: int
    x1: int
    y1: int
    label: int
    area: int

    def iou(self, other: "Box") -> float:
        ix0, iy0 = max(self.x0, other.x0), max(self.y0, other.y0)
        ix1, iy1 = min(self.x1, other.x1), min(self.y1, other.y1)
        iw, ih = max(ix1 - ix0, 0), max(iy1 - iy0, 0)
        inter = iw * ih
        union = ((self.x1 - self.x0) * (self.y1 - self.y0)
                 + (other.x1 - other.x0) * (other.y1 - other.y0) - inter)
        return inter / union if union else 0.0


def slice_boxes(label_slice: np.ndarray, class_value: int) -> List[Box]:
    cc, n = ndimage.label(label_slice == class_value)
    boxes = []
    for i, sl in enumerate(ndimage.find_objects(cc)):
        if sl is None:
            continue
        area = int((cc[sl] == (i + 1)).sum())
        boxes.append(Box(sl[0].start, sl[1].start, sl[0].stop, sl[1].stop,
                         class_value, area))
    return boxes


def nms(boxes: List[Box], iou_threshold: float = 0.5) -> List[Box]:
    """Greedy NMS by area (bbox.py:10-64)."""
    out: List[Box] = []
    for box in sorted(boxes, key=lambda b: -b.area):
        if all(box.iou(kept) <= iou_threshold for kept in out):
            out.append(box)
    return out


def volume_boxes(label: MedicalImage, classes: Sequence[int],
                 iou_threshold: float = 0.5) -> Dict[int, List[Box]]:
    """z -> NMS'd boxes over all non-background classes."""
    out = {}
    for z in range(label.GetSize()[2]):
        sl = label.data[:, :, z]
        boxes = []
        for cls in classes:
            if cls == 0:
                continue
            boxes.extend(slice_boxes(sl, cls))
        boxes = nms(boxes, iou_threshold)
        if boxes:
            out[z] = boxes
    return out


def render_slice(image_slice: np.ndarray, boxes: List[Box],
                 classnames: Optional[Dict[int, str]] = None,
                 output_path: Optional[str] = None):
    """Render one slice with boxes (bbox.py:147-237). Returns the figure
    unless ``output_path`` is given (then saves + closes)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots()
    ax.imshow(image_slice.T, cmap="gray", origin="lower")
    for b in boxes:
        ax.add_patch(Rectangle((b.x0, b.y0), b.x1 - b.x0, b.y1 - b.y0,
                               fill=False, edgecolor="red", linewidth=1))
        name = (classnames or {}).get(b.label, str(b.label))
        ax.text(b.x0, b.y1 + 1, name, color="red", fontsize=8)
    ax.axis("off")
    if output_path:
        fig.savefig(output_path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.utils.bbox")
    p.add_argument("--image", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--classes", nargs="*", type=int, default=[1])
    p.add_argument("--classnames_json", default="",
                   help="JSON mapping class id -> display name")
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--out_dir", default="./bbox_out")
    args = p.parse_args(argv)

    image = read_image(args.image)
    label = read_image(args.label)
    classnames = {}
    if args.classnames_json:
        with open(args.classnames_json) as f:
            classnames = {int(k): v for k, v in json.load(f).items()}

    boxes_by_z = volume_boxes(label, args.classes, args.iou)
    os.makedirs(args.out_dir, exist_ok=True)
    for z, boxes in sorted(boxes_by_z.items()):
        render_slice(image.data[:, :, z], boxes, classnames,
                     os.path.join(args.out_dir, f"slice_{z:04d}.png"))
    print(f"rendered {len(boxes_by_z)} slices to {args.out_dir}")
    return boxes_by_z


if __name__ == "__main__":
    main()
