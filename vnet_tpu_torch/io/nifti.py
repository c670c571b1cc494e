"""Pure-numpy NIfTI-1 reader/writer and a geometric medical-image container.

The reference framework leans on SimpleITK for all image I/O and geometry
(reference `pipeline/NiftiDataset3D.py:57-60`, `model.py:1191-1196`).
The framework does without SimpleITK and keeps a thin, dependency-free
host path, so this module implements:

* ``MedicalImage`` — an array + (origin, spacing, direction) container with
  SimpleITK-compatible geometry semantics (LPS world frame, ``GetSize`` in
  (x, y, z) order). Unlike SimpleITK we keep the voxel array indexed
  ``arr[x, y, z]`` natively, which is exactly the layout the reference
  produces after its ``np.transpose(..., (2, 1, 0))`` dance
  (`NiftiDataset3D.py:154`), so downstream code never transposes.
* ``read_image`` / ``write_image`` — NIfTI-1 (.nii / .nii.gz) support with
  sform/qform handling and scl_slope/scl_inter intensity scaling.

The port's copy of ``vnet_tpu/io/nifti.py``, unchanged in behaviour.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

# NIfTI-1 datatype codes <-> numpy dtypes
_DTYPE_FROM_CODE = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODE_FROM_DTYPE = {np.dtype(v): k for k, v in _DTYPE_FROM_CODE.items()}

_HDR_SIZE = 348


def _identity_direction(ndim: int) -> tuple:
    return tuple(np.eye(ndim).ravel())


@dataclass
class MedicalImage:
    """A voxel array with physical-space geometry (LPS frame, sitk-style).

    ``data`` is indexed ``[x, y, z]`` (or ``[x, y]`` in 2D); ``spacing``,
    ``origin`` are length-``ndim`` tuples in (x, y, z) order; ``direction``
    is the row-major flattened ``ndim x ndim`` direction-cosine matrix whose
    *columns* are the world directions of the image axes (SimpleITK
    convention).
    """

    data: np.ndarray
    spacing: tuple = ()
    origin: tuple = ()
    direction: tuple = ()
    metadata: dict = field(default_factory=dict)

    def __post_init__(self):
        nd = self.data.ndim
        if not self.spacing:
            self.spacing = (1.0,) * nd
        if not self.origin:
            self.origin = (0.0,) * nd
        if not self.direction:
            self.direction = _identity_direction(nd)
        self.spacing = tuple(float(s) for s in self.spacing)
        self.origin = tuple(float(o) for o in self.origin)
        self.direction = tuple(float(d) for d in self.direction)

    # --- SimpleITK-compatible accessors (reference code reads these names) ---
    def GetSize(self) -> tuple:
        return tuple(int(s) for s in self.data.shape)

    def GetSpacing(self) -> tuple:
        return self.spacing

    def GetOrigin(self) -> tuple:
        return self.origin

    def GetDirection(self) -> tuple:
        return self.direction

    @property
    def ndim(self) -> int:
        return self.data.ndim

    def direction_matrix(self) -> np.ndarray:
        n = self.ndim
        return np.asarray(self.direction, dtype=np.float64).reshape(n, n)

    def index_to_world_matrix(self) -> np.ndarray:
        """(n+1)x(n+1) homogeneous affine: world = A @ [index, 1] (LPS)."""
        n = self.ndim
        A = np.eye(n + 1)
        A[:n, :n] = self.direction_matrix() * np.asarray(self.spacing)
        A[:n, n] = self.origin
        return A

    def TransformPhysicalPointToIndex(self, point) -> tuple:
        n = self.ndim
        A = self.index_to_world_matrix()
        inv = np.linalg.inv(A)
        p = np.append(np.asarray(point, dtype=np.float64), 1.0)
        idx = inv @ p
        return tuple(int(round(v)) for v in idx[:n])

    def TransformIndexToPhysicalPoint(self, index) -> tuple:
        n = self.ndim
        A = self.index_to_world_matrix()
        p = A @ np.append(np.asarray(index, dtype=np.float64), 1.0)
        return tuple(float(v) for v in p[:n])

    def copy_geometry_from(self, other: "MedicalImage") -> "MedicalImage":
        self.spacing = other.spacing
        self.origin = other.origin
        self.direction = other.direction
        return self

    def astype(self, dtype) -> "MedicalImage":
        return MedicalImage(self.data.astype(dtype), self.spacing, self.origin,
                            self.direction, dict(self.metadata))

    def same_geometry(self, other: "MedicalImage", tol: float = 1e-4) -> bool:
        return (
            self.GetSize() == other.GetSize()
            and np.allclose(self.spacing, other.spacing, atol=tol)
            and np.allclose(self.direction, other.direction, atol=tol)
        )

    def like(self, data: np.ndarray) -> "MedicalImage":
        """New image with this geometry and the given array."""
        return MedicalImage(data, self.spacing, self.origin, self.direction,
                            dict(self.metadata))


def new_image_like(ref: MedicalImage, data: np.ndarray) -> MedicalImage:
    return ref.like(data)


def zeros_like_geometry(ref: MedicalImage, dtype=np.uint8) -> MedicalImage:
    """Empty image sharing geometry — the reference's empty-label creation
    (`model.py:1199-1204`)."""
    return ref.like(np.zeros(ref.GetSize(), dtype=dtype))


# ---------------------------------------------------------------------------
# NIfTI-1 parsing
# ---------------------------------------------------------------------------


def _quaternion_to_matrix(b: float, c: float, d: float, qfac: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
    ])
    R[:, 2] *= qfac
    return R


def _open_maybe_gz(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_image(path: str) -> MedicalImage:
    """Read a .nii / .nii.gz file into a MedicalImage (LPS geometry).

    Equivalent of ``sitk.ReadImage`` as used at
    reference `pipeline/NiftiDataset3D.py:74`.
    """
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()

    hdr = raw[:_HDR_SIZE]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr == _HDR_SIZE:
        endian = "<"
    elif struct.unpack_from(">i", hdr, 0)[0] == _HDR_SIZE:
        endian = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, hdr, off)

    dim = u("8h", 40)
    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = u("h", 70)[0]
    pixdim = u("8f", 76)
    vox_offset = int(u("f", 108)[0])
    scl_slope = u("f", 112)[0]
    scl_inter = u("f", 116)[0]
    qform_code = u("h", 252)[0]
    sform_code = u("h", 254)[0]
    quatern = u("3f", 256)
    qoffset = u("3f", 268)
    srow_x = u("4f", 280)
    srow_y = u("4f", 296)
    srow_z = u("4f", 312)
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    if datatype not in _DTYPE_FROM_CODE:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    np_dtype = np.dtype(_DTYPE_FROM_CODE[datatype]).newbyteorder(endian)

    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    # NIfTI stores x fastest: Fortran order for [x, y, z, ...] indexing.
    data = np.asarray(data).reshape(shape, order="F")
    data = data.astype(data.dtype.newbyteorder("="), copy=False)

    if scl_slope not in (0.0, 1.0) or scl_inter not in (0.0,):
        if scl_slope == 0.0:
            scl_slope = 1.0
        data = data.astype(np.float32) * np.float32(scl_slope) + np.float32(scl_inter)

    # Build the RAS affine, preferring sform.
    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        R = _quaternion_to_matrix(*quatern, qfac)
        affine = np.eye(4)
        affine[:3, :3] = R * np.asarray(pixdim[1:4])
        affine[:3, 3] = qoffset
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    # NIfTI affines are RAS; SimpleITK (and thus the reference's geometry
    # checks) work in LPS. Flip the first two world axes.
    lps = affine.copy()
    lps[0, :] *= -1.0
    lps[1, :] *= -1.0

    nspatial = min(ndim, 3)
    M = lps[:3, :3]
    spacing3 = np.linalg.norm(M, axis=0)
    spacing3[spacing3 == 0] = 1.0
    direction3 = M / spacing3

    # Squeeze trailing singleton dims beyond 3 (e.g. shape (X, Y, Z, 1)).
    while data.ndim > 3 and data.shape[-1] == 1:
        data = data[..., 0]

    if data.ndim == 2 or (ndim == 2):
        if data.ndim > 2:
            data = data.reshape(data.shape[:2])
        spacing = tuple(spacing3[:2])
        origin = tuple(lps[:2, 3])
        direction = tuple(direction3[:2, :2].ravel())
    else:
        spacing = tuple(spacing3[:nspatial]) if nspatial == 3 else tuple(spacing3)
        origin = tuple(lps[:3, 3])
        direction = tuple(direction3.ravel())

    return MedicalImage(data, spacing, origin, direction,
                        metadata={"source_path": str(path)})


def write_image(image: MedicalImage, path: str) -> None:
    """Write a MedicalImage to .nii / .nii.gz (sform-only NIfTI-1).

    Equivalent of ``sitk.ImageFileWriter`` at reference `model.py:1226-1230`.
    """
    data = np.asarray(image.data)
    nd = data.ndim
    if nd not in (2, 3, 4):
        raise ValueError(f"cannot write {nd}-D image")

    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODE_FROM_DTYPE:
        data = data.astype(np.float32)
    datatype = _CODE_FROM_DTYPE[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    dim = [nd] + list(data.shape) + [1] * (7 - nd)
    spacing = list(image.spacing) + [1.0] * (3 - len(image.spacing))
    pixdim = [1.0] + [float(s) for s in spacing] + [1.0] * 4
    pixdim = pixdim[:8]

    # Assemble LPS affine then convert to RAS for the sform rows.
    n = min(nd, 3)
    D = np.eye(3)
    D[:n, :n] = image.direction_matrix()[:n, :n]
    lps = np.eye(4)
    lps[:3, :3] = D * np.asarray(spacing[:3])
    origin = list(image.origin) + [0.0] * (3 - len(image.origin))
    lps[:3, 3] = origin[:3]
    ras = lps.copy()
    ras[0, :] *= -1.0
    ras[1, :] *= -1.0

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 0)      # qform_code: none
    struct.pack_into("<h", hdr, 254, 2)      # sform_code: aligned
    struct.pack_into("<4f", hdr, 280, *ras[0])
    struct.pack_into("<4f", hdr, 296, *ras[1])
    struct.pack_into("<4f", hdr, 312, *ras[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
