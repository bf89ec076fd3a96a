"""Minimal native NIfTI-1/2 IO (.nii / .nii.gz).

The reference reads/writes via nnUNet's SimpleITKIO
(upstream DG-TTA dg_tta/tta/tta.py:21,141,413,440-447); neither SimpleITK nor
nibabel ship in this image, so this is a from-scratch NIfTI codec covering
what the pipeline needs: scalar 3D (or 4D multi-channel) volumes, voxel
spacing, and geometry (sform affine) preserved through a read→write
roundtrip.  Both header versions are read (NIfTI-1 348-byte and NIfTI-2
540-byte, either endianness); writes default to NIfTI-1 (universally
readable) with `version=2` opt-in.

Array convention: volumes are returned (C, D, H, W) with D=z slowest — the
same array order nnUNet sees from SimpleITK's GetArrayFromImage — and
`props["spacing"]` is (z, y, x), matching nnUNet's props contract.
"""

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348     # NIfTI-1
HDR2_SIZE = 540    # NIfTI-2


def _open(path, mode="rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _parse_header(hdr, path):
    """Decode a NIfTI-1 or NIfTI-2 header (either endianness).

    Returns (shape_xyzt, datatype, pixdim, vox_offset, scl_slope, scl_inter,
    sform_code, srow(3,4), swapped).
    """
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    swapped = False
    if sizeof_hdr not in (HDR_SIZE, HDR2_SIZE):
        sizeof_hdr = struct.unpack_from(">i", hdr, 0)[0]
        if sizeof_hdr in (HDR_SIZE, HDR2_SIZE):
            swapped = True  # big-endian file: swap header fields + data
        else:
            raise ValueError(f"Not a NIfTI-1/2 file: {path}")
    end = ">" if swapped else "<"

    def unpack(fmt, off):
        return struct.unpack_from(end + fmt, hdr, off)

    if sizeof_hdr == HDR_SIZE:  # NIfTI-1 field layout
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"Bad NIfTI-1 magic {magic!r}: {path}")
        dim = unpack("8h", 40)
        datatype = unpack("h", 70)[0]
        pixdim = unpack("8f", 76)
        vox_offset = int(unpack("f", 108)[0])
        scl_slope = unpack("f", 112)[0]
        scl_inter = unpack("f", 116)[0]
        sform_code = unpack("h", 254)[0]
        srow = np.array(unpack("12f", 280), np.float64).reshape(3, 4)
    else:  # NIfTI-2: magic at 4, 64-bit dims/pixdims, doubles for scaling
        magic = hdr[4:12]
        if magic[:3] not in (b"n+2", b"ni2"):
            raise ValueError(f"Bad NIfTI-2 magic {magic!r}: {path}")
        datatype = unpack("h", 12)[0]
        dim = unpack("8q", 16)
        pixdim = unpack("8d", 104)
        vox_offset = int(unpack("q", 168)[0])
        scl_slope = unpack("d", 176)[0]
        scl_inter = unpack("d", 184)[0]
        sform_code = unpack("i", 348)[0]
        srow = np.array(unpack("12d", 400), np.float64).reshape(3, 4)

    ndim = dim[0]
    shape_xyzt = [max(1, int(d)) for d in dim[1: 1 + max(4, ndim)]][:4]
    return (shape_xyzt, datatype, pixdim, vox_offset, scl_slope, scl_inter,
            sform_code, srow, swapped)


def read_nifti(path):
    """Read a NIfTI-1 or NIfTI-2 file.

    Returns:
      data: (C, D, H, W) float32 array (C=1 for scalar images; a 4th NIfTI
        dim becomes the channel axis).
      props: dict with "spacing" (z, y, x), "affine" (4, 4) from the sform
        (or a spacing-diagonal fallback), "original_dtype".
    """
    with _open(path) as f:
        raw = f.read()
    (shape_xyzt, datatype, pixdim, vox_offset, scl_slope, scl_inter,
     sform_code, srow, swapped) = _parse_header(raw[:HDR2_SIZE], path)

    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype {datatype}: {path}")
    np_dtype = np.dtype(_DTYPES[datatype])
    if swapped:
        np_dtype = np_dtype.newbyteorder(">")

    nx, ny, nz, nt = shape_xyzt
    count = nx * ny * nz * nt
    data = np.frombuffer(raw, dtype=np_dtype, count=count,
                         offset=vox_offset).astype(np.float32)
    if scl_slope not in (0.0, 1.0):
        data = data * scl_slope + scl_inter
    elif scl_inter not in (0.0,):
        data = data + scl_inter
    # NIfTI stores x fastest: file order is [t][z][y][x]
    data = data.reshape(nt, nz, ny, nx)

    sx, sy, sz = pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0
    if sform_code > 0:
        affine = np.eye(4)
        affine[:3] = srow
    else:
        affine = np.diag([sx, sy, sz, 1.0])
    props = {
        "spacing": (float(sz), float(sy), float(sx)),
        "affine": affine,
        "original_dtype": np.dtype(np_dtype).name,
    }
    return data, props


def write_nifti(path, data, props=None, dtype=None, version=1):
    """Write a (D, H, W) or (C, D, H, W) array as NIfTI-1 (or -2).

    Geometry comes from props["affine"] / props["spacing"] when given.
    `version=2` emits the 540-byte NIfTI-2 header (64-bit dims) — the
    pipeline default stays NIfTI-1, which every consumer reads.
    """
    data = np.asarray(data)
    if data.ndim == 3:
        data = data[None]
    C, D, H, W = data.shape
    if dtype is None:
        dtype = np.uint8 if np.issubdtype(data.dtype, np.integer) else np.float32
    dtype = np.dtype(dtype)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"Unsupported write dtype {dtype}")
    if version not in (1, 2):
        raise ValueError(f"NIfTI version must be 1 or 2, got {version}")
    out = data.astype(dtype)

    props = props or {}
    spacing = props.get("spacing", (1.0, 1.0, 1.0))  # (z, y, x)
    affine = np.asarray(props.get(
        "affine", np.diag([spacing[2], spacing[1], spacing[0], 1.0])))

    ndim = 3 if C == 1 else 4
    dims = [ndim, W, H, D, C if C > 1 else 1, 1, 1, 1]
    pixdims = [1.0, float(spacing[2]), float(spacing[1]), float(spacing[0]),
               1.0, 1.0, 1.0, 1.0]

    if version == 1:
        hdr = bytearray(HDR_SIZE)
        struct.pack_into("<i", hdr, 0, HDR_SIZE)
        struct.pack_into("<8h", hdr, 40, *dims)
        struct.pack_into("<h", hdr, 70, _DTYPE_CODES[dtype])
        struct.pack_into("<h", hdr, 72, out.dtype.itemsize * 8)  # bitpix
        struct.pack_into("<8f", hdr, 76, *pixdims)
        struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
        struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
        struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
        struct.pack_into("<h", hdr, 252, 1)      # qform_code (identity quat)
        struct.pack_into("<h", hdr, 254, 1)      # sform_code
        struct.pack_into("<3f", hdr, 268, float(affine[0, 3]),
                         float(affine[1, 3]), float(affine[2, 3]))  # qoffset
        struct.pack_into("<12f", hdr, 280, *affine[:3].reshape(-1).tolist())
        hdr[344:348] = b"n+1\x00"
        payload = bytes(hdr) + b"\x00" * 4 + out.tobytes()  # extension pad
    else:
        hdr = bytearray(HDR2_SIZE)
        struct.pack_into("<i", hdr, 0, HDR2_SIZE)
        hdr[4:12] = b"n+2\x00\r\n\x1a\n"
        struct.pack_into("<h", hdr, 12, _DTYPE_CODES[dtype])
        struct.pack_into("<h", hdr, 14, out.dtype.itemsize * 8)  # bitpix
        struct.pack_into("<8q", hdr, 16, *dims)
        struct.pack_into("<8d", hdr, 104, *pixdims)
        struct.pack_into("<q", hdr, 168, HDR2_SIZE + 4)  # vox_offset
        struct.pack_into("<d", hdr, 176, 1.0)            # scl_slope
        struct.pack_into("<d", hdr, 184, 0.0)            # scl_inter
        struct.pack_into("<i", hdr, 344, 1)              # qform_code
        struct.pack_into("<i", hdr, 348, 1)              # sform_code
        struct.pack_into("<3d", hdr, 376, float(affine[0, 3]),
                         float(affine[1, 3]), float(affine[2, 3]))  # qoffset
        struct.pack_into("<12d", hdr, 400, *affine[:3].reshape(-1).tolist())
        payload = bytes(hdr) + b"\x00" * 4 + out.tobytes()

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with _open(path, "wb") as f:
        f.write(payload)
