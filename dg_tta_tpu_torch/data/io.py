"""Multi-format medical-image IO (NIfTI-1/2, MetaImage .mha, NRRD).

The reference reads/writes via nnUNet's SimpleITKIO
(upstream DG-TTA dg_tta/tta/tta.py:21,141,413; ipynb_utils.py:19-27), which
accepts whatever `dataset.json`'s `file_ending` names.  Neither SimpleITK
nor nibabel ship in this image, so these are from-scratch codecs for the
formats that cover SimpleITKIO's practical surface in nnUNet datasets:

  .nii / .nii.gz   NIfTI-1 and NIfTI-2 (read), NIfTI-1 (write) — nifti.py
  .mha             MetaImage, raw or zlib-compressed (read + write)
  .nrrd            NRRD, raw or gzip encoding (read + write)

All readers return the same contract as `nifti.read_nifti`: data
(C, D, H, W) float32 with D=z slowest, and props with "spacing" (z, y, x),
"affine" (4, 4), "original_dtype".  `read_image`/`write_image` dispatch on
the file ending and raise `UnsupportedImageFormat` (listing the supported
endings) otherwise, so an unsupported `file_ending` fails loudly at
prepare time instead of mid-pipeline.
"""

import gzip
import re
import zlib
from pathlib import Path

import numpy as np

from dg_tta_tpu_torch.data.nifti import read_nifti, write_nifti

SUPPORTED_ENDINGS = (".nii.gz", ".nii", ".mha", ".nrrd")


class UnsupportedImageFormat(ValueError):
    def __init__(self, path_or_ending):
        super().__init__(
            f"Unsupported image format for {path_or_ending!r}: supported "
            f"file endings are {', '.join(SUPPORTED_ENDINGS)} "
            f"(SimpleITK/nibabel are not available in this environment; "
            f"convert other formats to one of these first)")


def file_ending_of(path) -> str:
    name = str(path).lower()
    for e in SUPPORTED_ENDINGS:
        if name.endswith(e):
            return e
    return "".join(Path(name).suffixes)


def check_file_ending_supported(ending: str):
    """Loud prepare-time gate for dataset.json's `file_ending`."""
    if ending.lower() not in SUPPORTED_ENDINGS:
        raise UnsupportedImageFormat(ending)


# ---------------------------------------------------------------- MetaImage

_MET_DTYPES = {
    "MET_UCHAR": np.uint8, "MET_CHAR": np.int8,
    "MET_USHORT": np.uint16, "MET_SHORT": np.int16,
    "MET_UINT": np.uint32, "MET_INT": np.int32,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_CODES = {np.dtype(v): k for k, v in _MET_DTYPES.items()}


def read_mha(path):
    """MetaImage (.mha, header+data in one file; raw or zlib data)."""
    raw = Path(path).read_bytes()
    # header = ASCII "Key = Value" lines until ElementDataFile
    hdr = {}
    pos = 0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii", "replace").strip()
        pos = nl + 1
        if not line:
            continue
        k, _, v = line.partition("=")
        k, v = k.strip(), v.strip()
        hdr[k] = v
        if k == "ElementDataFile":
            break
    if hdr.get("ObjectType", "Image") != "Image":
        raise ValueError(f"Not a MetaImage image: {path}")
    if hdr.get("ElementDataFile", "LOCAL") != "LOCAL":
        raise ValueError(f"Detached MetaImage data files not supported: "
                         f"{path}")
    ndims = int(hdr.get("NDims", 3))
    sizes = [int(x) for x in hdr["DimSize"].split()]  # x y z [t]
    if ndims > 3 and any(s > 1 for s in sizes[3:]):
        raise UnsupportedImageFormat(
            f"{path} (temporal/{ndims}-D MetaImage with non-trivial 4th "
            f"dimension {sizes[3:]}; only 2-D/3-D volumes are supported)")
    n_chan = int(hdr.get("ElementNumberOfChannels", 1))
    dtype = np.dtype(_MET_DTYPES[hdr["ElementType"]])
    if hdr.get("BinaryDataByteOrderMSB", "False").lower() == "true" or \
            hdr.get("ElementByteOrderMSB", "False").lower() == "true":
        dtype = dtype.newbyteorder(">")
    spacing_xyz = [float(x) for x in hdr.get(
        "ElementSpacing", hdr.get("ElementSize", "1 1 1")).split()]
    offset = [float(x) for x in hdr.get(
        "Offset", hdr.get("Position", "0 0 0")).split()]
    tmat = [float(x) for x in hdr.get(
        "TransformMatrix", hdr.get("Orientation",
                                   "1 0 0 0 1 0 0 0 1")).split()]

    blob = raw[pos:]
    if hdr.get("CompressedData", "False").lower() == "true":
        blob = zlib.decompress(blob)
    count = int(np.prod(sizes)) * n_chan
    data = np.frombuffer(blob, dtype=dtype, count=count)
    # file order: x fastest, channels fastest of all when present
    if ndims == 3:
        nx, ny, nz = sizes
    elif ndims == 2:
        (nx, ny), nz = sizes, 1
    else:
        nx, ny, nz = sizes[0], sizes[1], sizes[2]
    arr = data.reshape(nz, ny, nx, n_chan)
    arr = np.moveaxis(arr, -1, 0).astype(np.float32)  # (C, D, H, W)

    affine = np.eye(4)
    affine[:3, :3] = (np.asarray(tmat, np.float64).reshape(3, 3).T
                      * np.asarray(spacing_xyz)[None, :])
    affine[:3, 3] = offset
    props = {
        "spacing": (float(spacing_xyz[2] if len(spacing_xyz) > 2 else 1.0),
                    float(spacing_xyz[1]), float(spacing_xyz[0])),
        "affine": affine,
        "original_dtype": np.dtype(dtype).name.lstrip(">"),
    }
    return arr, props


def write_mha(path, data, props=None, dtype=None, compressed=True):
    data = np.asarray(data)
    if data.ndim == 3:
        data = data[None]
    C, D, H, W = data.shape
    if dtype is None:
        dtype = (np.uint8 if np.issubdtype(data.dtype, np.integer)
                 else np.float32)
    dtype = np.dtype(dtype)
    if dtype not in _MET_CODES:
        raise ValueError(f"Unsupported MetaImage write dtype {dtype}")
    out = np.moveaxis(data.astype(dtype), 0, -1)  # (D, H, W, C), x fastest

    props = props or {}
    spacing = props.get("spacing", (1.0, 1.0, 1.0))  # (z, y, x)
    affine = np.asarray(props.get(
        "affine", np.diag([spacing[2], spacing[1], spacing[0], 1.0])),
        np.float64)
    sp_xyz = np.asarray([spacing[2], spacing[1], spacing[0]], np.float64)
    rot = affine[:3, :3] / np.where(sp_xyz[None, :] == 0, 1.0, sp_xyz[None, :])

    blob = out.tobytes()
    if compressed:
        blob = zlib.compress(blob)
    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        "TransformMatrix = " + " ".join(f"{v:g}"
                                        for v in rot.T.reshape(-1)),
        "Offset = " + " ".join(f"{v:g}" for v in affine[:3, 3]),
        "CenterOfRotation = 0 0 0",
        "ElementSpacing = " + " ".join(f"{v:g}" for v in sp_xyz),
        f"DimSize = {W} {H} {D}",
    ]
    if C > 1:
        lines.append(f"ElementNumberOfChannels = {C}")
    lines += [
        f"ElementType = {_MET_CODES[dtype]}",
        "ElementDataFile = LOCAL",
    ]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(blob)


# -------------------------------------------------------------------- NRRD

_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "signed short": np.int16, "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "float": np.float32, "double": np.float64,
}
_NRRD_CODES = {np.uint8: "uint8", np.int8: "int8", np.int16: "int16",
               np.uint16: "uint16", np.int32: "int32", np.uint32: "uint32",
               np.float32: "float", np.float64: "double"}


def _parse_vectors(s):
    """'(a,b,c) (d,e,f) none' -> list of float triples / None."""
    out = []
    for tok in re.findall(r"\(([^)]*)\)|none", s):
        out.append(None if tok == "" else
                   [float(x) for x in tok.replace(",", " ").split()])
    return out


def read_nrrd(path):
    """NRRD (.nrrd single-file; raw or gzip encoding)."""
    raw = Path(path).read_bytes()
    if not raw.startswith(b"NRRD"):
        raise ValueError(f"Not a NRRD file: {path}")
    # Header/data boundary: the EARLIEST of a blank LF line and a blank
    # CRLF line wins.  Preferring b"\n\n" anywhere in the file would land
    # inside the binary payload for CRLF-terminated headers (valid per
    # spec) whose payload happens to contain 0x0a 0x0a.
    p_lf, p_crlf = raw.find(b"\n\n"), raw.find(b"\r\n\r\n")
    if p_lf < 0 and p_crlf < 0:
        raise ValueError(f"NRRD header/data boundary not found: {path}")
    if p_crlf >= 0 and (p_lf < 0 or p_crlf < p_lf):
        end, skip = p_crlf, 4
    else:
        end, skip = p_lf, 2
    hdr_text = raw[:end].decode("ascii", "replace")
    fields = {}
    for line in hdr_text.splitlines()[1:]:
        if not line or line.startswith("#"):
            continue
        k, _, v = line.partition(":")
        fields[k.strip().lower()] = v.lstrip("= ").strip()
    sizes = [int(x) for x in fields["sizes"].split()]  # fastest first
    dtype = np.dtype(_NRRD_DTYPES[fields["type"].lower()])
    if fields.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    enc = fields.get("encoding", "raw").lower()
    blob = raw[end + skip:]
    if enc in ("gzip", "gz"):
        blob = gzip.decompress(blob)
    elif enc in ("zlib",):
        blob = zlib.decompress(blob)
    elif enc not in ("raw",):
        raise ValueError(f"Unsupported NRRD encoding {enc!r}: {path}")
    data = np.frombuffer(blob, dtype=dtype, count=int(np.prod(sizes)))

    kinds = fields.get("kinds", "").split()
    n_chan = 1
    spatial = sizes
    if len(sizes) == 4:
        # one non-spatial (channel/list/vector) axis, fastest first by
        # convention in ITK-written files
        chan_axis = 0
        for i, k in enumerate(kinds):
            if k.lower() not in ("domain", "space"):
                chan_axis = i
        n_chan = sizes[chan_axis]
        spatial = [s for i, s in enumerate(sizes) if i != chan_axis]
        # reshape fastest-first: reversed order, then move channels first
        arr = data.reshape(tuple(reversed(sizes)))
        arr = np.moveaxis(arr, len(sizes) - 1 - chan_axis, 0)
    else:
        arr = data.reshape(tuple(reversed(spatial)))[None]
    arr = arr.astype(np.float32)  # (C, D, H, W): sizes are (x, y, z)

    dirs = _parse_vectors(fields.get("space directions", ""))
    dirs = [d for d in dirs if d is not None]
    origin = _parse_vectors(fields.get("space origin", "(0,0,0)"))
    origin = origin[0] if origin and origin[0] is not None else [0.0] * 3
    affine = np.eye(4)
    if len(dirs) == 3:
        affine[:3, :3] = np.asarray(dirs, np.float64).T
    affine[:3, 3] = origin
    sp_xyz = (np.linalg.norm(affine[:3, :3], axis=0)
              if len(dirs) == 3 else np.ones(3))
    spacings = fields.get("spacings")
    if len(dirs) != 3 and spacings:
        sp = [float(x) for x in spacings.split()]
        sp = [s for s in sp if np.isfinite(s)][-3:]
        if len(sp) == 3:
            sp_xyz = np.asarray(sp)
            affine[:3, :3] = np.diag(sp_xyz)
    props = {
        "spacing": (float(sp_xyz[2]), float(sp_xyz[1]), float(sp_xyz[0])),
        "affine": affine,
        "original_dtype": np.dtype(dtype).name.lstrip(">"),
    }
    return arr, props


def write_nrrd(path, data, props=None, dtype=None, compressed=True):
    data = np.asarray(data)
    if data.ndim == 3:
        data = data[None]
    C, D, H, W = data.shape
    if dtype is None:
        dtype = (np.uint8 if np.issubdtype(data.dtype, np.integer)
                 else np.float32)
    dtype = np.dtype(dtype)
    if dtype.type not in _NRRD_CODES:
        raise ValueError(f"Unsupported NRRD write dtype {dtype}")
    props = props or {}
    spacing = props.get("spacing", (1.0, 1.0, 1.0))  # (z, y, x)
    affine = np.asarray(props.get(
        "affine", np.diag([spacing[2], spacing[1], spacing[0], 1.0])),
        np.float64)
    dirs = affine[:3, :3].T  # row i = direction of axis i (x, y, z)

    out = data.astype(dtype)
    if C > 1:
        sizes = [C, W, H, D]
        kinds = "list domain domain domain"
        dir_strs = ["none"] + [
            "(" + ",".join(f"{v:.17g}" for v in d) + ")" for d in dirs]
        payload = np.moveaxis(out, 0, -1)  # (D,H,W,C): C fastest
    else:
        sizes = [W, H, D]
        kinds = "domain domain domain"
        dir_strs = ["(" + ",".join(f"{v:.17g}" for v in d) + ")"
                    for d in dirs]
        payload = out[0]
    blob = payload.tobytes()
    if compressed:
        blob = gzip.compress(blob)
    lines = [
        "NRRD0004",
        f"type: {_NRRD_CODES[dtype.type]}",
        f"dimension: {len(sizes)}",
        "space: left-posterior-superior",
        "sizes: " + " ".join(str(s) for s in sizes),
        "space directions: " + " ".join(dir_strs),
        f"kinds: {kinds}",
        "endian: little",
        f"encoding: {'gzip' if compressed else 'raw'}",
        "space origin: (" + ",".join(f"{v:.17g}" for v in affine[:3, 3])
        + ")",
    ]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(blob)


# ---------------------------------------------------------------- dispatch

def read_image(path):
    """Format-dispatching reader; same (data, props) contract as
    `read_nifti`."""
    ending = file_ending_of(path)
    if ending in (".nii", ".nii.gz"):
        return read_nifti(path)
    if ending == ".mha":
        return read_mha(path)
    if ending == ".nrrd":
        return read_nrrd(path)
    raise UnsupportedImageFormat(str(path))


def write_image(path, data, props=None, dtype=None):
    """Format-dispatching writer; the format follows the file ending."""
    ending = file_ending_of(path)
    if ending in (".nii", ".nii.gz"):
        return write_nifti(path, data, props, dtype=dtype)
    if ending == ".mha":
        return write_mha(path, data, props, dtype=dtype)
    if ending == ".nrrd":
        return write_nrrd(path, data, props, dtype=dtype)
    raise UnsupportedImageFormat(str(path))
