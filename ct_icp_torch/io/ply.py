"""Self-contained PLY point-cloud reader/writer (numpy only).

Host copy of ``ct_icp_tpu/io/ply.py`` (numpy only, nothing of the JAX
package imported).

Covers the capability of the reference's tinyply-based I/O layer
(reference include/SlamCore/io.h:1-239, src/SlamCore/io.cxx): reading the
datasets' per-frame PLY files (binary little/big endian and ascii, arbitrary
vertex properties) and writing point clouds / poses as PLY. The schema-mapper
role of PLYSchemaMapper collapses to: every vertex property becomes a named
numpy column.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TO_NUMPY = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NUMPY_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY file -> {property_name: column} for the 'vertex' element.

    List properties are skipped (not used by the supported datasets).
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    cur = None
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur[2].append(("__list__", tok[-1]))
            else:
                cur[2].append((tok[1], tok[2]))

    if fmt is None:
        raise ValueError(f"{path}: missing PLY format line")

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        text = body.decode("ascii")
        rows = text.split()
        offset = 0
        for name, count, props in elements:
            ncol = len(props)
            vals = np.asarray(rows[offset:offset + count * ncol], dtype=np.float64)
            offset += count * ncol
            if name == "vertex":
                vals = vals.reshape(count, ncol)
                for i, (ptype, pname) in enumerate(props):
                    if ptype != "__list__":
                        out[pname] = vals[:, i]
        return out

    endian = "<" if fmt == "binary_little_endian" else ">"
    offset = 0
    for name, count, props in elements:
        if any(p[0] == "__list__" for p in props):
            if name == "vertex":
                raise ValueError(f"{path}: list properties on vertex unsupported")
            break  # cannot compute stride past a list element; stop here
        dt = np.dtype([(pname, endian + _PLY_TO_NUMPY[ptype])
                       for ptype, pname in props])
        nbytes = dt.itemsize * count
        if name == "vertex":
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            for _, pname in props:
                out[pname] = np.ascontiguousarray(arr[pname])
        offset += nbytes
    return out


def read_ply_xyzt(path, xyz_names=("x", "y", "z"),
                  time_names=("timestamp", "t", "time", "scalar_timestamp")
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read xyz (+timestamps if present) from a PLY file.

    Uses the native decoder (io/native.py) when available; falls back to the
    pure-Python parser for ascii/exotic files.
    """
    if xyz_names == ("x", "y", "z"):
        from ct_icp_torch.io import native
        out = native.ply_read_xyzt(path) if native.available() else None
        if out is not None:
            return out
    cols = read_ply(path)
    missing = [n for n in xyz_names if n not in cols]
    if missing:
        raise ValueError(f"{path}: missing properties {missing}; has {list(cols)}")
    xyz = np.stack([np.asarray(cols[n], np.float64) for n in xyz_names], axis=-1)
    ts = None
    for tn in time_names:
        if tn in cols:
            ts = np.asarray(cols[tn], np.float64)
            break
    return xyz, ts


def write_ply(path, columns: Dict[str, np.ndarray]):
    """Write named equal-length columns as a binary_little_endian PLY."""
    names = list(columns)
    n = len(np.asarray(columns[names[0]]))
    cols = {k: np.asarray(v) for k, v in columns.items()}
    dt = np.dtype([
        (k, "<" + np.dtype(cols[k].dtype).str.lstrip("<>=|")) for k in names])
    rec = np.empty(n, dtype=dt)
    for k in names:
        rec[k] = cols[k]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            ply_t = _NUMPY_TO_PLY[np.dtype(cols[k].dtype).name]
            f.write(f"property {ply_t} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def write_ply_xyzt(path, xyz: np.ndarray, timestamps: Optional[np.ndarray] = None,
                   dtype=np.float32):
    cols = {
        "x": xyz[:, 0].astype(dtype),
        "y": xyz[:, 1].astype(dtype),
        "z": xyz[:, 2].astype(dtype),
    }
    if timestamps is not None:
        cols["timestamp"] = np.asarray(timestamps, np.float64)
    write_ply(path, cols)


def save_poses_as_ply(path, positions: np.ndarray):
    """Trajectory positions as a PLY point cloud
    (reference SavePosesAsPLY, io.h:218-229)."""
    write_ply(path, {
        "x": positions[:, 0].astype(np.float32),
        "y": positions[:, 1].astype(np.float32),
        "z": positions[:, 2].astype(np.float32),
    })
