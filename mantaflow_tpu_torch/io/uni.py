"""Mantaflow-compatible file IO: .uni / .raw / .npz / .txt / .obj.

Format-compatible with the reference's zlib-gzipped .uni files
(``source/fileio/iogrids.cpp``: 'MNT3' magic + 288-byte header
{dimX,dimY,dimZ,gridType,elementType,bytesPerElement,info[252],dimT,
timestamp}, payload in C-order (z,y,x[,c]) float32/int32;
``ioparticles.cpp``: 'PB02' particle blocks of (float3 pos, int flag),
'PD01' pdata blocks) so files round-trip with the reference and its
tensorflow/tools/uniio.py readers.

All IO is host-side Python — the TPU framework's state is just arrays, so
no native IO runtime is needed (SURVEY.md §2.15 item 7).
"""

from __future__ import annotations

import gzip
import struct
import time

import numpy as np

_HEADER_FMT = "iiiiii252siQ"  # MNT3 (v4) header, 288 bytes
_PART_HEADER_FMT = "iiiiii256sQ"  # PB02/PD01 header, 288 bytes

# GridBase::GridType bits (grid.h:29)
TypeNone = 0
TypeInt = 1
TypeReal = 2
TypeVec3 = 4
TypeMAC = 8
TypeLevelset = 16
TypeFlags = 32

_INFO = b"mantaflow-tpu"


def _element_type(arr, grid_type: int):
    if arr.dtype == np.int32:
        return 0, 4
    if arr.ndim == 3:
        return 1, 4
    return 2, 12


def write_grid_uni(filename: str, data, grid_type: int = TypeReal,
                   info: bytes | str | None = None):
    """Write a grid ([z,y,x] scalar/int or (3,z,y,x) vec) as .uni.

    ``info`` fills the header's free-form 252-byte info field (the reference
    stamps its build string there, iogrids.cpp writeGridUni); the golden
    harness uses it to record the generating platform (tests/golden.py)."""
    arr = np.asarray(data)
    if arr.ndim == 4:  # (3,z,y,x) -> (z,y,x,3)
        arr = np.moveaxis(arr, 0, -1)
    etype, bpe = _element_type(arr, grid_type)
    if etype == 0:
        arr = arr.astype(np.int32)
    else:
        arr = arr.astype(np.float32)
    if info is None:
        info = _INFO
    elif isinstance(info, str):
        info = info.encode()
    sz, sy, sx = arr.shape[0], arr.shape[1], arr.shape[2]
    header = struct.pack(_HEADER_FMT, sx, sy, sz, grid_type, etype, bpe,
                         info[:252].ljust(252, b"\0"), 0, int(time.time()))
    with gzip.open(filename, "wb", compresslevel=1) as f:
        f.write(b"MNT3")
        f.write(header)
        f.write(np.ascontiguousarray(arr).tobytes())


def read_grid_uni(filename: str):
    """Read a .uni grid; returns (data [z,y,x] or (3,z,y,x), header dict).
    Accepts MNT2 and MNT3 files (the reference's v3/v4)."""
    with gzip.open(filename, "rb") as f:
        magic = f.read(4)
        if magic in (b"MNT3", b"M4T3"):
            vals = struct.unpack(_HEADER_FMT, f.read(288))
            keys = ("dimX", "dimY", "dimZ", "gridType", "elementType",
                    "bytesPerElement", "info", "dimT", "timestamp")
        elif magic == b"MNT2":
            vals = struct.unpack("iiiiii256sQ", f.read(288))
            keys = ("dimX", "dimY", "dimZ", "gridType", "elementType",
                    "bytesPerElement", "info", "timestamp")
        else:
            raise ValueError(f"unknown uni header {magic!r}")
        h = dict(zip(keys, vals))
        raw = f.read()
    dt = np.int32 if h["elementType"] == 0 else np.float32
    data = np.frombuffer(raw, dtype=dt)
    shape = (h["dimZ"], h["dimY"], h["dimX"])
    if magic == b"M4T3":
        # 4D space-time grid (writeGrid4dUni, iogrids.cpp:622-675); Vec3/Vec4
        # both use elementType=2, channel count from bytesPerElement.
        shape = (h["dimT"],) + shape
        nc = h["bytesPerElement"] // 4
        if nc > 1:
            data = data.reshape(shape + (nc,))
            data = np.moveaxis(data, -1, 0)  # -> (C,t,z,y,x)
        else:
            data = data.reshape(shape)
    elif h["elementType"] == 2:
        data = data.reshape(shape + (3,))
        data = np.moveaxis(data, -1, 0)  # -> (3,z,y,x)
    else:
        data = data.reshape(shape)
    return data, h


def get_uni_file_size(filename: str):
    """getUniFileSize (iogrids.cpp:323-371): grid dims from a .uni header,
    (0, 0, 0) when the file is missing/unreadable."""
    import gzip
    import os
    if not os.path.isfile(filename):
        return (0, 0, 0)
    try:
        with gzip.open(filename, "rb") as f:
            magic = f.read(4)
            if magic not in (b"MNT3", b"PB02", b"PD01"):
                return (0, 0, 0)
            vals = struct.unpack("iii", f.read(12))
            if magic == b"MNT3":
                return tuple(vals)
            # particle headers store (dim, dimX, dimY); re-read accordingly
        with gzip.open(filename, "rb") as f:
            f.read(4)
            _, sx, sy, sz = struct.unpack("iiii", f.read(16))
            return (sx, sy, sz)
    except Exception:
        return (0, 0, 0)


def write_particles_uni(filename: str, positions, flags, grid_size):
    """PB02 particle block: interleaved (float3 pos, int32 flag)."""
    pos = np.asarray(positions, np.float32)
    flg = np.asarray(flags, np.int32)
    n = pos.shape[0]
    header = struct.pack(_PART_HEADER_FMT, n, grid_size[0], grid_size[1],
                         grid_size[2], 0, 16, _INFO.ljust(256, b"\0"),
                         int(time.time()))
    rec = np.empty((n, 4), np.float32)
    rec[:, :3] = pos
    rec[:, 3] = flg.view(np.float32)
    with gzip.open(filename, "wb", compresslevel=1) as f:
        f.write(b"PB02")
        f.write(header)
        f.write(np.ascontiguousarray(rec).tobytes())


def read_particles_uni(filename: str):
    """Returns (positions (N,3) f32, flags (N,) i32, header dict)."""
    with gzip.open(filename, "rb") as f:
        magic = f.read(4)
        if magic not in (b"PB01", b"PB02"):
            raise ValueError(f"unknown particle header {magic!r}")
        vals = struct.unpack(_PART_HEADER_FMT, f.read(288))
        keys = ("dim", "dimX", "dimY", "dimZ", "elementType",
                "bytesPerElement", "info", "timestamp")
        h = dict(zip(keys, vals))
        raw = f.read()
    rec = np.frombuffer(raw, np.float32).reshape(h["dim"], 4)
    pos = rec[:, :3].copy()
    flg = rec[:, 3].copy().view(np.int32)
    return pos, flg, h


def write_pdata_uni(filename: str, data, grid_size):
    """PD01 pdata block: per-particle real/int/vec3 channel. The reference
    writes elementType=1 for ALL pdata (ioparticles.cpp:238) — the payload
    type is distinguished only by bytesPerElement and the loading target."""
    arr = np.asarray(data)
    n = arr.shape[0]
    if arr.dtype.kind == "i":
        bpe = 4
        arr = arr.astype(np.int32)
    elif arr.ndim == 1:
        bpe = 4
        arr = arr.astype(np.float32)
    else:
        bpe = 12
        arr = arr.astype(np.float32)
    header = struct.pack(_PART_HEADER_FMT, n, grid_size[0], grid_size[1],
                         grid_size[2], 1, bpe, _INFO.ljust(256, b"\0"),
                         int(time.time()))
    with gzip.open(filename, "wb", compresslevel=1) as f:
        f.write(b"PD01")
        f.write(header)
        f.write(np.ascontiguousarray(arr).tobytes())


def read_pdata_uni(filename: str, dtype=None):
    """Read a PD01 channel. `dtype` (np.int32/np.float32) disambiguates
    4-byte payloads — like the reference, where the target pdata object's
    type decides (ioparticles.cpp:292); defaults to float32. Files written
    by older revisions of this writer (elementType 0=int/2=vec3) still load."""
    with gzip.open(filename, "rb") as f:
        magic = f.read(4)
        if magic != b"PD01":
            raise ValueError(f"unknown pdata header {magic!r}")
        vals = struct.unpack(_PART_HEADER_FMT, f.read(288))
        keys = ("dim", "dimX", "dimY", "dimZ", "elementType",
                "bytesPerElement", "info", "timestamp")
        h = dict(zip(keys, vals))
        raw = f.read()
    if h["elementType"] == 0:
        dt = np.int32
    elif h["bytesPerElement"] == 4 and dtype is not None:
        dt = dtype
    else:
        dt = np.float32
    data = np.frombuffer(raw, dtype=dt)
    if h["bytesPerElement"] == 12:
        data = data.reshape(h["dim"], 3)
    return data.copy(), h


# ---------------------------------------------------------------------------
# other formats (iogrids.cpp raw/txt; iomeshes.cpp obj)

def write_grid_raw(filename: str, data):
    arr = np.asarray(data)
    if arr.ndim == 4:
        arr = np.moveaxis(arr, 0, -1)
    with gzip.open(filename, "wb", compresslevel=1) as f:
        f.write(np.ascontiguousarray(arr).tobytes())


def read_grid_raw(filename: str, shape, dtype=np.float32, channels=1):
    with gzip.open(filename, "rb") as f:
        raw = f.read()
    data = np.frombuffer(raw, dtype=dtype)
    if channels == 3:
        data = data.reshape(tuple(shape) + (3,))
        return np.moveaxis(data, -1, 0)
    return data.reshape(tuple(shape))


_VOL_HDR = struct.Struct("<3sb5i6f")  # ID, version, encoding, dims, chans, bbox


def write_grid_vol(filename: str, data):
    """writeGridVol<Real> (fileio/iogrids.cpp:552): Mitsuba .vol — 48-byte
    header (VOL v3, encoding 1 = float32, unit bbox) + raw float payload in
    x-fastest order."""
    arr = np.asarray(data, np.float32)
    if arr.ndim != 3:
        raise ValueError(".vol: only single-channel Real grids supported "
                         "(reference iogrids.cpp:528 likewise)")
    sz, sy, sx = arr.shape
    with open(filename, "wb") as f:
        f.write(_VOL_HDR.pack(b"VOL", 3, 1, sx, sy, sz, 1,
                              -0.5, -0.5, -0.5, 0.5, 0.5, 0.5))
        f.write(arr.tobytes())


def read_grid_vol(filename: str):
    """readGridVol<Real> (fileio/iogrids.cpp:598)."""
    with open(filename, "rb") as f:
        hdr = f.read(_VOL_HDR.size)
        ident, ver, enc, sx, sy, sz, ch, *_ = _VOL_HDR.unpack(hdr)
        if ident != b"VOL":
            raise ValueError(f".vol: bad magic {ident!r}")
        if enc != 1 or ch != 1:
            raise ValueError(".vol: only float32 single-channel supported")
        payload = np.frombuffer(f.read(4 * sx * sy * sz), np.float32)
    return payload.reshape(sz, sy, sx)


def write_grid_txt(filename: str, data):
    arr = np.asarray(data)
    with open(filename, "w") as f:
        sz, sy, sx = arr.shape[:3]
        for k in range(sz):
            for j in range(sy):
                for i in range(sx):
                    f.write(f"{arr[k, j, i]}\n")


def write_mesh_obj(filename: str, nodes, tris, grid_size=None):
    """Wavefront OBJ (iomeshes.cpp:351 writeObjFile): 1-based vertex
    indices, vn normal lines, and — with grid_size — the reference's
    centered unit-cube world coordinates. (readObjFile reads coordinates
    raw, matching the reference's asymmetric convention.)"""
    nodes = np.asarray(nodes, np.float32)
    out = _to_world(nodes, grid_size) if grid_size is not None else nodes
    normals = compute_vertex_normals(nodes, tris)
    with open(filename, "w") as f:
        f.write("o MantaMesh\n")
        for p in out:
            f.write(f"v {p[0]} {p[1]} {p[2]} \n")
        for n in normals:
            f.write(f"vn {n[0]} {n[1]} {n[2]} \n")
        for t in np.asarray(tris):
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1} \n")


def read_mesh_obj(filename: str):
    nodes, tris = [], []
    with open(filename) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                nodes.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                tris.append(idx)
    return (np.asarray(nodes, np.float32),
            np.asarray(tris, np.int32).reshape(-1, 3))


def compute_vertex_normals(nodes, tris):
    """Mesh::computeVertexNormals (mesh.cpp:604-622): per-corner weights
    1/(l_prev*l_next) on the tri normal, then normalize."""
    nodes = np.asarray(nodes, np.float32)
    tris = np.asarray(tris, np.int64)
    normals = np.zeros_like(nodes)
    if len(tris):
        p0, p1, p2 = nodes[tris[:, 0]], nodes[tris[:, 1]], nodes[tris[:, 2]]
        n0, n1, n2 = p0 - p1, p1 - p2, p2 - p0
        l0 = (n0 * n0).sum(1)
        l1 = (n1 * n1).sum(1)
        l2 = (n2 * n2).sum(1)
        nm = np.cross(n0, n1)
        with np.errstate(divide="ignore", invalid="ignore"):
            np.add.at(normals, tris[:, 0], nm * (1.0 / (l0 * l2))[:, None])
            np.add.at(normals, tris[:, 1], nm * (1.0 / (l0 * l1))[:, None])
            np.add.at(normals, tris[:, 2], nm * (1.0 / (l1 * l2))[:, None])
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    out = np.where(ln > 1e-12, normals / np.maximum(ln, 1e-12), 0.0)
    return np.nan_to_num(out).astype(np.float32)


def _to_world(nodes, grid_size):
    """writeObjFile/writeBobjFile convention (iomeshes.cpp:352-371,191-212):
    centered unit-cube world coords, (pos - gs/2) * dx with dx=1/max(gs)."""
    gs = np.asarray(grid_size, np.float32)
    return (np.asarray(nodes, np.float32) - gs * 0.5) / gs.max()


def _to_grid(nodes, grid_size):
    """readBobj back-conversion (iomeshes.cpp:154-156)."""
    gs = np.asarray(grid_size, np.float32)
    return np.asarray(nodes, np.float32) * gs.max() + gs * 0.5


def write_mesh_bobj(filename: str, nodes, tris, grid_size=None,
                    normals=None):
    """Blender binary .bobj.gz (iomeshes.cpp writeBobjFile): gzipped
    int32 count + float32 verts, int32 count + float32 vertex normals,
    int32 count + int32 tri indices. With grid_size, verts are written in
    the reference's centered unit-cube world space; normals are computed
    per computeVertexNormals when not given."""
    nodes = np.asarray(nodes, np.float32)
    tris = np.asarray(tris, np.int32)
    if normals is None:
        normals = compute_vertex_normals(nodes, tris)
    out = _to_world(nodes, grid_size) if grid_size is not None else nodes
    with gzip.open(filename, "wb", compresslevel=1) as f:
        f.write(struct.pack("i", nodes.shape[0]))
        f.write(np.ascontiguousarray(out, np.float32).tobytes())
        f.write(struct.pack("i", nodes.shape[0]))
        f.write(np.ascontiguousarray(normals, np.float32).tobytes())
        f.write(struct.pack("i", tris.shape[0]))
        f.write(np.ascontiguousarray(tris).tobytes())


def read_mesh_bobj(filename: str, grid_size=None, return_normals=False):
    """Reads the reference layout (verts, normals, tris); with grid_size,
    verts are converted back to grid space like Mesh::load (readBobj)."""
    with gzip.open(filename, "rb") as f:
        (nv,) = struct.unpack("i", f.read(4))
        nodes = np.frombuffer(f.read(nv * 12), np.float32).reshape(nv, 3)
        (nn,) = struct.unpack("i", f.read(4))
        normals = np.frombuffer(f.read(nn * 12), np.float32).reshape(nn, 3)
        (nt,) = struct.unpack("i", f.read(4))
        tris = np.frombuffer(f.read(nt * 12), np.int32).reshape(nt, 3)
    nodes = _to_grid(nodes, grid_size) if grid_size is not None \
        else nodes.copy()
    if return_normals:
        return nodes, tris.copy(), normals.copy()
    return nodes, tris.copy()
