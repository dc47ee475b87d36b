"""Native OpenVDB (.vdb) grid IO — no pyopenvdb/libopenvdb dependency.

Replaces the reference's OPENVDB-gated writer (``source/fileio/iovdb.cpp``:
exportVDB/importVDB for Grid<Real|Vec3|int>) with a self-contained
implementation of the OpenVDB file format: sparse VDB trees
(Tree4<T,5,4,3>: root -> 32^3 internal -> 16^3 internal -> 8^3 leaves),
uncompressed (COMPRESS_NONE) buffers, uniform-scale transform, fog/levelset/
staggered grid classes — the same grid mapping iovdb.cpp:146-166 uses.

Format notes: the byte layout follows the OpenVDB file-format documentation
(magic, file version 220, grid descriptors with stream offsets, MetaMap,
transform map, topology masks, leaf buffers) for the pre-blosc,
pre-leaf-metadata era (file versions 220/221, library 5.0), which is the
simplest layout modern OpenVDB readers still accept. This environment has
no OpenVDB to cross-validate against, so external-tool compatibility is
untested here; the format is round-trip tested against this module's own
reader, and each section notes the openvdb source it mirrors.

Grids are dense mantaflow domains, so every leaf in the domain bounding box
is written with a full value mask (matching iovdb.cpp's dense copyTo loop).
"""

from __future__ import annotations

import struct

import numpy as np

VDB_MAGIC = 0x56444220          # io/Archive.cc OPENVDB_MAGIC (" BDV")
FILE_VERSION = 220              # OPENVDB_FILE_VERSION_SELECTIVE_COMPRESSION
LIB_MAJOR, LIB_MINOR = 5, 0
COMPRESS_NONE = 0

# grid classes (openvdb::GridClass string forms, Grid.cc gridClassToString)
CLASS_UNKNOWN = "unknown"
CLASS_LEVEL_SET = "level set"
CLASS_FOG = "fog volume"
CLASS_STAGGERED = "staggered"

_LEAF_LOG2 = 3                  # 8^3 leaves
_NODE4_LOG2 = 4                 # 16^3 leaf table  -> 128^3 voxels
_NODE5_LOG2 = 5                 # 32^3 node4 table -> 4096^3 voxels
_LEAF_DIM = 1 << _LEAF_LOG2
_NODE4_SPAN = _LEAF_DIM << _NODE4_LOG2        # 128
_NODE5_SPAN = _NODE4_SPAN << _NODE5_LOG2      # 4096

_TYPES = {
    "float": (np.float32, 1, "Tree_float_5_4_3"),
    "vec3s": (np.float32, 3, "Tree_vec3s_5_4_3"),
    "int32": (np.int32, 1, "Tree_int32_5_4_3"),
}


def _write_name(f, s: str):
    b = s.encode()
    f.write(struct.pack("<I", len(b)))
    f.write(b)


def _read_name(f) -> str:
    n, = struct.unpack("<I", f.read(4))
    return f.read(n).decode()


def _write_meta(f, meta: dict):
    """MetaMap::writeMeta: count, then (name, typeName, byteSize, bytes)."""
    f.write(struct.pack("<I", len(meta)))
    for name, val in meta.items():
        _write_name(f, name)
        if isinstance(val, str):
            _write_name(f, "string")
            b = val.encode()
            f.write(struct.pack("<I", len(b)))
            f.write(b)
        elif isinstance(val, bool):
            _write_name(f, "bool")
            f.write(struct.pack("<I", 1))
            f.write(struct.pack("<?", val))
        elif isinstance(val, int):
            _write_name(f, "int64")
            f.write(struct.pack("<I", 8))
            f.write(struct.pack("<q", val))
        elif isinstance(val, float):
            _write_name(f, "double")
            f.write(struct.pack("<I", 8))
            f.write(struct.pack("<d", val))
        else:
            raise TypeError(f"unsupported metadata value {val!r}")


def _read_meta(f) -> dict:
    cnt, = struct.unpack("<I", f.read(4))
    out = {}
    for _ in range(cnt):
        name = _read_name(f)
        tname = _read_name(f)
        size, = struct.unpack("<I", f.read(4))
        raw = f.read(size)
        if tname == "string":
            out[name] = raw.decode()
        elif tname == "bool":
            out[name] = bool(raw[0])
        elif tname == "int64":
            out[name] = struct.unpack("<q", raw)[0]
        elif tname == "double":
            out[name] = struct.unpack("<d", raw)[0]
        else:
            out[name] = raw
    return out


def _write_transform(f, voxel_size: float):
    """math::Transform::write with a UniformScaleMap (Maps.h ScaleMap:
    scale, voxel size, inverse, inv-squared, inv-twice — 5 Vec3d)."""
    _write_name(f, "UniformScaleMap")
    s = float(voxel_size)
    vec = lambda v: struct.pack("<3d", v, v, v)  # noqa: E731
    f.write(vec(s))                 # mScaleValues
    f.write(vec(s))                 # mVoxelSize
    f.write(vec(1.0 / s))           # mScaleValuesInverse
    f.write(vec(1.0 / (s * s)))     # mInvScaleSqr
    f.write(vec(0.5 / s))           # mInvTwiceScale


def _read_transform(f) -> float:
    name = _read_name(f)
    if name != "UniformScaleMap":
        raise ValueError(f"unsupported transform map {name!r}")
    scale = struct.unpack("<3d", f.read(24))[0]
    f.read(24 * 4)  # voxel size + 3 cached inverses
    return scale


def _mask_bytes(bits: np.ndarray) -> bytes:
    """openvdb NodeMask serialization: little-endian uint64 words."""
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _leaf_blocks(data_xyz: np.ndarray):
    """Split a dense (x,y,z[,c]) array into origin-keyed 8^3 leaf buffers
    (x-major voxel order, LeafNode::coordToOffset)."""
    nx, ny, nz = data_xyz.shape[:3]
    chans = data_xyz.shape[3] if data_xyz.ndim == 4 else 0
    px, py, pz = (-nx) % _LEAF_DIM, (-ny) % _LEAF_DIM, (-nz) % _LEAF_DIM
    pad = [(0, px), (0, py), (0, pz)] + ([(0, 0)] if chans else [])
    d = np.pad(data_xyz, pad)
    lx, ly, lz = d.shape[0] // _LEAF_DIM, d.shape[1] // _LEAF_DIM, \
        d.shape[2] // _LEAF_DIM
    shp = (lx, _LEAF_DIM, ly, _LEAF_DIM, lz, _LEAF_DIM)
    d = d.reshape(shp + ((chans,) if chans else ()))
    d = np.moveaxis(d, (2, 4), (1, 2))  # (lx,ly,lz,8,8,8[,c])
    # value mask: true for in-domain voxels (padded tail stays inactive)
    def axmask(n, nl):  # (nl, 8) in-domain flags for one axis
        return (np.arange(nl)[:, None] * _LEAF_DIM
                + np.arange(_LEAF_DIM)[None, :]) < n
    mask = axmask(nx, lx)[:, None, None, :, None, None] \
        & axmask(ny, ly)[None, :, None, None, :, None] \
        & axmask(nz, lz)[None, None, :, None, None, :]
    for ix in range(lx):
        for iy in range(ly):
            for iz in range(lz):
                origin = (ix * _LEAF_DIM, iy * _LEAF_DIM, iz * _LEAF_DIM)
                yield origin, d[ix, iy, iz], mask[ix, iy, iz]


def write_vdb(filename: str, grids):
    """Write grids to an OpenVDB-structured .vdb file.

    grids: list of dicts with keys
      name        grid name ("density", ...)
      data        numpy array, (z,y,x) scalar/int or (3,z,y,x) vec
      grid_class  one of the CLASS_* strings (default CLASS_UNKNOWN)
      voxel_size  world-space cell size (default 1.0)
    """
    with open(filename, "wb") as f:
        # --- archive header (io/Archive.cc writeHeader) ---
        f.write(struct.pack("<q", VDB_MAGIC))
        f.write(struct.pack("<I", FILE_VERSION))
        f.write(struct.pack("<II", LIB_MAJOR, LIB_MINOR))
        f.write(struct.pack("<?", True))            # has grid offsets
        f.write(struct.pack("<I", COMPRESS_NONE))   # stream compression
        f.write(b"00000000-0000-0000-0000-000000000000")  # uuid (36 chars)

        f.write(struct.pack("<I", len(grids)))

        # --- grid descriptors (io/GridDescriptor.cc writeHeader) ---
        descr_pos = []
        for g in grids:
            data = np.asarray(g["data"])
            vec = data.ndim == 4
            ty = "vec3s" if vec else (
                "int32" if data.dtype.kind in "iu" else "float")
            g["_ty"] = ty
            _write_name(f, g["name"])
            _write_name(f, _TYPES[ty][2])
            _write_name(f, "")                      # instance parent
            descr_pos.append(f.tell())
            f.write(struct.pack("<qqq", 0, 0, 0))   # grid/block/end offsets

        # --- grid bodies ---
        offsets = []
        for g in grids:
            data = np.asarray(g["data"])
            ty = g["_ty"]
            npdt, chans, _ = _TYPES[ty]
            # mantaflow (3,z,y,x) / (z,y,x) -> vdb index space (x,y,z[,c])
            data_xyz = np.transpose(data, (3, 2, 1, 0)) if chans == 3 \
                else data.transpose(2, 1, 0)
            data_xyz = np.ascontiguousarray(data_xyz, npdt)

            grid_pos = f.tell()
            _write_meta(f, {
                "class": g.get("grid_class", CLASS_UNKNOWN),
                "name": g["name"],
                "file_compression": int(COMPRESS_NONE),
                "is_saved_as_half_float": False,
                "value_type": ty,
            })
            _write_transform(f, g.get("voxel_size", 1.0))

            leaves = list(_leaf_blocks(data_xyz))
            background = np.zeros((chans,) if chans == 3 else (), npdt)

            def wval(v):
                f.write(np.asarray(v, npdt).tobytes())

            # --- topology (tree/Tree.h writeTopology) ---
            f.write(struct.pack("<I", 1))           # buffer count per leaf
            # RootNode::writeTopology: background, #tiles, #children
            wval(background)
            f.write(struct.pack("<I", 0))
            node5s = _group_by_span(leaves, _NODE5_SPAN)
            f.write(struct.pack("<I", len(node5s)))
            for origin5, leaves5 in node5s:
                f.write(struct.pack("<3i", *origin5))
                _write_internal(f, origin5, leaves5, _NODE5_LOG2,
                                _NODE4_SPAN, background, npdt, chans,
                                is_parent_of_leaves=False)
            # --- leaf buffers (tree/LeafNode.h writeBuffers) ---
            block_pos = f.tell()
            for _, buf, mask in leaves:
                if chans == 3:
                    f.write(np.ascontiguousarray(
                        buf.reshape(-1, 3)).tobytes())
                else:
                    f.write(np.ascontiguousarray(buf.reshape(-1)).tobytes())
            offsets.append((grid_pos, block_pos, f.tell()))

        for pos, offs in zip(descr_pos, offsets):
            f.seek(pos)
            f.write(struct.pack("<qqq", *offs))


def _group_by_span(leaves, span):
    groups = {}
    for origin, buf, mask in leaves:
        key = tuple((o // span) * span for o in origin)
        groups.setdefault(key, []).append((origin, buf, mask))
    return sorted(groups.items())


def _write_internal(f, origin, leaves, log2dim, child_span, background,
                    npdt, chans, is_parent_of_leaves):
    """InternalNode::writeTopology: child mask, value mask, tile values,
    then children in mask-bit order (x-major offsets)."""
    dim = 1 << log2dim
    nvals = dim ** 3
    child_mask = np.zeros(nvals, bool)
    groups = _group_by_span(leaves, child_span)
    by_off = {}
    for corigin, sub in groups:
        lx = (corigin[0] - origin[0]) // child_span
        ly = (corigin[1] - origin[1]) // child_span
        lz = (corigin[2] - origin[2]) // child_span
        off = (lx << (2 * log2dim)) | (ly << log2dim) | lz
        child_mask[off] = True
        by_off[off] = (corigin, sub)
    f.write(_mask_bytes(child_mask))
    f.write(_mask_bytes(np.zeros(nvals, bool)))     # value (tile) mask
    # tile values for non-child slots: COMPRESS_NONE writes all NUM_VALUES
    tiles = np.zeros((nvals, chans) if chans == 3 else (nvals,), npdt)
    f.write(tiles.tobytes())
    for off in np.nonzero(child_mask)[0]:
        corigin, sub = by_off[int(off)]
        if log2dim == _NODE5_LOG2:
            _write_internal(f, corigin, sub, _NODE4_LOG2, _LEAF_DIM,
                            background, npdt, chans,
                            is_parent_of_leaves=True)
        else:
            # leaf topology: value mask only (LeafNode::writeTopology)
            assert len(sub) == 1
            _, _, mask = sub[0]
            f.write(_mask_bytes(mask.reshape(-1)))


def read_vdb(filename: str):
    """Read a .vdb written by write_vdb (and format-compatible files).
    Returns a list of dicts: name, data ((z,y,x) or (3,z,y,x)), grid_class,
    voxel_size."""
    with open(filename, "rb") as f:
        magic, = struct.unpack("<q", f.read(8))
        if magic != VDB_MAGIC:
            raise ValueError(f"{filename}: not a VDB file")
        version, = struct.unpack("<I", f.read(4))
        f.read(8)                                   # library version
        has_offsets, = struct.unpack("<?", f.read(1))
        if version >= 220:
            comp, = struct.unpack("<I", f.read(4))
            if comp != COMPRESS_NONE:
                raise ValueError("compressed .vdb files not supported")
        f.read(36)                                  # uuid
        ngrids, = struct.unpack("<I", f.read(4))

        descrs = []
        for _ in range(ngrids):
            name = _read_name(f)
            gtype = _read_name(f)
            _read_name(f)                           # instance parent
            gp, bp, ep = struct.unpack("<qqq", f.read(24))
            descrs.append((name, gtype, gp, bp, ep))

        out = []
        for name, gtype, gp, bp, ep in descrs:
            ty = {v[2]: k for k, v in _TYPES.items()}.get(gtype)
            if ty is None:
                raise ValueError(f"unsupported grid type {gtype!r}")
            npdt, chans, _ = _TYPES[ty]
            f.seek(gp)
            meta = _read_meta(f)
            voxel_size = _read_transform(f)
            f.read(4)                               # buffer count
            # root: background, tiles, children
            vbytes = np.dtype(npdt).itemsize * (3 if chans == 3 else 1)
            f.read(vbytes)
            ntiles, = struct.unpack("<I", f.read(4))
            for _ in range(ntiles):
                f.read(12 + vbytes + 1)
            nchild, = struct.unpack("<I", f.read(4))
            leaves = []
            for _ in range(nchild):
                origin5 = struct.unpack("<3i", f.read(12))
                _read_internal(f, origin5, _NODE5_LOG2, _NODE4_SPAN,
                               npdt, chans, leaves)
            # buffers
            f.seek(bp)
            bufs = {}
            nvox = _LEAF_DIM ** 3
            for origin, mask in leaves:
                cnt = nvox * (3 if chans == 3 else 1)
                raw = np.frombuffer(f.read(cnt * np.dtype(npdt).itemsize),
                                    npdt)
                bufs[origin] = (raw.reshape(_LEAF_DIM, _LEAF_DIM, _LEAF_DIM,
                                            3) if chans == 3
                                else raw.reshape(_LEAF_DIM, _LEAF_DIM,
                                                 _LEAF_DIM), mask)
            data = _assemble(bufs, npdt, chans)
            out.append({"name": meta.get("name", name), "data": data,
                        "grid_class": meta.get("class", CLASS_UNKNOWN),
                        "voxel_size": voxel_size})
        return out


def _read_internal(f, origin, log2dim, child_span, npdt, chans, leaves):
    dim = 1 << log2dim
    nvals = dim ** 3
    nbytes = nvals // 8
    child_mask = np.unpackbits(
        np.frombuffer(f.read(nbytes), np.uint8), bitorder="little")
    f.read(nbytes)                                  # value mask
    f.read(nvals * np.dtype(npdt).itemsize * (3 if chans == 3 else 1))
    for off in np.nonzero(child_mask)[0]:
        lx = (off >> (2 * log2dim)) & (dim - 1)
        ly = (off >> log2dim) & (dim - 1)
        lz = off & (dim - 1)
        corigin = (origin[0] + int(lx) * child_span,
                   origin[1] + int(ly) * child_span,
                   origin[2] + int(lz) * child_span)
        if log2dim == _NODE5_LOG2:
            _read_internal(f, corigin, _NODE4_LOG2, _LEAF_DIM, npdt, chans,
                           leaves)
        else:
            mb = _LEAF_DIM ** 3 // 8
            mask = np.unpackbits(np.frombuffer(f.read(mb), np.uint8),
                                 bitorder="little").astype(bool)
            leaves.append((corigin, mask.reshape(_LEAF_DIM, _LEAF_DIM,
                                                 _LEAF_DIM)))


def _assemble(bufs, npdt, chans):
    """Dense (x,y,z[,c]) array from leaf buffers, cropped to the active
    bounding box, then transposed back to mantaflow (z,y,x[,c])."""
    if not bufs:
        return np.zeros((0, 0, 0), npdt)
    hi = [0, 0, 0]
    for origin, (buf, mask) in bufs.items():
        idx = np.nonzero(mask)
        for a in range(3):
            if len(idx[a]):
                hi[a] = max(hi[a], origin[a] + int(idx[a].max()) + 1)
    shape = tuple(hi) + ((3,) if chans == 3 else ())
    dense = np.zeros(shape, npdt)
    for origin, (buf, mask) in bufs.items():
        sl = tuple(slice(o, min(o + _LEAF_DIM, h))
                   for o, h in zip(origin, hi))
        ext = tuple(s.stop - s.start for s in sl)
        dense[sl] = buf[:ext[0], :ext[1], :ext[2]]
    if chans == 3:
        return np.transpose(dense, (3, 2, 1, 0))
    return dense.transpose(2, 1, 0)
