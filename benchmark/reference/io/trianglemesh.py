"""Triangle mesh I/O: PLY (binary/ascii), OBJ, BOBJ.

Host-side numpy, a copy of flipviscosity3d_tpu/io/trianglemesh.py (so that
the port never imports the JAX package), with the capabilities of the
reference's TriangleMesh loader/writers (trianglemesh.cpp:39-615): binary
little-endian PLY load, OBJ load supporting the three face index formats,
BOBJ binary load/save, binary PLY write (optional uchar vertex colors),
ascii OBJ write, and mesh translation. Files written by either package are
read by the other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_PLY_TYPES = {
    "char": ("i1", 1), "uchar": ("u1", 1), "int8": ("i1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2), "int16": ("i2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "uint": ("u4", 4), "int32": ("i4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


@dataclass
class TriangleMesh:
    """Vertices (N,3) float32 and triangle vertex indices (M,3) int32."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))

    def translate(self, t) -> "TriangleMesh":
        """Translate all vertices (trianglemesh.cpp `translate`)."""
        self.vertices = self.vertices + np.asarray(t, np.float32)
        return self

    def aabb(self):
        """(min, max) corner positions over all vertices."""
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


def load_ply(path: str) -> TriangleMesh:
    """Load a PLY mesh; binary little-endian (the reference's only supported
    encoding, trianglemesh.cpp:426-615) plus ascii for convenience."""
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements = []  # list of (name, count, [(prop_kind, ...)])
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property" and elements:
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))

    if fmt == "binary_little_endian":
        return _parse_ply_binary(body, elements)
    if fmt == "ascii":
        return _parse_ply_ascii(body.decode("ascii"), elements)
    raise ValueError(f"{path}: unsupported PLY format {fmt!r}")


def _parse_ply_binary(body: bytes, elements) -> TriangleMesh:
    mesh = TriangleMesh()
    off = 0
    for name, count, props in elements:
        if name == "vertex":
            if any(p[0] == "list" for p in props):
                raise ValueError("list property in vertex element unsupported")
            dt = np.dtype([(p[2], "<" + _PLY_TYPES[p[1]][0]) for p in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            mesh.vertices = np.stack(
                [arr["x"], arr["y"], arr["z"]], axis=1
            ).astype(np.float32)
        elif name == "face":
            tris = []
            # faces are a list property: count byte/int + indices
            list_prop = next(p for p in props if p[0] == "list")
            cnt_dt = np.dtype("<" + _PLY_TYPES[list_prop[1]][0])
            idx_dt = np.dtype("<" + _PLY_TYPES[list_prop[2]][0])
            # Fast path: constant-size triangle lists.
            probe = int(
                np.frombuffer(body, dtype=cnt_dt, count=1, offset=off)[0]
            ) if count else 3
            stride = cnt_dt.itemsize + probe * idx_dt.itemsize
            blob = np.frombuffer(body, dtype=np.uint8, count=stride * count, offset=off)
            counts = blob.reshape(count, stride)[:, : cnt_dt.itemsize].copy().view(cnt_dt)[:, 0]
            if probe == 3 and np.all(counts == 3):
                idx = (
                    blob.reshape(count, stride)[:, cnt_dt.itemsize :]
                    .copy()
                    .view(idx_dt)
                    .reshape(count, 3)
                )
                mesh.triangles = idx.astype(np.int32)
                off += stride * count
            else:
                # general polygon fan triangulation, element by element
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=cnt_dt, count=1, offset=off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(body, dtype=idx_dt, count=n, offset=off)
                    off += n * idx_dt.itemsize
                    for t in range(1, n - 1):
                        tris.append((idx[0], idx[t], idx[t + 1]))
                mesh.triangles = np.asarray(tris, np.int32).reshape(-1, 3)
        else:
            # skip unknown fixed-size element
            dt = np.dtype([(f"p{i}", "<" + _PLY_TYPES[p[1]][0]) for i, p in enumerate(props)])
            off += dt.itemsize * count
    return mesh


def _parse_ply_ascii(text: str, elements) -> TriangleMesh:
    mesh = TriangleMesh()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    pos = 0
    for name, count, props in elements:
        if name == "vertex":
            names = [p[2] for p in props]
            rows = [lines[pos + i].split() for i in range(count)]
            pos += count
            arr = np.asarray(rows, np.float64)
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            mesh.vertices = arr[:, [xi, yi, zi]].astype(np.float32)
        elif name == "face":
            tris = []
            for i in range(count):
                tok = lines[pos + i].split()
                n = int(tok[0])
                idx = [int(v) for v in tok[1 : 1 + n]]
                for t in range(1, n - 1):
                    tris.append((idx[0], idx[t], idx[t + 1]))
            pos += count
            mesh.triangles = np.asarray(tris, np.int32).reshape(-1, 3)
        else:
            pos += count
    return mesh


def save_ply(path: str, mesh: TriangleMesh, vertex_colors: np.ndarray | None = None):
    """Binary little-endian PLY writer (trianglemesh.cpp:190-343); optional
    (N,3) uint8 vertex colors."""
    nv = len(mesh.vertices)
    nt = len(mesh.triangles)
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {nv}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if vertex_colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines += [
        f"element face {nt}",
        "property list uchar int vertex_index",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        verts = np.ascontiguousarray(mesh.vertices, "<f4")
        if vertex_colors is None:
            f.write(verts.tobytes())
        else:
            cols = np.ascontiguousarray(vertex_colors, np.uint8)
            dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.empty(nv, dt)
            rec["xyz"] = verts
            rec["rgb"] = cols
            f.write(rec.tobytes())
        if nt:
            dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
            rec = np.empty(nt, dt)
            rec["n"] = 3
            rec["idx"] = np.ascontiguousarray(mesh.triangles, "<i4")
            f.write(rec.tobytes())


def load_obj(path: str) -> TriangleMesh:
    """Wavefront OBJ loader supporting `f v`, `f v/vt`, `f v//vn`, `f v/vt/vn`
    face formats with fan triangulation (trianglemesh.cpp:109-188)."""
    verts: list[tuple[float, float, float]] = []
    tris: list[tuple[int, int, int]] = []
    with open(path, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "f":
                idx = []
                for v in tok[1:]:
                    s = v.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for t in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[t], idx[t + 1]))
    return TriangleMesh(
        np.asarray(verts, np.float32).reshape(-1, 3),
        np.asarray(tris, np.int32).reshape(-1, 3),
    )


def save_obj(path: str, mesh: TriangleMesh):
    """ASCII OBJ writer (trianglemesh.cpp:381-418); 1-based face indices."""
    with open(path, "w") as f:
        for v in np.asarray(mesh.vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(mesh.triangles):
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def load_bobj(path: str) -> TriangleMesh:
    """Binary OBJ: int32 nverts, float32 xyz blob, int32 ntris, int32 idx blob
    (trianglemesh.cpp:65-105)."""
    with open(path, "rb") as f:
        (nv,) = struct.unpack("<i", f.read(4))
        verts = np.frombuffer(f.read(12 * nv), "<f4").reshape(nv, 3)
        (nt,) = struct.unpack("<i", f.read(4))
        tris = np.frombuffer(f.read(12 * nt), "<i4").reshape(nt, 3)
    return TriangleMesh(verts.astype(np.float32), tris.astype(np.int32))


def save_bobj(path: str, mesh: TriangleMesh):
    """Binary OBJ writer (trianglemesh.cpp:359-379)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(mesh.vertices)))
        f.write(np.ascontiguousarray(mesh.vertices, "<f4").tobytes())
        f.write(struct.pack("<i", len(mesh.triangles)))
        f.write(np.ascontiguousarray(mesh.triangles, "<i4").tobytes())


def box_mesh(pmin, pmax) -> TriangleMesh:
    """12-triangle axis-aligned box (FluidSimulation::_getTriangleMeshFromAABB,
    fluidsimulation.cpp:198-223)."""
    x0, y0, z0 = (float(v) for v in pmin)
    x1, y1, z1 = (float(v) for v in pmax)
    verts = np.asarray(
        [
            (x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1),
            (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1),
        ],
        np.float32,
    )
    tris = np.asarray(
        [
            (0, 1, 2), (0, 2, 3), (4, 7, 6), (4, 6, 5),
            (0, 3, 7), (0, 7, 4), (1, 5, 6), (1, 6, 2),
            (0, 4, 5), (0, 5, 1), (3, 2, 6), (3, 6, 7),
        ],
        np.int32,
    )
    return TriangleMesh(verts, tris)
