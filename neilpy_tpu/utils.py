"""Small cross-cutting utilities (parity: voxelize neilpy.py:195-275,
set_print_options neilpy.py:2397-2400)."""

from __future__ import annotations

import numpy as np

__all__ = ["voxelize", "write_voxel_stl", "set_print_options"]


def write_voxel_stl(filename, H, scale=1.0, origin=(0.0, 0.0, 0.0)):
    """Write a boolean voxel grid as a binary STL of exposed faces.

    The reference's STL path was dead code (voxelfuse import commented
    out, neilpy.py:72-74); this is a working replacement with no
    third-party dependency: every voxel face adjacent to an empty cell
    emits two triangles, vectorised in numpy.
    """
    H = np.asarray(H, dtype=bool)
    tris = []
    # (axis, direction, face corner offsets in CCW order viewed from
    # outside)
    unit = np.eye(3)
    for axis in range(3):
        for sign in (-1, 1):
            occ = H
            nb = np.zeros_like(H)
            sl_src = [slice(None)] * 3
            sl_dst = [slice(None)] * 3
            if sign == 1:
                sl_src[axis] = slice(1, None)
                sl_dst[axis] = slice(0, -1)
            else:
                sl_src[axis] = slice(0, -1)
                sl_dst[axis] = slice(1, None)
            nb[tuple(sl_dst)] = H[tuple(sl_src)]
            exposed = occ & ~nb
            idx = np.argwhere(exposed).astype(np.float64)
            if idx.size == 0:
                continue
            a = (axis + 1) % 3
            b = (axis + 2) % 3
            base = idx + (sign > 0) * unit[axis]
            c00 = base
            c10 = base + unit[a]
            c01 = base + unit[b]
            c11 = base + unit[a] + unit[b]
            if sign > 0:
                quads = np.stack([c00, c10, c11, c01], axis=1)
            else:
                quads = np.stack([c00, c01, c11, c10], axis=1)
            tris.append(quads[:, [0, 1, 2]])
            tris.append(quads[:, [0, 2, 3]])
    if tris:
        T = np.concatenate(tris, axis=0) * scale + np.asarray(origin)
    else:
        T = np.zeros((0, 3, 3))
    n = len(T)
    # binary STL: 80-byte header, uint32 count, then 50 bytes/facet
    v1 = T[:, 1] - T[:, 0]
    v2 = T[:, 2] - T[:, 0]
    nrm = np.cross(v1, v2)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), 0.0)
    rec = np.zeros(n, dtype=np.dtype([
        ("normal", "<f4", 3), ("v", "<f4", (3, 3)),
        ("attr", "<u2")]))
    rec["normal"] = nrm
    rec["v"] = T
    with open(filename, "wb") as f:
        f.write(b"neilpy_tpu voxel export".ljust(80, b"\0"))
        f.write(np.uint32(n).tobytes())
        f.write(rec.tobytes())
    return n


def voxelize(filename, x, y, z, resolution, bottom_fill=True, threshold=1,
             material=0, ve=1, pad=0):
    """Point cloud -> 3-D boolean voxel grid (parity:
    neilpy.py:195-275).

    STL export requires the optional ``voxelfuse`` package (dead in the
    reference too — its import is commented out at neilpy.py:72-74);
    pass ``filename=None`` to skip.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    z = np.asarray(z, dtype=float)
    x = x - x.min()
    y = y - y.min()
    z = z - z.min()
    max_x, max_y, max_z = x.max(), y.max(), z.max()

    interval = np.ceil(max(max_x, max_y)) / resolution
    xbins = np.arange(0, np.ceil(max_x) + interval, interval)
    ybins = np.arange(0, np.ceil(max_y) + interval, interval)
    zbins = np.arange(0, np.ceil(max_z) + interval / ve, interval / ve)

    H, _ = np.histogramdd((x, y, z), bins=(xbins, ybins, zbins))
    H = H >= threshold

    if bottom_fill:
        # fill every column downward from its lowest occupied voxel
        any_occ = H.any(axis=2)
        lowest = np.where(any_occ, H.argmax(axis=2), -1)
        levels = np.arange(H.shape[2])[None, None, :]
        H = H | ((lowest[:, :, None] >= 0) & (levels < lowest[:, :, None]))

    if pad > 0:
        r, c, _ = H.shape
        H = np.dstack((np.ones((r, c, pad), dtype=bool), H))

    if filename is not None:
        try:
            from voxelfuse.voxel_model import VoxelModel
            from voxelfuse.mesh import Mesh
            from voxelfuse.primitives import generateMaterials
        except ImportError as e:
            raise ImportError(
                "STL export requires the optional 'voxelfuse' package; "
                "pass filename=None to get the voxel array only.") from e
        model = VoxelModel(H, generateMaterials(material))
        Mesh.fromVoxelModel(model).export(filename)
    return H


def set_print_options(places=2, width=0):
    """numpy/pandas float print formatting (parity:
    neilpy.py:2397-2400)."""
    import pandas as pd
    fmt = "{0:" + str(width) + "." + str(places) + "f}"
    np.set_printoptions(formatter={"float": lambda v: fmt.format(v)})
    pd.options.display.float_format = fmt.format
