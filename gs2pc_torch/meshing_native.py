"""Native surface reconstruction: density grid + marching tetrahedra (the
port's copy of gs2pc.meshing_native, pinned by
tests/test_torch_io_copies.py; numpy / scipy on the host, as in the JAX
package).

The reference meshes with Open3D's Poisson reconstruction, an optional
dependency; without it the mesh is built here:

1. splat the surface point cloud into a dense voxel density grid,
2. Gaussian-smooth it (scipy.ndimage, separable),
3. extract the iso-surface with MARCHING TETRAHEDRA: each cube splits
   into 6 tetrahedra sharing the main diagonal; a tetrahedron has only
   trivial sign cases (0/1/2/3/4 corners inside), so no 256-entry
   marching-cubes tables are needed and the surface is watertight.  The
   pass runs in C++ (``csrc/mesher.cpp``, built with g++ at first use by
   ``ops/cuda_build.load_mesher``), else in numpy with the same semantics,
4. Laplacian smoothing (sparse adjacency averaging, like the
   reference's filter_smooth_laplacian tail),
5. vertex normals from the (negated) density gradient, colours from the
   nearest input point (scipy cKDTree), then the mesh PLY.

Each step is a ``log.phase`` (mesh_density_grid, mesh_iso_level,
mesh_marching_tetrahedra, mesh_smooth, mesh_attributes, mesh_write).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from gs2pc_torch.utils import log

# Cube corner ids: bit 0 = +x, bit 1 = +y, bit 2 = +z.
_ACTIVE_CUBE_BUDGET = 1_500_000  # ~100 us + ~1 KB per cube in the numpy MT pass

_CORNER_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [0, 1, 0],
        [1, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [0, 1, 1],
        [1, 1, 1],
    ],
    np.int32,
)
# 6-tetrahedra decomposition of the cube, all sharing the main diagonal
# corner 0 (0,0,0) -> corner 7 (1,1,1).
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int32,
)


def density_grid(
    points: np.ndarray, resolution: int = 256, sigma: float = 1.5, pad: int = 4
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Smoothed point-density field; returns (grid, origin, voxel_size)."""
    from scipy import ndimage

    points = np.asarray(points, np.float64)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    extent = float((hi - lo).max())
    if extent <= 0:
        extent = 1.0
    voxel = extent / (resolution - 2 * pad - 1)
    origin = lo - pad * voxel

    idx = np.floor((points - origin) / voxel).astype(np.int64)
    idx = np.clip(idx, 0, resolution - 1)
    grid = np.zeros((resolution,) * 3, np.float32)
    np.add.at(grid, (idx[:, 0], idx[:, 1], idx[:, 2]), 1.0)
    grid = ndimage.gaussian_filter(grid, sigma=sigma)
    return grid, origin, voxel


class MeshResult(NamedTuple):
    verts: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32
    mesher: str  # which marching tetrahedra ran: "native" or "numpy" ("open3d": Poisson)
    points: int  # points the surface was built from


def marching_tetrahedra(
    grid: np.ndarray, iso: float, origin: np.ndarray, voxel: float
) -> Tuple[np.ndarray, np.ndarray, str]:
    """Extract the iso-surface; returns (vertices (V,3), faces (F,3), and
    "native" or "numpy", the pass that ran).

    Uses the native C++ pass (csrc/mesher.cpp, ~100x the numpy throughput)
    when g++ builds it, else the vectorised numpy path below (same tet
    decomposition and edge semantics).
    """
    native = _marching_tetrahedra_native(grid, iso, origin, voxel)
    if native is not None:
        return (*native, "native")
    return (*_marching_tetrahedra_numpy(grid, iso, origin, voxel), "numpy")


def _marching_tetrahedra_native(grid, iso, origin, voxel):
    import ctypes

    from gs2pc_torch.ops.cuda_build import load_mesher

    lib = load_mesher()
    if lib is None:
        return None
    g = np.ascontiguousarray(grid, np.float32)
    res = g.shape[0]
    ctx = ctypes.c_void_p()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.gs2pc_marching_tet(
        g.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(res),
        ctypes.c_float(iso),
        ctypes.byref(ctx),
        ctypes.byref(nv),
        ctypes.byref(nf),
    )
    if rc != 0:
        return None
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.gs2pc_marching_tet_fetch(
        ctx,
        verts.ctypes.data_as(ctypes.c_void_p),
        faces.ctypes.data_as(ctypes.c_void_p),
    )
    verts = (np.asarray(origin, np.float64)[None, :] + verts.astype(np.float64) * voxel).astype(np.float32)
    return verts, faces


def _marching_tetrahedra_numpy(
    grid: np.ndarray, iso: float, origin: np.ndarray, voxel: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised numpy fallback (active cubes -> tets -> edge dedup)."""
    res = grid.shape[0]
    inside = grid > iso

    # Active cubes: any corner differs from corner 0.
    occ = inside[:-1, :-1, :-1]
    active = np.zeros_like(occ)
    for off in _CORNER_OFFSETS[1:]:
        sl = inside[
            off[0]: res - 1 + off[0],
            off[1]: res - 1 + off[1],
            off[2]: res - 1 + off[2],
        ]
        active |= sl != occ
    cx, cy, cz = np.nonzero(active)
    if cx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    base = np.stack([cx, cy, cz], axis=1)  # (C, 3)
    corner_idx = base[:, None, :] + _CORNER_OFFSETS[None, :, :]  # (C, 8, 3)
    vals = grid[
        corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]
    ]  # (C, 8)
    ins = vals > iso

    # Flatten cubes x 6 tets -> (T, 4) global corner ids + values.
    # Global corner key packs the lattice coordinate for vertex dedup.
    gkey = (
        corner_idx[..., 0].astype(np.int64) * res + corner_idx[..., 1]
    ) * res + corner_idx[..., 2]  # (C, 8)

    tet_keys = gkey[:, _TETS].reshape(-1, 4)  # (T, 4)
    tet_vals = vals[:, _TETS].reshape(-1, 4)
    tet_ins = ins[:, _TETS].reshape(-1, 4)

    n_in = tet_ins.sum(axis=1)
    keep = (n_in > 0) & (n_in < 4)
    tet_keys, tet_vals, tet_ins, n_in = (
        tet_keys[keep], tet_vals[keep], tet_ins[keep], n_in[keep]
    )

    # Order each tet's corners so the inside ones come first (stable).
    order = np.argsort(~tet_ins, axis=1, kind="stable")  # inside first
    rows = np.arange(tet_keys.shape[0])[:, None]
    k = tet_keys[rows, order]
    v = tet_vals[rows, order]

    def edge_vertex(ka, kb, va, vb):
        """Canonical (key-sorted) edge crossing -> unique edge id + t."""
        swap = ka > kb
        k1 = np.where(swap, kb, ka)
        k2 = np.where(swap, ka, kb)
        v1 = np.where(swap, vb, va)
        v2 = np.where(swap, va, vb)
        t = (iso - v1) / np.where(np.abs(v2 - v1) < 1e-20, 1e-20, v2 - v1)
        t = np.clip(t, 0.0, 1.0)
        return k1, k2, t.astype(np.float32)

    tris = []  # list of (k1a,k2a,ta, k1b,k2b,tb, k1c,k2c,tc)

    def add_tris(mask, pairs):
        """pairs: three (i, j) corner-index pairs forming the triangle."""
        if not mask.any():
            return
        km, vm = k[mask], v[mask]
        tri = []
        for i, j in pairs:
            tri.append(edge_vertex(km[:, i], km[:, j], vm[:, i], vm[:, j]))
        tris.append(tri)

    one = n_in == 1  # corner 0 inside: tri across edges 0-1, 0-2, 0-3
    add_tris(one, [(0, 1), (0, 2), (0, 3)])

    three = n_in == 3  # corners 0,1,2 inside: tri across 3-0, 3-1, 3-2
    add_tris(three, [(3, 0), (3, 1), (3, 2)])

    two = n_in == 2  # corners 0,1 inside: quad across 0-2, 0-3, 1-3, 1-2
    add_tris(two, [(0, 2), (0, 3), (1, 3)])
    add_tris(two, [(0, 2), (1, 3), (1, 2)])

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Deduplicate edge vertices globally.
    all_k1 = np.concatenate([np.stack([t[i][0] for i in range(3)], 1) for t in tris])
    all_k2 = np.concatenate([np.stack([t[i][1] for i in range(3)], 1) for t in tris])
    all_t = np.concatenate([np.stack([t[i][2] for i in range(3)], 1) for t in tris])

    edge_id = all_k1.astype(np.int64) * (res**3) + all_k2  # unique per edge
    flat_ids = edge_id.reshape(-1)
    uniq, inv = np.unique(flat_ids, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # Interpolated positions for unique edge vertices (first occurrence).
    first = np.full(uniq.shape[0], np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, inv, np.arange(flat_ids.shape[0]))
    k1_u = all_k1.reshape(-1)[first]
    k2_u = all_k2.reshape(-1)[first]
    t_u = all_t.reshape(-1)[first]

    def key_to_pos(key):
        z = key % res
        y = (key // res) % res
        x = key // (res * res)
        return np.stack([x, y, z], axis=1).astype(np.float64)

    p1 = key_to_pos(k1_u)
    p2 = key_to_pos(k2_u)
    verts = p1 + t_u[:, None] * (p2 - p1)
    verts = (origin[None, :] + verts * voxel).astype(np.float32)

    # Drop degenerate faces (repeated vertices on an edge-shared tet face).
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]


def laplacian_smooth(
    verts: np.ndarray, faces: np.ndarray, iterations: int = 10, lam: float = 0.5
) -> np.ndarray:
    """Uniform-weight Laplacian smoothing (reference tail parity,
    mesh_handler.py:35)."""
    from scipy import sparse

    n = verts.shape[0]
    if n == 0 or faces.shape[0] == 0 or iterations <= 0:
        return verts
    i = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2],
                        faces[:, 1], faces[:, 2], faces[:, 0]])
    j = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0],
                        faces[:, 0], faces[:, 1], faces[:, 2]])
    adj = sparse.coo_matrix((np.ones_like(i, np.float32), (i, j)), shape=(n, n))
    adj = (adj > 0).astype(np.float32).tocsr()
    deg = np.asarray(adj.sum(axis=1)).reshape(-1)
    deg = np.maximum(deg, 1.0)
    v = verts.astype(np.float64)
    for _ in range(iterations):
        v = v + lam * (adj @ v / deg[:, None] - v)
    return v.astype(np.float32)


def mesh_vertex_attributes(
    verts: np.ndarray,
    points: np.ndarray,
    colours: Optional[np.ndarray],
    grid: np.ndarray,
    origin: np.ndarray,
    voxel: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex colours (nearest input point) + normals (density gradient)."""
    from scipy.spatial import cKDTree

    if colours is not None and len(points) > 0 and len(verts) > 0:
        tree = cKDTree(np.asarray(points, np.float64))
        _, nn = tree.query(verts, k=1)
        vcols = np.asarray(colours)[nn]
    else:
        vcols = np.full((len(verts), 3), 255.0, np.float32)

    # Normals: negative density gradient at the nearest voxel, via central
    # differences evaluated ONLY at the vertex voxels (np.gradient over the
    # full grid materialises 3 full-resolution f64 volumes — ~20 s and
    # ~1.4 GB at resolution 384 just to sample a few hundred k normals).
    res = grid.shape[0]
    vi = np.clip(
        np.floor((verts - origin[None, :]) / voxel).astype(np.int64),
        0,
        res - 1,
    )
    x, y, z = vi[:, 0], vi[:, 1], vi[:, 2]
    xp, xm = np.minimum(x + 1, res - 1), np.maximum(x - 1, 0)
    yp, ym = np.minimum(y + 1, res - 1), np.maximum(y - 1, 0)
    zp, zm = np.minimum(z + 1, res - 1), np.maximum(z - 1, 0)
    normals = -np.stack(
        [
            (grid[xp, y, z] - grid[xm, y, z]) / np.maximum(xp - xm, 1),
            (grid[x, yp, z] - grid[x, ym, z]) / np.maximum(yp - ym, 1),
            (grid[x, y, zp] - grid[x, y, zm]) / np.maximum(zp - zm, 1),
        ],
        axis=1,
    ).astype(np.float64)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norm, 1e-12)
    return vcols.astype(np.float32), normals.astype(np.float32)


def save_mesh_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colours: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> None:
    """Binary-little-endian PLY mesh writer (vertices + face list)."""
    n, f = len(verts), len(faces)
    has_c = colours is not None
    has_n = normals is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {f}", "property list uchar int vertex_indices",
               "end_header", ""]

    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_n:
        dtype += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_c:
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    vert_rec = np.zeros(n, dtype)
    vert_rec["x"], vert_rec["y"], vert_rec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    if has_n:
        vert_rec["nx"], vert_rec["ny"], vert_rec["nz"] = (
            normals[:, 0], normals[:, 1], normals[:, 2],
        )
    if has_c:
        c = np.clip(colours, 0, 255).astype(np.uint8)
        vert_rec["red"], vert_rec["green"], vert_rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    face_rec = np.zeros(f, dtype=[("n", "u1"), ("i", "<i4", 3)])
    face_rec["n"] = 3
    face_rec["i"] = faces

    with open(path, "wb") as fh:
        fh.write("\n".join(header).encode())
        fh.write(vert_rec.tobytes())
        fh.write(face_rec.tobytes())


def _iso_level(grid, points, origin, voxel, resolution, iso_quantile) -> float:
    """The iso level: the iso_quantile-th quantile of the density at the
    points, raised until the active cubes fit the work budget."""
    # Iso level anchored to the density AT the points: the surface should
    # pass just outside the samples, so take the iso_quantile-th quantile
    # of per-point densities.  (A quantile over all "nonzero" voxels is
    # pathological at high resolutions — the Gaussian filter smears tiny
    # tails across tens of millions of voxels, the quantile lands near
    # zero, and marching tetrahedra then walks a near-full grid: 40+ min
    # and ~10 GB at resolution 384 for a 40k-point cloud.)
    pidx = np.clip(
        np.floor((points - origin[None, :]) / voxel).astype(np.int64),
        0,
        resolution - 1,
    )
    d_pts = grid[pidx[:, 0], pidx[:, 1], pidx[:, 2]]
    if d_pts.size == 0 or float(d_pts.max()) <= 0:
        raise ValueError("Point cloud produced an empty density field")
    iso = float(np.quantile(d_pts, iso_quantile))

    # Work budget: the numpy marching-tetrahedra pass costs ~100 us and
    # ~1 KB per active cube; back the iso off toward the density peak until
    # the active set is tractable rather than letting a diffuse cloud
    # explode into minutes of meshing.
    res1 = resolution - 1
    for _ in range(8):
        inside = grid > iso
        occ = inside[:res1, :res1, :res1]
        active = np.zeros_like(occ)
        for off in _CORNER_OFFSETS[1:]:
            active |= (
                inside[
                    off[0]: res1 + off[0],
                    off[1]: res1 + off[1],
                    off[2]: res1 + off[2],
                ]
                != occ
            )
        if int(active.sum()) <= _ACTIVE_CUBE_BUDGET:
            break
        iso *= 1.5
    return iso


def generate_mesh_native(
    points,
    colours,
    normals,
    output_path: str,
    depth: int = 10,
    laplacian_iters: int = 10,
    iso_quantile: float = 0.5,
) -> MeshResult:
    """Full native meshing pipeline.

    ``depth`` maps to grid resolution 2^depth (capped at 384) so the CLI's
    --poisson_depth keeps its quality-knob meaning.
    """
    points = np.asarray(points, np.float32)
    resolution = int(min(2**depth, 384))
    with log.phase("mesh_density_grid"):
        grid, origin, voxel = density_grid(points, resolution=resolution)
    with log.phase("mesh_iso_level"):
        iso = _iso_level(grid, points, origin, voxel, resolution, iso_quantile)
    with log.phase("mesh_marching_tetrahedra"):
        verts, faces, mesher = marching_tetrahedra(grid, iso, origin, voxel)
    with log.phase("mesh_smooth"):
        verts = laplacian_smooth(verts, faces, iterations=laplacian_iters)
    with log.phase("mesh_attributes"):
        vcols, vnorms = mesh_vertex_attributes(
            verts, points, colours, grid, origin, voxel
        )
    with log.phase("mesh_write"):
        save_mesh_ply(output_path, verts, faces, colours=vcols, normals=vnorms)
    return MeshResult(verts, faces, mesher, int(points.shape[0]))
