"""Point-cloud cleanup and meshing (counterpart of gs2pc.meshing).

``clean_point_cloud`` and the outlier removal before meshing run on the
device: a Morton-order window approximates each point's k nearest
neighbours, and a point is an outlier when its mean kNN distance exceeds
the global mean by ``std_ratio`` population standard deviations (Open3D's
``remove_statistical_outlier`` criterion).  Outliers are far from
everything, so the window errs on the safe side.  Where Open3D can be
imported, both delegate to it (exact kNN, Poisson meshing), as the JAX
package does; without it ``generate_mesh`` builds the surface with
gs2pc_torch.meshing_native on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from gs2pc_torch.io.ply import PointCloud
from gs2pc_torch.meshing_native import MeshResult, generate_mesh_native
from gs2pc_torch.utils import log

# Rows of the (rows, 2 * window, 3) neighbour gather per step: the whole
# gather is 7.7 GB at 10M points, a chunk of rows changes no value.
KNN_CHUNK_ROWS = 1 << 20


def _morton_codes(pts: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Interleaved-bit Morton codes (int64 holding the JAX package's uint32)."""
    lo = pts.amin(dim=0)
    hi = pts.amax(dim=0)
    scale = (2**bits - 1) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((pts - lo) * scale, 0, 2**bits - 1).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def knn_mean_distance(points: torch.Tensor, k: int = 20, window: int = 32) -> torch.Tensor:
    """Mean distance to ~k nearest neighbours: each point takes the
    ``window`` points on either side of it in Morton order (codes repeat, so
    the sort is stable, as JAX's) and averages the k smallest distances."""
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(_morton_codes(points), stable=True)
    sorted_pts = points[order]
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    k = min(k, offs.shape[0])
    mean_knn = torch.empty(n, dtype=points.dtype, device=dev)
    for lo in range(0, n, KNN_CHUNK_ROWS):
        rows = torch.arange(lo, min(lo + KNN_CHUNK_ROWS, n), device=dev)
        idx = torch.clamp(rows[:, None] + offs[None, :], 0, n - 1)
        d = torch.linalg.vector_norm(sorted_pts[idx] - sorted_pts[rows][:, None, :], dim=-1)
        # Exclude the self-matches that clipping makes at the array ends.
        d = torch.where(idx == rows[:, None], torch.inf, d)
        mean_knn[lo:lo + rows.shape[0]] = torch.topk(d, k, dim=1, largest=False).values.mean(dim=1)
    out = torch.empty_like(mean_knn)
    out[order] = mean_knn
    return out


def statistical_outlier_mask(
    points: torch.Tensor, nb_neighbors: int = 20, std_ratio: float = 10.0, window: int = 32
) -> torch.Tensor:
    """Keep mask: mean kNN distance <= global mean + std_ratio * global
    population std."""
    mean_knn = knn_mean_distance(points, k=nb_neighbors, window=window)
    mu = mean_knn.mean()
    sigma = mean_knn.std(correction=0)
    return mean_knn <= mu + std_ratio * sigma


def _open3d_outlier_keep(points: np.ndarray, nb_neighbors: int, std_ratio: float):
    """Open3D's exact statistical-outlier keep mask, or None without Open3D."""
    try:
        import open3d as o3d
    except ImportError:
        return None
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(np.asarray(points, np.float64))
    _, kept_idx = pc.remove_statistical_outlier(nb_neighbors=nb_neighbors, std_ratio=std_ratio)
    keep = np.zeros(len(points), bool)
    keep[np.asarray(kept_idx, np.int64)] = True
    return keep


def outlier_keep(points: np.ndarray, nb_neighbors: int, std_ratio: float, *, device) -> np.ndarray:
    """Host keep mask of ``points``: Open3D's where it imports, else
    statistical_outlier_mask on ``device``."""
    keep = _open3d_outlier_keep(points, nb_neighbors, std_ratio)
    if keep is None:
        pts = torch.as_tensor(np.require(points, np.float32, ["C", "W"]), device=device)
        keep = statistical_outlier_mask(pts, nb_neighbors=nb_neighbors,
                                        std_ratio=std_ratio).cpu().numpy()
    return keep


def clean_point_cloud(
    cloud: PointCloud, std_ratio: float = 10.0, nb_neighbors: int = 20, *, device
) -> PointCloud:
    """``cloud`` without its statistical outliers (nb 20, std_ratio 10, as
    the reference's mesh_handler).  Points stay grouped by Gaussian, so the
    kept points' counts per Gaussian describe the cleaned cloud and its
    per-Gaussian colours and normals still apply."""
    keep = outlier_keep(cloud.points, nb_neighbors, std_ratio, device=device)
    counts = np.bincount(cloud.gauss_ids()[keep], minlength=cloud.counts.shape[0])
    return PointCloud(points=cloud.points[keep], counts=counts.astype(np.int64),
                      cols_u8=cloud.cols_u8, gauss_normals=cloud.gauss_normals)


def generate_mesh(
    points,
    colours,
    normals,
    output_path: str,
    depth: int = 10,
    laplacian_iters: int = 10,
    std_ratio: float = 3.0,
    *,
    device,
) -> MeshResult:
    """Mesh a surface point cloud into ``output_path``: outlier removal
    (nb 20, ``std_ratio`` 3), then Open3D's Poisson at ``depth`` with the
    bottom 10% of densities trimmed and Laplacian smoothing, or, without
    Open3D, the native density grid + marching tetrahedra."""
    try:
        import open3d as o3d
    except ImportError:
        o3d = None
    if o3d is None:
        log.info("Open3D not available - using the native marching-tetrahedra "
                 "surface reconstruction")
        pts = np.asarray(points, np.float32)
        with log.phase("mesh_outliers"):
            keep = outlier_keep(pts, 20, std_ratio, device=device)
        cols = None if colours is None else np.asarray(colours)[keep]
        return generate_mesh_native(pts[keep], cols, normals, output_path,
                                    depth=depth, laplacian_iters=laplacian_iters)
    return _open3d_mesh(o3d, points, colours, normals, output_path, depth,
                        laplacian_iters, std_ratio)


def _open3d_mesh(o3d, points, colours, normals, output_path, depth, laplacian_iters,
                 std_ratio) -> MeshResult:
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(np.asarray(points, np.float64))
    pc.colors = o3d.utility.Vector3dVector(
        np.clip(np.asarray(colours, np.float64), 0, 255) / 255.0
    )
    if normals is not None:
        pc.normals = o3d.utility.Vector3dVector(np.asarray(normals, np.float64))
    pc, _ = pc.remove_statistical_outlier(nb_neighbors=20, std_ratio=std_ratio)
    mesh, densities = o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(pc, depth=depth)
    mesh.remove_vertices_by_mask(np.asarray(densities) < np.quantile(densities, 0.1))
    try:
        mesh = mesh.filter_smooth_laplacian(
            number_of_iterations=laplacian_iters,
            filter_scope=o3d.geometry.FilterScope.Vertex,
        )
        mesh.compute_vertex_normals()
    except Exception:  # noqa: BLE001 -- the reference tolerates a failed smoothing
        pass
    o3d.io.write_triangle_mesh(output_path, mesh)
    return MeshResult(np.asarray(mesh.vertices, np.float32),
                      np.asarray(mesh.triangles, np.int32), "open3d", len(pc.points))

