"""Seeded inputs of the per-camera front end (K6:
gs2pc_torch.ops.projection.project_and_pack) shared by the CPU tests against
the JAX package (test_torch_frontend.py) and the card tests
(test_torch_cuda.py).  numpy and torch only: the card tests import no JAX.

Cases (256 Gaussians, one 64x48 camera):
  scene      a cloud in front of the camera, partly outside the frustum,
             some Gaussians dead or below the 1/255 opacity floor
  sh         the same cloud with per-camera colours from degree-3 SH
             (gs2pc_torch.ops.sh.view_colours: above 1 in places)
  edge       the camera inside a wider cloud: Gaussians behind it, at the
             near plane, and straddling the image edges
  nonfinite  the scene with inf, -inf and NaN in some means
"""

import numpy as np
import torch

from gs2pc_torch.camera import build_camera_batch
from gs2pc_torch.models.gaussians import Gaussians
from gs2pc_torch.ops.sh import view_colours

N_GAUSSIANS = 256
WIDTH, HEIGHT = 64, 48
FOCAL = 60.0
CASES = ("scene", "sh", "edge")
SH_DEGREE = 3


def look_at(cam_pos, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """NeRF-convention c2w of a camera at ``cam_pos`` looking at ``target``."""
    c = np.asarray(cam_pos, np.float64)
    z = np.asarray(target, np.float64) - c
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, c
    c2w[:, 1:3] = -c2w[:, 1:3]
    return c2w


def camera_inputs(case: str):
    """(transforms, intrinsics) of the case's one camera."""
    pos = (0.3, 0.2, -1.2) if case == "edge" else (0.0, 0.4, -4.0)
    return {"cam": look_at(pos)}, {"cam": (WIDTH, HEIGHT, FOCAL, FOCAL)}


def scene_arrays(case: str, seed: int = 5) -> dict:
    """numpy arrays of the case's Gaussians (float64 but for ``alive``)."""
    r = np.random.default_rng(seed)
    n = N_GAUSSIANS
    spread = 2.5 if case == "edge" else 1.2
    q = r.normal(size=(n, 4))
    a = dict(
        xyz=r.uniform(-spread, spread, (n, 3)),
        log_scales=r.uniform(-4.0, -1.0, (n, 3)),
        rots=q / np.linalg.norm(q, axis=1, keepdims=True),
        colours=r.uniform(-0.1, 1.1, (n, 3)),
        opacities=r.uniform(0.0, 1.0, n),
        alive=r.uniform(size=n) > 0.1,
    )
    a["opacities"][:8] = r.uniform(0.0, 1.0 / 255.0, 8)
    if case == "sh":
        a["shs"] = r.normal(0.0, 0.4, (n, 3, (SH_DEGREE + 1) ** 2))
    if case == "edge":
        # Straddling the near plane and the image corners.
        a["xyz"][:16] = [0.3, 0.2, -1.2] + r.uniform(-0.25, 0.25, (16, 3))
        a["log_scales"][16:32] = r.uniform(-1.0, 0.0, (16, 3))
    if case == "nonfinite":
        a["xyz"][:3] = [[np.inf, 0.0, 0.0], [0.0, -np.inf, 0.0], [0.0, 0.0, np.nan]]
        a["xyz"][3] = [np.nan, np.nan, np.nan]
        a["xyz"][4] = [np.inf, np.inf, -np.inf]
    return a


def frontend_inputs(case: str, device, seed: int = 5):
    """(means, factors, opacities, alive, colours, camera, batch) on ``device``:
    K6's inputs for the case (factors from Gaussians.covariance_factors)."""
    a = scene_arrays(case, seed)
    g = Gaussians.from_numpy(a["xyz"], a["log_scales"], a["rots"], a["colours"],
                             a["opacities"], device=device)
    alive = torch.as_tensor(a["alive"], device=device)
    transforms, intr = camera_inputs(case)
    batch = build_camera_batch(transforms, intr, device=device)
    cam = batch.at(0)
    colours = g.colours
    if case == "sh":
        shs = torch.as_tensor(a["shs"], dtype=torch.float32, device=device)
        colours = view_colours(SH_DEGREE, shs, g.xyz, cam.campos)
    return g.xyz, g.covariance_factors(), g.opacities, alive, colours, cam, batch


def bits_differ(a, b) -> list:
    """Names of the Preprocessed fields (and "table") that differ bit for
    bit between two (Preprocessed, table) results; floats are compared as
    their int32 bits, so NaNs and signed zeros count."""
    def bits(t):
        t = t.contiguous()
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    names = list(a[0]._fields) + ["table"]
    left = list(a[0]) + [a[1]]
    right = list(b[0]) + [b[1]]
    return [n for n, x, y in zip(names, left, right)
            if not (x is None and y is None)
            and (x is None or y is None or x.shape != y.shape or x.dtype != y.dtype
                 or not torch.equal(bits(x), bits(y).to(x.device)))]
