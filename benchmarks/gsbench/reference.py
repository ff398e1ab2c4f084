"""The plain reference of a disk-to-disk conversion, and the comparison that
decides whether a run is correct.

Plain PyTorch and numpy only: nothing here imports the program under test
(gs2pc_torch), the JAX package or JAX.  The reference reads the scene export
and the poses itself, works out what the conversion has to produce from
them, and judges the point cloud the program wrote:

- the PLY: its header, and its rows as runs of points, one run a Gaussian in
  index order, each run starting at its Gaussian's exact centre (which is
  how the rows are attributed to Gaussians), with one colour and one
  normal a run;
- every point lies inside its Gaussian's truncation ellipsoid (Mahalanobis
  distance at most the sampling's std), and every run's normal is its
  Gaussian's flattest axis;
- for a sample of Gaussians drawn from the seed, the camera sweep over
  every rendered camera, as the tile renderer defines it (16-pixel tiles,
  the alpha-reach radius and circle test, depth order, the per-tile run
  cap, the 1e-4 early stop, 8-bit table colours, a white background): each
  Gaussian's largest weight, the colour of the pixel where it is reached,
  and the sum of its per-camera largest weights; from these the cull
  (largest weight above the visibility threshold), the colour the cloud
  carries, and the point quotas (size times summed weight, up to the one
  scale that the budget fixes).

``round_tf32`` gives the control: the same reference with every operand
rounded to TF32's 10-bit mantissa, the precision a float32 program would
drop to if TF32 were let in.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

TILE = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_Z = 0.2
H_VAR = 0.3
SH_C0 = 0.28209479177387814
KT_P = 1.6075
PSD_LOG_FLOOR = 0.5 * math.log(1e-7)
ZNEAR, ZFAR = 10.0, 100.0
COLOUR_QUALITY = {"tiny": 180, "low": 360, "medium": 720, "high": 1280, "ultra": 1920,
                  "original": None}
# Prefix members blended per step; a pixel leaves the loop once it is done.
CHUNK = 128
# Triples (Gaussian, tile, pixel) blended at once, and candidate pixels
# tested at once.
BLOCK = 1 << 18
CANDIDATES = 1 << 20


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value (10 mantissa bits, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _same(x):
    return x


# --------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------- #

def read_ply_header(path: str) -> tuple:
    """(vertex count, [(property, type)], header bytes) of a binary
    little-endian PLY with one vertex element."""
    with open(path, "rb") as fh:
        raw = b""
        while not raw.endswith(b"end_header\n"):
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            raw += line
    count, props = None, []
    lines = raw.decode("ascii").splitlines()
    if lines[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise ValueError(f"{path}: not a binary little-endian PLY")
    for line in lines[2:]:
        tok = line.split()
        if tok[0] == "element":
            if tok[1] != "vertex" or count is not None:
                raise ValueError(f"{path}: unexpected element {tok[1]}")
            count = int(tok[2])
        elif tok[0] == "property":
            props.append((tok[2], tok[1]))
    return count, props, len(raw)


def read_export(path: str, device, rnd: Callable = _same) -> dict:
    """The scene planes of an INRIA export, as the conversion reads them:
    sigmoid opacities, colours from f_dc (clipped to [0, 1]), unit
    quaternions with w >= 0, log scales."""
    n, props, offset = read_ply_header(path)
    names = [p for p, _ in props]
    if any(t != "float" for _, t in props):
        raise ValueError(f"{path}: every property of an export is a float")
    rows = np.fromfile(path, dtype="<f4", count=n * len(names), offset=offset)
    rows = torch.from_numpy(rows.reshape(n, len(names))).to(device)
    col = {p: i for i, p in enumerate(names)}

    def take(*ps):
        return rows[:, [col[p] for p in ps]]

    q = take("rot_0", "rot_1", "rot_2", "rot_3")
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
    q = torch.where(q[:, :1] < 0.0, -q, q)
    raw_op = take("opacity")[:, 0]
    out = dict(
        xyz=take("x", "y", "z"),
        log_scales=take("scale_0", "scale_1", "scale_2"),
        rots=q,
        opacities=1.0 / (1.0 + torch.exp(-raw_op)),
        colours=torch.clamp(SH_C0 * take("f_dc_0", "f_dc_1", "f_dc_2") + 0.5, 0.0, 1.0),
    )
    return {k: rnd(v.contiguous()) for k, v in out.items()}


def read_cameras(path: str, skip_rate: int, colour_quality: str, device,
                 rnd: Callable = _same) -> list:
    """The rendered cameras of a transforms.json: every (skip_rate + 1)-th
    frame, scaled to the colour tier's width (none for "original")."""
    with open(path) as fh:
        frames = json.load(fh)["frames"]
    res = COLOUR_QUALITY[colour_quality.lower()]
    cams = []
    for i, fr in enumerate(frames):
        if i % (skip_rate + 1):
            continue
        w0, h0 = int(fr["w"]), int(fr["h"])
        scale = 1.0 if res is None else res / w0
        w, h = int(w0 * scale), int(h0 * scale)
        fx, fy = float(fr["fl_x"]) * scale, float(fr.get("fl_y", fr["fl_x"])) * scale
        c2w = np.asarray(fr["transform_matrix"], np.float64).copy()
        c2w[:, 1:3] = -c2w[:, 1:3]
        fovx, fovy = 2 * math.atan(w / (2 * fx)), 2 * math.atan(h / (2 * fy))
        view = np.linalg.inv(c2w)
        proj = np.zeros((4, 4))
        proj[0, 0], proj[1, 1] = 1.0 / math.tan(fovx / 2), 1.0 / math.tan(fovy / 2)
        proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
        proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
        proj[3, 2] = 1.0
        t = lambda a: rnd(torch.tensor(np.asarray(a, np.float32), device=device))  # noqa: E731
        cams.append(dict(
            view=t(view), proj=t(proj @ view), tanfovx=float(np.float32(math.tan(fovx / 2))),
            tanfovy=float(np.float32(math.tan(fovy / 2))),
            fx=float(np.float32(w / (2 * math.tan(fovx / 2)))),
            fy=float(np.float32(h / (2 * math.tan(fovy / 2)))), width=w, height=h))
    if not cams:
        raise ValueError(f"{path}: no camera is rendered")
    w_pad = -(-max(c["width"] for c in cams) // TILE) * TILE
    for c in cams:
        c["width_pad"] = w_pad
    return cams


def rotations(q: torch.Tensor) -> torch.Tensor:
    """(n, 4) unit wxyz -> (n, 3, 3)."""
    r, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], 1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], 1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


# --------------------------------------------------------------------- #
# One camera's projection (EWA splatting, Zwicker et al.; 3DGS's preprocess)
# --------------------------------------------------------------------- #

def project(scene: dict, cam: dict, rnd: Callable = _same) -> dict:
    """Every Gaussian seen by ``cam``: pixel centre, conic, opacity, depth,
    8-bit table colour, tile rect [lo, hi) and the squared radius within
    which its alpha can reach 1/255, and whether it is drawn at all."""
    xyz, op = scene["xyz"], scene["opacities"]
    V, Pm = cam["view"], cam["proj"]
    pv = xyz @ V[:3, :3].T + V[:3, 3]
    depth = pv[:, 2]
    ph = xyz @ Pm[:3, :3].T + Pm[:3, 3]
    pw = xyz @ Pm[3, :3] + Pm[3, 3]
    inv_w = 1.0 / (pw + 1e-7)
    W, H = cam["width"], cam["height"]
    px = ((ph[:, 0] * inv_w + 1.0) * W - 1.0) * 0.5
    py = ((ph[:, 1] * inv_w + 1.0) * H - 1.0) * 0.5

    limx, limy = 1.3 * cam["tanfovx"], 1.3 * cam["tanfovy"]
    tz = torch.where(depth.abs() < 1e-6, torch.full_like(depth, 1e-6), depth)
    tx = torch.clamp(pv[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(pv[:, 1] / tz, -limy, limy) * tz
    M = rotations(scene["rots"]) * torch.exp(scene["log_scales"])[:, None, :]
    T0 = V[:3, :3] @ M
    fx, fy = cam["fx"], cam["fy"]
    row0 = (fx / tz)[:, None] * T0[:, 0] - (fx * tx / (tz * tz))[:, None] * T0[:, 2]
    row1 = (fy / tz)[:, None] * T0[:, 1] - (fy * ty / (tz * tz))[:, None] * T0[:, 2]
    a = (row0 * row0).sum(1) + H_VAR
    b = (row0 * row1).sum(1)
    c = (row1 * row1).sum(1) + H_VAR
    det = a * c - b * b
    ok_det = det > 0.0
    inv_det = 1.0 / torch.where(ok_det, det, torch.ones_like(det))
    mid = 0.5 * (a + c)
    lam = torch.clamp(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1)), min=0.0)
    ln = torch.clamp(torch.log(torch.clamp(255.0 * op, min=1e-12)), min=0.0)
    r2 = 2.0 * lam * ln * 1.0001 + 1e-3
    radius = torch.ceil(torch.sqrt(torch.minimum(9.0 * lam, r2)))
    gw, gh = -(-W // TILE), -(-H // TILE)

    def tile(v, hi):
        return torch.floor(v / TILE).clamp(-1.0, hi + 1.0).to(torch.int64).clamp(0, hi)

    lo = torch.stack([tile(px - radius, gw), tile(py - radius, gh)], 1)
    hi = torch.stack([tile(px + radius + TILE - 1, gw), tile(py + radius + TILE - 1, gh)], 1)
    area = (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1])
    valid = (depth > NEAR_Z) & ok_det & (area > 0) & (op >= ALPHA_MIN)
    q = torch.round(torch.clamp(scene["colours"], 0.0, 1.0) * 255.0)
    table = torch.stack([px, py, c * inv_det, -b * inv_det, a * inv_det, op], 1)
    table = torch.cat([rnd(table.contiguous()), q * (1.0 / 255.0)], 1)
    return dict(table=table, depth=depth, lo=lo, hi=hi, area=torch.where(valid, area, 0),
                r2=r2, gw=gw)


def _circle_hit(table, r2, gid, tx, ty):
    """The renderer's circle test of tile (tx, ty) against Gaussian gid."""
    px, py = table[gid, 0], table[gid, 1]
    fx, fy = (tx * TILE).to(torch.float32), (ty * TILE).to(torch.float32)
    ddx = torch.minimum(torch.maximum(px, fx), fx + (TILE - 1)) - px
    ddy = torch.minimum(torch.maximum(py, fy), fy + (TILE - 1)) - py
    return ddx * ddx + ddy * ddy <= r2[gid]


def _pairs(pr: dict, gids: torch.Tensor, wanted: Optional[torch.Tensor] = None):
    """(gid, tile id) of every tile of ``gids``' rects that passes the
    circle test, restricted to tiles with ``wanted[tile]`` when given; in
    gid order, rect row-major."""
    area = pr["area"][gids]
    gid = torch.repeat_interleave(gids, area)
    k = torch.arange(gid.shape[0], device=gid.device) - torch.repeat_interleave(
        torch.cumsum(area, 0) - area, area)
    lo, hi = pr["lo"][gid], pr["hi"][gid]
    rw = hi[:, 0] - lo[:, 0]
    tx, ty = lo[:, 0] + k % rw, lo[:, 1] + k // rw
    tid = ty * pr["gw"] + tx
    keep = _circle_hit(pr["table"], pr["r2"], gid, tx, ty)
    if wanted is not None:
        keep &= wanted[tid]
    return gid[keep], tid[keep]


def tile_runs(pr: dict, wanted: torch.Tensor, block: int = 1 << 21):
    """Every tile with ``wanted[tile]``: its Gaussians in blend order (depth,
    then index).  Returns (gid and tile of each sorted pair, run start and
    run length by tile).  Only Gaussians whose rect holds a wanted tile
    (a summed-area table of the wanted grid says which) are expanded."""
    dev = wanted.device
    gw = pr["gw"]
    grid = wanted.view(-1, gw).to(torch.int32)
    sat = torch.zeros((grid.shape[0] + 1, gw + 1), dtype=torch.int32, device=dev)
    sat[1:, 1:] = grid.cumsum(0).cumsum(1)
    lo, hi = pr["lo"], pr["hi"]
    n_in = (sat[hi[:, 1], hi[:, 0]] - sat[lo[:, 1], hi[:, 0]] - sat[hi[:, 1], lo[:, 0]]
            + sat[lo[:, 1], lo[:, 0]])
    cand = ((n_in > 0) & (pr["area"] > 0)).nonzero()[:, 0]
    parts_g, parts_t = [], []
    for b in range(0, cand.shape[0], block):
        g, t = _pairs(pr, cand[b:b + block], wanted)
        parts_g.append(g)
        parts_t.append(t)
    gid = torch.cat(parts_g) if parts_g else cand[:0]
    tid = torch.cat(parts_t) if parts_t else cand[:0]
    dbits = pr["depth"].contiguous().view(torch.int32).to(torch.int64)[gid]
    key, order = torch.sort((tid << 32) | (dbits & 0xFFFFFFFF), stable=True)
    tile_of = key >> 32
    tids = torch.arange(wanted.shape[0], device=dev)
    start = torch.searchsorted(tile_of, tids)
    length = torch.searchsorted(tile_of, tids, right=True) - start
    return gid[order], tile_of, start, length


def _blend_steps(table, run_gid, start, pos, px, py, with_rgb: bool):
    """Blend each pixel (px, py) over its run's members [0, pos) in order,
    from T = 1: returns (T after them, done, rgb sum or None).  A pixel is
    done at the first member whose T (1 - alpha) would fall under 1e-4;
    that member and every later one add nothing."""
    n = px.shape[0]
    dev = px.device
    T = torch.ones(n, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    rgb = torch.zeros((n, 3), device=dev) if with_rgb else None
    lane = torch.arange(CHUNK, device=dev)
    active = torch.arange(n, device=dev)[pos > 0]
    s = 0
    while active.numel():
        m = torch.clamp(pos[active] - s, max=CHUNK)
        inr = lane[None, :] < m[:, None]
        at = (start[active] + s)[:, None] + lane[None, :]
        row = table[torch.where(inr, run_gid[torch.where(inr, at, 0)], 0)]
        dx = px[active][:, None] - row[..., 0]
        dy = py[active][:, None] - row[..., 1]
        power = -0.5 * (row[..., 2] * dx * dx + row[..., 4] * dy * dy) - row[..., 3] * dx * dy
        alpha = torch.clamp(row[..., 5] * torch.exp(power), max=ALPHA_MAX)
        ok = inr & (power <= 0.0) & (alpha >= ALPHA_MIN)
        a0 = torch.where(ok, alpha, 0.0)
        incl = torch.cumprod(1.0 - a0, dim=1)
        t_in = T[active]
        t_before = torch.cat([t_in[:, None], t_in[:, None] * incl[:, :-1]], dim=1)
        trig = ok & (t_before * (1.0 - alpha) < T_EPS)
        any_trig = trig.any(dim=1)
        first = torch.where(any_trig, trig.to(torch.int8).argmax(dim=1), CHUNK)
        if with_rgb:
            w = torch.where(lane[None, :] < first[:, None], a0 * t_before, 0.0)
            rgb[active] += (w[..., None] * row[..., 6:9]).sum(dim=1)
        T[active] = torch.where(
            any_trig, t_before.gather(1, first.clamp(max=CHUNK - 1)[:, None])[:, 0],
            t_in * incl[:, -1])
        done[active] = any_trig
        s += CHUNK
        active = active[~any_trig & (pos[active] > s)]
    return T, done, rgb


def camera_weights(pr: dict, cam: dict, ids: torch.Tensor, run_cap: int):
    """Per sampled Gaussian (``ids``): its largest weight alpha * T over the
    pixels of ``cam``, the lowest padded pixel id that reaches it (-1 where
    it reaches none) and the rendered colour of that pixel."""
    dev = ids.device
    K = ids.shape[0]
    table = pr["table"]
    W, H, w_pad, gw = cam["width"], cam["height"], cam["width_pad"], pr["gw"]
    best_w = torch.zeros(K, device=dev)
    best_pix = torch.full((K,), -1, dtype=torch.int64, device=dev)
    colour = torch.zeros((K, 3), device=dev)
    _, s_tid = _pairs(pr, ids)
    if s_tid.numel() == 0:
        return best_w, best_pix, colour
    wanted = torch.zeros(gw * (-(-H // TILE)), dtype=torch.bool, device=dev)
    wanted[s_tid] = True
    run_gid, tile_of, start, length = tile_runs(pr, wanted)
    length = torch.clamp(length, max=run_cap)

    # Where each sampled Gaussian sits in each of its tiles' capped runs.
    slot = torch.full((table.shape[0],), -1, dtype=torch.int64, device=dev)
    slot[ids] = torch.arange(K, device=dev)
    pos = torch.arange(run_gid.shape[0], device=dev) - start[tile_of]
    hit = (slot[run_gid] >= 0) & (pos < length[tile_of])
    k_slot, k_tile, k_pos = slot[run_gid[hit]], tile_of[hit], pos[hit]

    # Triples (Gaussian, tile, pixel) over the tile's pixels that the
    # Gaussian itself reaches with alpha >= 1/255; its weight at each.
    lid = torch.arange(TILE * TILE, device=dev)
    tri_parts = []
    step = max(1, CANDIDATES // (TILE * TILE))
    for b0 in range(0, k_slot.shape[0], step):
        ks, kt, kp = k_slot[b0:b0 + step], k_tile[b0:b0 + step], k_pos[b0:b0 + step]
        x = (kt % gw)[:, None] * TILE + lid % TILE
        y = (kt // gw)[:, None] * TILE + lid // TILE
        row = table[ids[ks]]
        dx = x.to(torch.float32) - row[:, None, 0]
        dy = y.to(torch.float32) - row[:, None, 1]
        power = -0.5 * (row[:, None, 2] * dx * dx + row[:, None, 4] * dy * dy) \
            - row[:, None, 3] * dx * dy
        alpha = torch.clamp(row[:, None, 5] * torch.exp(power), max=ALPHA_MAX)
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & (x < W) & (y < H)
        tri, pix = ok.nonzero(as_tuple=True)
        tri_parts.append((ks[tri], kt[tri], kp[tri], x[tri, pix], y[tri, pix], alpha[tri, pix]))
    cols = [torch.cat(c) for c in zip(*tri_parts)] if tri_parts else []
    got_s, got_w, got_p = [], [], []
    n_tri = cols[0].shape[0] if cols else 0
    for b0 in range(0, n_tri, BLOCK):
        ts, tt, tp, tx, ty, a_g = (c[b0:b0 + BLOCK] for c in cols)
        T, done, _ = _blend_steps(table, run_gid, start[tt], tp, tx.to(torch.float32),
                                  ty.to(torch.float32), False)
        got_s.append(ts)
        got_w.append(torch.where(~done & (T * (1.0 - a_g) >= T_EPS), a_g * T, 0.0))
        got_p.append(ty * w_pad + tx)
    if not got_s:
        return best_w, best_pix, colour
    s_idx, w, pid = torch.cat(got_s), torch.cat(got_w), torch.cat(got_p)
    best_w.scatter_reduce_(0, s_idx, w, "amax")
    reach = (w > 0.0) & (w >= best_w[s_idx])
    low = torch.full((K,), 1 << 62, dtype=torch.int64, device=dev)
    low.scatter_reduce_(0, s_idx[reach], pid[reach], "amin")
    best_pix = torch.where(best_w > 0.0, low, -1)

    # The rendered colour at each best pixel: its tile's whole capped run,
    # over a white background.
    has = best_pix >= 0
    if has.any():
        p = best_pix[has]
        px, py = p % w_pad, p // w_pad
        t = (py // TILE) * gw + px // TILE
        T, _, rgb = _blend_steps(table, run_gid, start[t], length[t], px.to(torch.float32),
                                 py.to(torch.float32), True)
        colour[has] = rgb + T[:, None] * 1.0
    return best_w, best_pix, colour


def sweep_sample(scene: dict, cams: list, ids: torch.Tensor, run_cap: int,
                 rnd: Callable = _same) -> dict:
    """The sweep's per-Gaussian results for the sampled ``ids``: the largest
    weight over every camera (the first camera keeps it on a tie), the
    colour of the pixel that reached it, and the sum of the per-camera
    largest weights."""
    K = ids.shape[0]
    dev = ids.device
    max_w = torch.zeros(K, device=dev)
    colour = torch.zeros((K, 3), device=dev)
    total = torch.zeros(K, device=dev)
    for cam in cams:
        pr = project(scene, cam, rnd)
        w, _, col = camera_weights(pr, cam, ids, run_cap)
        upd = w > max_w
        max_w = torch.where(upd, w, max_w)
        colour = torch.where(upd[:, None], col, colour)
        total = total + w
        del pr
    return dict(max_w=max_w, colour=colour, total=total)


def sizes(scene: dict) -> torch.Tensor:
    """sqrt of each Gaussian's ellipsoid surface (Knud Thomsen's formula),
    its scales clamped to the positive-definite floor."""
    a, b, c = torch.exp(torch.clamp(scene["log_scales"].double(), min=PSD_LOG_FLOOR)).unbind(1)
    r = ((a * b) ** KT_P + (a * c) ** KT_P + (b * c) ** KT_P) / 3.0
    return torch.sqrt(4.0 * math.pi * r ** (1.0 / KT_P))


def normals(scene: dict) -> torch.Tensor:
    """Each Gaussian's flattest axis: its rotation's column of the smallest
    scale."""
    R = rotations(scene["rots"])
    k = torch.argmin(scene["log_scales"], dim=1)
    return R.gather(2, k[:, None, None].expand(-1, 3, 1))[..., 0]


# --------------------------------------------------------------------- #
# The written cloud
# --------------------------------------------------------------------- #

CLOUD_PROPS = [("x", "float"), ("y", "float"), ("z", "float"), ("nx", "float"),
               ("ny", "float"), ("nz", "float"), ("red", "uchar"), ("green", "uchar"),
               ("blue", "uchar")]


def read_cloud(path: str, device) -> dict:
    """The cloud's rows: points (N, 3) float32, normals (N, 3), colours (N, 3)
    uint8; raises on another layout."""
    n, props, offset = read_ply_header(path)
    if props != CLOUD_PROPS:
        raise ValueError(f"{path}: properties {props}")
    dt = np.dtype([(p, "<f4" if t == "float" else "u1") for p, t in props])
    v = np.fromfile(path, dtype=dt, count=n, offset=offset)
    if v.shape[0] != n or os.path.getsize(path) != offset + n * dt.itemsize:
        raise ValueError(f"{path}: {v.shape[0]} rows for {n} vertices")
    f = lambda *k: torch.from_numpy(np.stack([v[x] for x in k], 1)).to(device)  # noqa: E731
    return dict(points=f("x", "y", "z"), normals=f("nx", "ny", "nz"),
                colours=f("red", "green", "blue"))


def attribute_rows(points: torch.Tensor, centres: torch.Tensor) -> tuple:
    """Rows -> Gaussians: a run starts at a row that equals a Gaussian's
    centre bit for bit.  Returns (gid per row or -1 before the first start,
    the start rows, their gids)."""
    pb = points.contiguous().view(torch.int32).to(torch.int64)
    cb = centres.contiguous().view(torch.int32).to(torch.int64)

    def h(b):
        return ((b[:, 0] * 0x9E3779B1 + b[:, 1]) * 0x85EBCA77 + b[:, 2]) * 0xC2B2AE3D

    ch, order = torch.sort(h(cb))
    ph = h(pb)
    at = torch.searchsorted(ch, ph).clamp(max=ch.shape[0] - 1)
    cand = order[at]
    is_start = (ch[at] == ph) & (cb[cand] == pb).all(dim=1)
    rows = is_start.nonzero()[:, 0]
    gids = cand[rows]
    run = torch.cumsum(is_start.to(torch.int64), 0) - 1
    gid = torch.where(run >= 0, gids[run.clamp(min=0)], -1) if rows.numel() else run
    return gid, rows, gids


# --------------------------------------------------------------------- #
# The comparison
# --------------------------------------------------------------------- #

def mahalanobis(points: torch.Tensor, scene: dict, g: torch.Tensor) -> torch.Tensor:
    """Each point's Mahalanobis distance from Gaussian ``g`` of its row (in
    float64, the scales clamped to the positive-definite floor)."""
    d = points.double() - scene["xyz"].double()[g]
    R = rotations(scene["rots"].double())[g]
    s = torch.exp(torch.clamp(scene["log_scales"].double(), min=PSD_LOG_FLOOR))[g]
    return torch.linalg.vector_norm(torch.einsum("nji,nj->ni", R, d) / s, dim=1)


def axis_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row the largest component gap between two unit axes, up to sign."""
    return torch.minimum((got - want).abs().amax(1), (got + want).abs().amax(1))


def judge_cloud(cloud: dict, scene: dict, std: float) -> dict:
    """Numbers of the whole cloud: ``layout`` counts rows and runs that break
    the cloud's form (rows before the first centre, runs out of index
    order, a run of two colours or normals); ``mahal_max`` is the largest
    Mahalanobis distance of a point from its Gaussian over ``std``, minus 1;
    ``normal_gap`` the largest gap between a run's normal and its Gaussian's
    flattest axis (up to sign).  Also returns the per-Gaussian counts and
    colours for the sample's numbers."""
    pts = cloud["points"]
    P = scene["xyz"].shape[0]
    gid, rows, gids = attribute_rows(pts, scene["xyz"])
    layout = int((gid < 0).sum())
    if gids.numel() > 1:
        layout += int((gids[1:] <= gids[:-1]).sum())
    g = gid.clamp(min=0)
    first = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
    if rows.numel():
        run = torch.cumsum(torch.zeros_like(first).index_fill_(0, rows, 1), 0) - 1
        first = rows[run.clamp(min=0)]
    layout += int((cloud["colours"] != cloud["colours"][first]).any(dim=1).sum())
    layout += int((cloud["normals"] != cloud["normals"][first]).any(dim=1).sum())

    mahal = mahalanobis(pts, scene, g)
    gap = axis_gap(cloud["normals"][rows], normals(scene)[gids])
    counts = torch.zeros(P, dtype=torch.int64, device=pts.device)
    if rows.numel():
        ends = torch.cat([rows[1:], rows.new_tensor([pts.shape[0]])])
        counts[gids] = ends - rows
    colours = torch.zeros((P, 3), dtype=torch.uint8, device=pts.device)
    colours[gids] = cloud["colours"][rows]
    return dict(
        layout=float(layout),
        mahal_max=float(mahal.max() / std - 1.0) if mahal.numel() else 0.0,
        normal_gap=float(gap.max()) if gap.numel() else 0.0,
        counts=counts, colours=colours,
    )


def budget_off(rows: int, num_points: int, runs: int) -> float:
    """How far the cloud's row count lies from the point budget, over the
    slack that the budget's apportionment leaves: each quota is its
    Gaussian's share of ``num_points`` rounded to the nearest point (half a
    point each over the ``runs`` Gaussians the cloud has points of), and a
    zero quota is raised to one only while the budget lasts, so a cloud that
    meets its budget reads at most 1."""
    return abs(int(rows) - int(num_points)) / max(0.5 * int(runs), 0.5)


def judge_sample(ref: dict, size: torch.Tensor, counts: torch.Tensor,
                 colours: torch.Tensor, threshold: float, margin: float = 1e-3) -> dict:
    """Numbers of the sampled Gaussians, in percent of those judged.

    ``count_off``: the cloud's count of a Gaussian against its quota, which
    is 0 where the reference culls it (largest weight at most the
    visibility threshold) and else its size x summed weight x the budget's
    scale (the median ratio of count to size x summed weight over the kept
    Gaussians with 8 points or more).  Judged where the largest weight is
    more than ``margin`` from the threshold and the quota is 0 or at least
    0.75 point (below that, rounding and the budget's promotions decide);
    off where the count misses the quota by more than half a point plus 2%.
    A Gaussian the cloud drops or keeps against the reference is off.
    ``colour_off``: of the Gaussians both keep, those whose colour differs
    from the reference's by a level or more in any channel."""
    max_w, total = ref["max_w"], ref["total"]
    ref_keep = max_w > threshold
    clear = (max_w - threshold).abs() > margin
    has = counts > 0
    m = size.double() * total.double()
    big = has & ref_keep & clear & (counts >= 8) & (m > 0)
    lam = float((counts[big].double() / m[big]).median()) if big.any() else 0.0
    quota = torch.where(ref_keep, lam * m, 0.0)
    judged = clear & (~ref_keep | (quota >= 0.75))
    count_off = judged & ((counts.double() - quota).abs() > 0.5 + 0.02 * quota)
    ref_u8 = torch.clamp(ref["colour"] * 255.0, 0.0, 255.0).to(torch.uint8)
    both = has & ref_keep
    col_off = both & ((colours.int() - ref_u8.int()).abs().amax(1) >= 1)

    def pct(a, b):
        return 100.0 * float(a.sum()) / max(1, int(b.sum()))

    return dict(count_off=pct(count_off, judged), colour_off=pct(col_off, both),
                judged=int(judged.sum()), kept=int(both.sum()))


def sample_ids(n: int, k: int, seed: int, device) -> torch.Tensor:
    """``k`` Gaussian indices of ``n`` drawn from ``seed`` (all when k >= n),
    ascending."""
    if k >= n:
        return torch.arange(n, device=device)
    gen = torch.Generator()
    gen.manual_seed((int(seed) * 2654435761 + 97) % (1 << 63))
    return torch.sort(torch.randperm(n, generator=gen)[:k])[0].to(device)
