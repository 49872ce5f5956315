"""Plain reference of track-limit extraction: from a drivable mask to the
track's left and right limits on the ground and its centreline.

From the bottom of the usable image up, the drivable runs connected to
the car are kept (seeded on the runs of the lowest usable band that
touch the central third, each band up keeping the runs that overlap the
last selection, ended by more than the gap tolerance of empty bands; a
band is the OR of ``band`` rows), each row's leftmost and rightmost
kept column goes through the camera's ground homography, points outside
the bird's-eye field of view drop out, and a weighted least-squares
parabola x = a y^2 + b y + c is fitted to each limit and, with an origin
stub, to their midline.

The chain scan runs on the host in numpy (one row at a time); the
geometry in torch, in the dtype asked for. ``Arith(tf32=True)`` from
``reference.mpc`` rounds every matrix product's operands to TF32: the
control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.mpc import EXACT, Arith

BEV = (-50.0, 50.0, 0.0, 150.0)  # x min, x max, y min, y max
N_STUB = 10


def homography_i2w(cam: dict) -> np.ndarray:
    """Image -> ground homography of a pinhole camera: focal length from
    the vertical field of view, rotation of 90 + pitch degrees about x,
    the ground plane's x, y and translation columns, inverted."""
    w, h = cam["image_width"], cam["image_height"]
    f = h / (2 * math.tan(math.radians(cam["vertical_fov_deg"]) / 2))
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    a = math.radians(90.0 + cam["camera_pitch_deg"])
    R = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    t = R @ (-np.asarray(cam["camera_position"], np.float64).reshape(3, 1))
    full = K @ np.hstack([R, t])
    return np.linalg.inv(full[:, [0, 1, 3]])


def chain_edges(mask: np.ndarray, bonnet_row: int, gap: int = 3, band: int = 4):
    """(left, right, valid) per row of the run chain connected to the car
    in the (H, W) 0/1 mask; the raw mask's edges when no chain is found."""
    H, W = mask.shape
    usable = (mask > 0) & (np.arange(H) < bonnet_row)[:, None]
    hb = -(-H // band)
    padded = np.zeros((hb * band, W), bool)
    padded[:H] = usable
    rows = padded.reshape(hb, band, W).any(axis=1)
    gap = max(1, round(gap / band))
    central = np.zeros(W, bool)
    central[W // 3: 2 * W // 3] = True
    prev = np.zeros(W, bool)
    started = dead = False
    miss = 0
    sel = np.zeros_like(rows)
    for r in range(hb - 1, -1, -1):
        row = rows[r]
        run = np.cumsum(~row)
        seeds = row & (prev if started else central)
        hit = np.zeros(W + 1, bool)
        hit[run[seeds]] = True
        s = row & hit[run] & (not dead)
        has = bool(s.any())
        if has:
            miss = 0
        elif started:
            miss += 1
        started = started or has
        dead = dead or miss > gap
        if has:
            prev = s
        sel[r] = s
    full = np.repeat(sel, band, axis=0)[:H] & usable
    chosen = full if full.any() else mask > 0
    cols = np.arange(W)
    valid = chosen.any(axis=1)
    left = np.where(valid, np.argmax(chosen, axis=1), 0)
    right = np.where(valid, W - 1 - np.argmax(chosen[:, ::-1], axis=1), 0)
    del cols
    return left, right, valid


def _polyfit(pts, w, n_out, ar: Arith):
    dt, dev = pts.dtype, pts.device
    x, y = pts[:, 0], pts[:, 1]
    wf = w.to(dt)
    any_valid = bool(wf.sum() > 0)
    if not any_valid:
        s = torch.arange(n_out, dtype=dt, device=dev) / (n_out - 1)
        return torch.stack([0.1 * s, 2.0 * s], dim=1)
    y_max = torch.max(y[w])
    V = torch.stack([y ** 2, y, torch.ones_like(y)], dim=1)
    Vw = V * wf[:, None]
    G = ar.mm(V.T, Vw) + 1e-6 * torch.eye(3, dtype=dt, device=dev)
    coef = torch.linalg.solve(G, ar.mv(Vw.T, x))

    def line(a, b, n):
        s = torch.arange(n - 1, dtype=dt, device=dev) / (n - 1)
        return torch.cat([a * (1 - s) + b * s, b.reshape(1)])

    y500 = line(torch.zeros((), dtype=dt, device=dev), y_max, 500)
    x500 = coef[0] * y500 ** 2 + coef[1] * y500 + coef[2]
    y0 = y500[torch.argmin(x500 ** 2 + y500 ** 2)]
    yn = line(y0, y_max, n_out)
    return torch.stack([coef[0] * yn ** 2 + coef[1] * yn + coef[2], yn], dim=1)


def extract(mask: np.ndarray, cam: dict, dtype=torch.float64, device="cpu", ar: Arith = EXACT) -> dict:
    """The track outputs of one mask: the raw limits on the ground with
    their validity, the fitted limits and the centreline."""
    H, W = mask.shape
    bonnet = cam["n_rows_to_remove_bonnet"]
    n_out = cam["n_polyfit_points"]
    left_c, right_c, valid = chain_edges(mask, bonnet)
    rows = np.arange(H)
    Hm = torch.as_tensor(homography_i2w(cam), dtype=dtype, device=device)
    out = {}
    for side, cols in (("left", left_c), ("right", right_c)):
        ok = valid & (cols != 0) & (cols != W - 1) & (rows < bonnet)
        pix = torch.as_tensor(np.stack([cols, rows, np.ones(H)]), dtype=dtype, device=device)
        g = ar.mm(Hm, pix)
        pts = (g[:2] / g[2]).T
        okt = torch.as_tensor(ok, device=device)
        okt = okt & (pts[:, 0] > BEV[0]) & (pts[:, 0] < BEV[1]) & (pts[:, 1] > BEV[2]) & (pts[:, 1] < BEV[3])
        out[f"{side}_raw"], out[f"{side}_raw_mask"] = pts, okt
        out[side] = _polyfit(pts, okt, n_out, ar)
    mid = (out["left"] + out["right"]) / 2.0
    stub = torch.stack([mid[0, 0].expand(N_STUB), torch.zeros(N_STUB, dtype=dtype, device=device)], dim=1)
    pts = torch.cat([stub, mid])
    out["centre"] = _polyfit(pts, torch.ones(len(pts), dtype=torch.bool, device=device), n_out, ar)
    return out
