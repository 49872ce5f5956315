"""Camera frames of a car on a map, rendered on the device in plain
PyTorch: the benchmark's traffic for the camera cells.

The geometry is the synthetic simulator's: each pixel below the horizon
is cast onto the ground through the camera's homography, turned into
the map frame by the car's pose, and is track where it lies within the
half width of the centreline. The texture is too: mottled grass that
brightens down the image, speckled asphalt, a flat sky, and sensor
noise, all drawn from one ``torch.Generator`` seeded by the run.

Poses come in clips of consecutive frames, as a car at speed sees them
at 20 Hz, with the clips spread evenly around the lap from a seeded
phase; a smooth lateral offset and a yaw jitter keep the car inside the
corridor. Every seed renders the same number of frames at the same
spacing, somewhere else on the lap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.tracks import homography_i2w

AHEAD_M, BEHIND_M = 250.0, 30.0  # centreline a frame can see
CHUNK = 1 << 16  # pixels a distance block


def poses(centre: np.ndarray, rng: np.random.Generator, clips: int, per_clip: int, step_m: float,
          offset_m: float, yaw_deg: float) -> np.ndarray:
    """(clips * per_clip, 3) of x, y, yaw, and the nearest centreline
    index of each."""
    seg = np.linalg.norm(np.diff(centre, axis=0, append=centre[:1]), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    lap = s[-1]
    phase = rng.random()
    out = []
    for c in range(clips):
        phi = rng.uniform(0, 2 * math.pi)
        for k in range(per_clip):
            sk = ((phase + c / clips) * lap + k * step_m) % lap
            i = int(np.searchsorted(s, sk, side="right") - 1) % len(centre)
            j = (i + 1) % len(centre)
            f = (sk - s[i]) / max(seg[i], 1e-9)
            p = centre[i] + f * (centre[j] - centre[i])
            yaw = math.atan2(*(centre[j] - centre[i])[::-1])
            off = offset_m * math.sin(phi + 2 * math.pi * k / per_clip)
            normal = np.array([-math.sin(yaw), math.cos(yaw)])
            p = p + off * normal
            out.append([p[0], p[1], yaw + math.radians(yaw_deg) * rng.uniform(-1, 1), i])
    return np.asarray(out)


def render(centre: np.ndarray, cam: dict, pose_rows: np.ndarray, half_width: float,
           generator: torch.Generator, device) -> list[np.ndarray]:
    """One (H, W, 3) uint8 host frame a pose."""
    h, w = cam["image_height"], cam["image_width"]
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    g = homography_i2w(cam) @ pix
    ground = (g[:2] / g[2]).T.reshape(h, w, 2)
    usable_np = (ground[..., 1] > 0.5) & (ground[..., 1] < 200.0) & (np.abs(ground[..., 0]) < 100.0)
    usable = torch.as_tensor(usable_np, device=device)
    bev = torch.as_tensor(ground[usable_np], dtype=torch.float32, device=device)
    spacing = float(np.linalg.norm(np.diff(centre, axis=0), axis=1).mean())
    back, ahead = int(BEHIND_M / spacing), int(AHEAD_M / spacing)
    ctr = torch.as_tensor(centre, dtype=torch.float32, device=device)
    rows = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    frames = []
    for x, y, yaw, i in pose_rows:
        idx = torch.remainder(torch.arange(int(i) - back, int(i) + ahead, device=device), len(centre))
        local = ctr[idx] - torch.tensor([x, y], dtype=torch.float32, device=device)
        a = -yaw + math.pi / 2
        rot_t = torch.tensor([[math.cos(a), math.sin(a)], [-math.sin(a), math.cos(a)]],
                             dtype=torch.float32, device=device)
        world = bev @ rot_t.T  # relative to the car
        dist = torch.cat([torch.amin(torch.cdist(world[s:s + CHUNK], local), dim=1)
                        for s in range(0, len(world), CHUNK)])
        mask = torch.zeros((h, w), dtype=torch.bool, device=device)
        mask[usable] = dist < half_width
        mottle = torch.randn((h // 8 + 1, w // 8 + 1), generator=generator, device=device) * 12.0
        mottle = mottle.repeat_interleave(8, 0).repeat_interleave(8, 1)[:h, :w]
        img = torch.stack([70 + mottle, 130 + 25 * rows + mottle, 60 + mottle], dim=-1)
        speckle = torch.randn((h, w), generator=generator, device=device) * 8.0
        grey = (105 + 20 * rows + speckle)[..., None].expand(h, w, 3)
        img = torch.where(mask[..., None], grey, img)
        sky = torch.tensor([140.0, 170.0, 220.0], device=device)
        img = torch.where(usable[..., None], img, sky)
        img = img + torch.randn((h, w, 3), generator=generator, device=device) * 3.0
        frames.append(torch.clamp(img, 0, 255).to(torch.uint8))
    return [f.cpu().numpy() for f in frames]
