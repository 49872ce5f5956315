"""The dashboard's JPEG encode on the host: ms per frame of the port's
encoder (``dashboard/jpeg.py``, quality 80) on the frames the dashboard
sends.

    python -m acmpc_tpu_torch.bench.dashboard_encode [--reps 20]

Frames: the synthetic camera at 1280x736 cut to 1280x720, rendered by
``SyntheticSimulator`` on ``bench.py``'s circuit (the perception loop's
sim), and the 1280-wide composite of the six feeds the dashboard tiles
(camera, segmentation, semantics, the BEV, the world map and the local
localisation panel). Prints one JSON line: p50 and p99 ms, bytes and
pixels of each. Host only; the card does not take part.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from acmpc_tpu_torch.bench.perception_loop import circuit, make_sim, perception_config
from acmpc_tpu_torch.dashboard import render
from acmpc_tpu_torch.dashboard.jpeg import encode_jpeg

REPS = 20


def frames() -> dict:
    """The camera frame and the six-panel composite."""
    centre, left, right, _ = circuit()
    sim = make_sim(perception_config(), centre, left, right)
    sim.reset()
    mask = sim.render_drivable_mask()
    camera = sim.render_camera_image(mask)
    rng = np.random.default_rng(0)
    polys = {"centre": centre, "left": left, "right": right}
    particles = np.concatenate([centre[:500] + rng.normal(scale=3.0, size=(500, 2)), np.zeros((500, 1))], 1)
    estimate = np.array([*centre[0], 0.0])
    composite = render.compose_dashboard({
        "camera": camera,
        "segmentation": mask * 255,
        "semantics": render.render_semantics(mask.astype(np.int64)),
        "control": render.render_bev({"centre": rng.uniform(-40, 40, (60, 2))}, rng.uniform(-40, 40, (49, 2))),
        "map": render.render_world_map(polys, particles, estimate, estimate),
        "localisation": render.render_local_localisation(polys, particles, estimate, estimate),
    })
    return {"camera_1280x720": np.ascontiguousarray(camera[:720]), "composite": composite}


def time_encodes(reps: int = REPS) -> dict:
    out = {}
    for name, img in frames().items():
        ms, size = [], 0
        for _ in range(reps):
            t0 = time.perf_counter()
            size = len(encode_jpeg(img, 80))
            ms.append(1e3 * (time.perf_counter() - t0))
        out[name] = {
            "shape": list(img.shape),
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "bytes": size,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    print(json.dumps(time_encodes(args.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
