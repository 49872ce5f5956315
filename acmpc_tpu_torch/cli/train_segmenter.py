"""Train a segmentation checkpoint on synthetic sim frames.

Counterpart of ``tools/train_segmenter.py``: the synthetic simulator
renders textured camera frames with their ground-truth drivable masks
(class 1), and the full-width FPN-ResNet18 (10 classes) learns them with
AdamW in fp32, then the weights are written as fp16 in Flax's msgpack
layout, which both packages' ``TrackSegmenter`` load. Training runs on
the card unless the caller passes ``device="cpu"``:

    python -m acmpc_tpu_torch.cli.train_segmenter [--steps 300] [--batch 16] [--lr 3e-4] [--out PATH]

It follows the JAX trainer step for step: the same frames from the same
numpy draws, the same initial weights (``models/flax_init.py`` draws
what Flax's ``init`` draws for ``PRNGKey(0)``), the mean softmax cross-entropy
over every pixel with the dropout off (the JAX step applies the model
with ``train=False``), and optax's ``adamw`` defaults over every floating
leaf of the variables tree, the BatchNorm statistics included, since the
JAX step differentiates the whole tree. The exit code is 1 when the
final validation IoU is not above 0.9, the JAX tool's gate.

Kept different on purpose: ``--out`` defaults to a path under the
ignored ``build/`` directory, since the JAX tool's default is the
shipped reference checkpoint, which this tool never overwrites.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.localise.track_map import TrackMap
from acmpc_tpu_torch.models.checkpoint import write_checkpoint
from acmpc_tpu_torch.models.flax_init import init_variables
from acmpc_tpu_torch.models.fpn_resnet18 import (
    FPNResNet18,
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "torch_segmenter" / "synthetic_fpn.msgpack"

TRAIN_H, TRAIN_W = 192, 320  # FPN is fully convolutional; inference can
# run at the configs' full camera resolution with the same weights
NUM_CLASSES = 10
# the JAX tool's defaults
STEPS, BATCH, LR = 300, 16, 3e-4
VAL_FRAMES = 32
LOG_EVERY = 50
IOU_GATE = 0.9
# optax.adamw's defaults, which the JAX tool uses (torch's weight decay
# default is 1e-2)
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4


def make_sim(seed: int = 0):
    """The JAX tool's training circuit (an ellipse with 3rd and 7th
    harmonics, 1,200 points, 5 m half width) and camera, and the numpy
    generator of its draws."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, 1200, endpoint=False)
    r = 180.0 + 30.0 * np.sin(3 * theta) + 12.0 * np.sin(7 * theta)
    centre = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    d = np.roll(centre, -1, axis=0) - centre
    t = d / np.linalg.norm(d, axis=1, keepdims=True)
    n = np.stack([-t[:, 1], t[:, 0]], axis=1)
    tm = TrackMap(
        centre=torch.tensor(centre, dtype=torch.float32),
        left=torch.tensor(centre + 5.0 * n, dtype=torch.float32),
        right=torch.tensor(centre - 5.0 * n, dtype=torch.float32),
    )
    cam = CameraInfo(
        width=TRAIN_W,
        height=TRAIN_H,
        vertical_fov_deg=60.0,
        position=[0.0, 0.0, 1.2],
        pitch_deg=9.0,
    )
    return SyntheticSimulator(tm, cam, half_width=5.0), rng


def sample_frames(sim, rng, n: int):
    """Random poses around the lap: index + lateral offset + yaw jitter.
    (n, H, W, 3) uint8 frames and (n, H, W) uint8 masks."""
    images = np.empty((n, TRAIN_H, TRAIN_W, 3), np.uint8)
    masks = np.empty((n, TRAIN_H, TRAIN_W), np.uint8)
    m = len(np.asarray(sim._centre))
    for i in range(n):
        idx = int(rng.integers(0, m))
        p0 = sim._centre[idx]
        p1 = sim._centre[(idx + 1) % m]
        yaw = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0]))
        normal = np.array([-np.sin(yaw), np.cos(yaw)])
        off = float(rng.uniform(-3.0, 3.0))
        sim.x, sim.y = float(p0[0] + off * normal[0]), float(p0[1] + off * normal[1])
        sim.yaw = yaw + float(rng.uniform(-0.2, 0.2))
        sim.t = float(rng.uniform(0, 1e4))  # decorrelate texture noise
        mask = sim.render_drivable_mask()
        images[i] = sim.render_camera_image(mask)
        masks[i] = mask
    return images, masks


def check_precision() -> None:
    """Raise unless fp32 products stay fp32: TF32 off for matmul and
    cuDNN (the package turns both off at import; the trainer never sets
    them, since the MPC in the same process depends on them)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is on (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.backends.cudnn.allow_tf32); the trainer runs in fp32"
        )


def make_model(variables: dict, device: torch.device | str) -> FPNResNet18:
    """The fp32 FPN on ``device`` (channels_last) from a Flax variables
    tree, with its BatchNorm statistics requiring grad."""
    model = FPNResNet18(num_classes=NUM_CLASSES)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model = model.to(device=device, dtype=torch.float32, memory_format=torch.channels_last)
    # after the move: a buffer that requires grad would not stay a leaf
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.requires_grad_(True)
    return model


def leaves(model: FPNResNet18) -> dict[str, torch.Tensor]:
    """Every floating leaf of the variables tree by state-dict name:
    parameters and BatchNorm statistics."""
    return {
        name: t for name, t in model.state_dict(keep_vars=True).items() if t.is_floating_point()
    }


def make_optimizer(model: FPNResNet18, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr) over every leaf of :func:`leaves`."""
    return torch.optim.AdamW(
        list(leaves(model).values()), lr=lr, betas=BETAS, eps=ADAM_EPS, weight_decay=WEIGHT_DECAY
    )


def train_step(model: FPNResNet18, opt: torch.optim.Optimizer, images, labels) -> torch.Tensor:
    """One step on a uint8 batch (N, H, W, 3) and its uint8 labels
    (N, H, W): the mean softmax cross-entropy on fp32 logits, dropout
    off, then AdamW. Returns the loss as a 0-d tensor on the device (not
    read back); the leaves' ``.grad`` hold the step's gradients."""
    x = images.to(torch.float32) / 255.0
    logits = model(x)
    loss = F.cross_entropy(logits.permute(0, 3, 1, 2), labels.long())
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_iou(model: FPNResNet18, images, labels) -> torch.Tensor:
    """Class-1 IoU: argmax == 1 against label == 1, intersection over
    max(union, 1)."""
    x = images.to(torch.float32) / 255.0
    pred = torch.argmax(model(x), dim=-1) == 1
    gt = labels == 1
    inter = torch.sum(pred & gt)
    union = torch.sum(pred | gt)
    return inter / torch.clamp(union, min=1)


def checkpoint_tree(model: FPNResNet18) -> dict:
    """The Flax variables tree of the model with every fp32 leaf stored
    as fp16, as the JAX tool stores it."""
    state = {
        name: t.half() if t.dtype == torch.float32 else t for name, t in model.state_dict().items()
    }
    return flax_tree_from_state_dict(state)


@dataclasses.dataclass
class Training:
    """What :func:`train` did: the model and its optimizer, the logged
    steps (step, loss, val IoU, seconds since the loop began), the final
    val IoU, and per step the host's frame sampling and the device step
    (ms; CUDA events around the step on the card, the host clock on the
    CPU); the seconds spent in validation, and the loop's wall less its
    validation."""

    model: FPNResNet18
    optimizer: torch.optim.AdamW
    log: list
    final_iou: float
    sample_ms: list
    step_ms: list
    eval_s: float
    wall_s: float


def train(
    steps: int = STEPS,
    batch: int = BATCH,
    lr: float = LR,
    variables: dict | None = None,
    device: torch.device | str | None = None,
    echo=print,
) -> Training:
    """The JAX tool's loop: ``VAL_FRAMES`` validation frames, then per
    step a fresh batch from the same generator; the loss and val IoU
    every ``LOG_EVERY`` steps and at the last. ``variables`` (a Flax
    tree) is the start, by default the JAX tool's: Flax's initialisation
    for ``PRNGKey(0)`` (:func:`init_variables`). ``echo`` takes the
    logged lines."""
    device = resolve_device(device)
    check_precision()
    if variables is None:
        variables = init_variables(0, NUM_CLASSES)
    model = make_model(variables, device)
    opt = make_optimizer(model, lr)

    sim, rng = make_sim()
    val_images, val_masks = (torch.as_tensor(a, device=device) for a in sample_frames(sim, rng, VAL_FRAMES))
    on_card = device.type == "cuda"
    log, sample_ms, step_ms, events = [], [], [], []
    eval_s = 0.0
    t0 = time.perf_counter()
    for step in range(steps):
        ts = time.perf_counter()
        images, masks = sample_frames(sim, rng, batch)
        tl = time.perf_counter()
        sample_ms.append(1e3 * (tl - ts))
        images, masks = torch.as_tensor(images, device=device), torch.as_tensor(masks, device=device)
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = train_step(model, opt, images, masks)
            end.record()
            events.append((start, end))
        else:
            loss = train_step(model, opt, images, masks)
            step_ms.append(1e3 * (time.perf_counter() - tl))
        if step % LOG_EVERY == 0 or step == steps - 1:
            te = time.perf_counter()
            iou = float(eval_iou(model, val_images, val_masks))
            eval_s += time.perf_counter() - te
            elapsed = time.perf_counter() - t0
            log.append({"step": step, "loss": float(loss), "val_iou": iou, "s": elapsed})
            echo(f"step {step}: loss {float(loss):.4f} val IoU {iou:.4f} ({elapsed:.0f}s)")
    if on_card:
        torch.cuda.synchronize(device)
        step_ms = [start.elapsed_time(end) for start, end in events]
    wall_s = time.perf_counter() - t0 - eval_s
    te = time.perf_counter()
    final_iou = float(eval_iou(model, val_images, val_masks))
    eval_s += time.perf_counter() - te
    return Training(model, opt, log, final_iou, sample_ms, step_ms, eval_s, wall_s)


def main(argv=None, device: torch.device | str | None = None) -> Training:
    """The CLI: train and write the checkpoint to ``--out``; returns the
    :class:`Training`, and raises ``SystemExit(1)`` when the final val
    IoU is not above ``IOU_GATE``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    run = train(args.steps, args.batch, args.lr, device=device)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    # fp16 storage halves the asset; the loader casts to the configured
    # compute dtype (perception/segmentation.py)
    write_checkpoint(out, checkpoint_tree(run.model))
    print(f"final val IoU {run.final_iou:.4f}; wrote {out}")
    if not run.final_iou > IOU_GATE:
        print(f"trained model did not reach IoU {IOU_GATE}", file=sys.stderr)
        raise SystemExit(1)
    return run


if __name__ == "__main__":
    main()
