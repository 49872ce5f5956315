"""The segmenter's training step, held across devices and measured.

Pieces of ``chip_smoke.py``'s phase 16 and of the tests around
``cli/train_segmenter.py``:

- :func:`step_record`: one ``train_step`` and what it did: the loss,
  every leaf's gradient and every leaf after the step, on the host;
- :func:`compare_records`: two records held to the tolerances below;
- :func:`count_flops`: the floating-point operations of one step,
  counted by ``torch.utils.flop_counter.FlopCounterMode`` (convolutions
  and products only, forward and backward);
- :func:`synced_step_ms`: the step on the host clock, each ended by a
  synchronise;
- :func:`profile_steps`: the device's busy time over training steps
  under ``torch.profiler``;
- :func:`main`: the trainer at the JAX tool's defaults from several
  starts, each checkpoint's IoU at three camera sizes:

      python -m acmpc_tpu_torch.bench.train_step --starts flax:0 flax:1 torch:0

  ``flax:S`` is Flax's initialisation for ``PRNGKey(S)``
  (``models/flax_init.py``), ``torch:S`` the same distributions drawn
  with a ``torch.Generator`` seeded with S (other numbers). One JSON
  line a start.

The tolerances of a record against another from the same leaves and
Adam state. The loss within ``LOSS_RTOL`` of the reference's. Each
leaf's gradient within ``grad_rtol`` of that leaf's largest reference
gradient: the caller states it for the two sides it compares. The
leaves after the step in two parts. Adam moves an element by
``lr * m_hat / (sqrt(v_hat) + eps)``, and over its first three steps
``|m_hat| / sqrt(v_hat) <= 1.004`` (Cauchy-Schwarz on the bias-corrected
averages of optax's and torch's defaults), so where a gradient is as
small as its own rounding the two sides may step apart by up to
``UNDECIDED_LR * lr``. Where an element's gradient is at least
``DECIDED`` times its leaf's largest gradient error (decided), its
relative error is at most 1 / DECIDED and the update's at most twice
that (first order, through m and v alike), so the two leaves stay within
``DECIDED_LR * lr`` plus the fp32 rounding of a leaf up to 1 in the two
orders of the update (``LEAF_ATOL``, four ulps).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.bench.batch_sweep import card_line
from acmpc_tpu_torch.bench.step_breakdown import device_time
from acmpc_tpu_torch.cli import train_segmenter as ts
from acmpc_tpu_torch.models.fpn_resnet18 import FPNResNet18, flax_tree_from_state_dict, state_dict_from_flax
from acmpc_tpu_torch.models.flax_init import TRUNCATED_STD
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter

LOSS_RTOL = 5e-5
# the card's step against the CPU's, each leaf's gradient against its
# largest. Both are fp32 (TF32 off; cuDNN picks FFT and implicit-GEMM
# algorithms) and neither is exact: measured on an H100 at 192x320,
# batch 2 (chip_smoke.py phase 16), 1.4e-4 from the trainer's start and
# 2.6e-3 from a torch-drawn one, the worst in layer3_1; two card steps
# agree to 1e-6. Against an fp64 step both sides differ by 1.4e-3 in the
# same leaf: a pre-activation at a ReLU's edge falls the other way there
CARD_GRAD_RTOL = 5e-3
DECIDED = 1000.0
DECIDED_LR = 2.0 / DECIDED
LEAF_ATOL = 5e-7
UNDECIDED_LR = 2.01


def step_record(model, opt, images, labels) -> dict:
    """One ``train_step``: {"loss": float, "grads": {name: tensor},
    "leaves": {name: tensor after the step}}, tensors on the host."""
    loss = ts.train_step(model, opt, images, labels)
    named = ts.leaves(model)
    return {
        "loss": float(loss),
        "grads": {name: t.grad.detach().cpu() for name, t in named.items()},
        "leaves": {name: t.detach().cpu() for name, t in named.items()},
    }


def compare_records(got: dict, want: dict, lr: float, grad_rtol: float) -> dict:
    """``got`` against ``want`` (see the module's tolerances): the worst
    errors, each beside its bound, the count of decided elements, and
    ``fails``, one line per error beyond its bound."""
    fails = []
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    if not loss_rel <= LOSS_RTOL:
        fails.append(f"loss {got['loss']} against {want['loss']} (relative {loss_rel})")
    grad_rel, decided_err, undecided_err, n_decided, n_leaves = 0.0, 0.0, 0.0, 0, 0
    for name, g_want in want["grads"].items():
        g_got = got["grads"][name]
        scale = float(g_want.abs().max())
        g_err = float((g_got - g_want).abs().max())
        rel = g_err / scale if scale > 0 else (0.0 if g_err == 0 else float("inf"))
        grad_rel = max(grad_rel, rel)
        if not rel <= grad_rtol:
            fails.append(f"gradient of {name}: {g_err} against a largest {scale} (relative {rel})")
        err = (got["leaves"][name] - want["leaves"][name]).abs()
        decided = g_want.abs() >= DECIDED * g_err
        n_decided += int(decided.sum())
        n_leaves += err.numel()
        if decided.any():
            worst = float(err[decided].max())
            decided_err = max(decided_err, worst)
            if not worst <= DECIDED_LR * lr + LEAF_ATOL:
                fails.append(f"{name} after the step, decided elements: {worst}")
        if (~decided).any():
            worst = float(err[~decided].max())
            undecided_err = max(undecided_err, worst)
            if not worst <= UNDECIDED_LR * lr:
                fails.append(f"{name} after the step, undecided elements: {worst}")
    return {
        "loss_rel_err": loss_rel,
        "loss_rtol": LOSS_RTOL,
        "grad_rel_err": grad_rel,
        "grad_rtol": grad_rtol,
        "decided_max_abs_err": decided_err,
        "decided_tol": DECIDED_LR * lr + LEAF_ATOL,
        "undecided_max_abs_err": undecided_err,
        "undecided_tol": UNDECIDED_LR * lr,
        "decided_elements": n_decided,
        "elements": n_leaves,
        "fails": fails,
    }


def fp64_gradients(variables: dict, images, labels) -> dict:
    """Every leaf's gradient of ``train_step``'s loss from ``variables``
    taken in fp64 on the CPU (the classifier stays fp32, as the model
    keeps it), the reference both fp32 sides are measured against."""
    model = FPNResNet18(num_classes=ts.NUM_CLASSES)
    model.load_state_dict(state_dict_from_flax(variables))
    model = model.to(dtype=torch.float64, memory_format=torch.channels_last)
    for buf in model.buffers():
        buf.requires_grad_(True)
    x = torch.as_tensor(images).to(torch.float64) / 255.0
    loss = torch.nn.functional.cross_entropy(model(x).permute(0, 3, 1, 2), torch.as_tensor(labels).long())
    loss.backward()
    return {name: t.grad.detach() for name, t in ts.leaves(model).items()}


def gradient_error(grads: dict, reference: dict) -> dict:
    """The largest of each leaf's gradient error over that leaf's
    largest reference gradient, and its leaf."""
    errors = {
        name: float((grads[name].double() - ref).abs().max() / ref.abs().max())
        for name, ref in reference.items()
    }
    worst = max(errors, key=errors.get)
    return {"max_rel": errors[worst], "leaf": worst}


def count_flops(model, opt, images, labels) -> int:
    """The operations ``FlopCounterMode`` counts in one ``train_step``
    (it takes the step)."""
    with FlopCounterMode(display=False) as counter:
        ts.train_step(model, opt, images, labels)
    return int(counter.get_total_flops())


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synced_step_ms(model, opt, images, labels, steps: int) -> list:
    """``steps`` steps on one batch, each timed on the host clock from a
    synchronise to the synchronise after it (ms)."""
    out = []
    for _ in range(steps):
        _sync(images.device)
        t0 = time.perf_counter()
        ts.train_step(model, opt, images, labels)
        _sync(images.device)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def profile_steps(step, steps: int, device: torch.device) -> dict:
    """``step()`` called ``steps`` times under ``torch.profiler``: the
    wall and the device's busy time a step, its idle share of the wall,
    the kernels a step and the top kernels by device time."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        _sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_kernel = device_time(prof)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {
        "steps": steps,
        "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "kernels_per_step": sum(n for _, n in per_kernel.values()) / steps,
        "top_kernels_ms_per_step": [
            {"name": name[:90], "ms": us / 1e3 / steps, "calls_per_step": n / steps}
            for name, (us, n) in kernels[:10]
        ],
    }


# camera sizes of the IoU check (the agent's 1280x736, the training
# 320x192 and one between) and sim frames at each
SIZES = ((1280, 736), (640, 352), (320, 192))
IOU_FRAMES = 8


def torch_draws(seed: int) -> dict:
    """A Flax variables tree with Flax's initialisers' distributions
    drawn from a ``torch.Generator`` seeded with ``seed``: kernels a
    normal truncated at two standard deviations, std sqrt(1 / fan_in),
    the other leaves as Flax sets them."""
    generator = torch.Generator().manual_seed(seed)
    state = FPNResNet18(num_classes=ts.NUM_CLASSES).state_dict()
    for name, t in state.items():
        if t.ndim == 4:
            std = math.sqrt(1.0 / t[0].numel()) / TRUNCATED_STD
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        elif name.endswith(("weight", "running_var")):
            t.fill_(1.0)
        else:
            t.zero_()
    return flax_tree_from_state_dict(state)


def iou_at_sizes(variables: dict, device, frames: int = IOU_FRAMES) -> dict:
    """Class-1 IoU of ``variables`` through ``TrackSegmenter`` (fp32) on
    ``frames`` sim frames of the perception loop's circuit at each of
    ``SIZES``, the training camera scaled."""
    centre, left, right, _ = loop.circuit()
    out = {}
    for width, height in SIZES:
        cfg = loop.perception_config(width, height, "fp32")
        images, truths = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, frames)
        seg = TrackSegmenter(cfg, variables=variables, device=device)
        pred = np.stack([seg.segment_drivable_area(f)[0].cpu().numpy() == 1 for f in images])
        truth = np.stack(truths).astype(bool)
        out[f"{width}x{height}"] = float((pred & truth).sum() / max((pred | truth).sum(), 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--starts", nargs="+", default=["flax:0"], help="flax:SEED or torch:SEED")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step: no CUDA device is available", file=sys.stderr)
        return 2
    for start in args.starts:
        kind, seed = start.split(":")
        variables = ts.init_variables(int(seed)) if kind == "flax" else torch_draws(int(seed))
        t0 = time.perf_counter()
        run = ts.train(variables=variables, device="cuda", echo=lambda line: None)
        print(json.dumps({
            "start": start,
            "final_val_iou": run.final_iou,
            "log": run.log,
            "iou_fp16_checkpoint": iou_at_sizes(ts.checkpoint_tree(run.model), "cuda"),
            "wall_s": time.perf_counter() - t0,
            "card": card_line(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
