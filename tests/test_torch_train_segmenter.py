"""The segmenter's trainer (``acmpc_tpu_torch/cli/train_segmenter.py``)
against the JAX tool (``tools/train_segmenter.py``, imported by its path
and left as it is), and the FPN's training paths against Flax.

The JAX step is written out here as the tool writes it: ``optax.adamw``
over the whole variables tree, ``softmax_cross_entropy_with_integer_labels``
on the FPN applied with ``train=False``, ``jax.value_and_grad`` over every
leaf, the BatchNorm statistics included. It runs under
``jax.default_matmul_precision("highest")``, since XLA's CPU
convolutions otherwise round fp32 operands through bf16.

Tolerances (``bench/train_step.py`` states the leaf bounds):
- the loss within 5e-5 relative;
- each leaf's gradient within ``GRAD_RTOL`` = 1e-5 of that leaf's largest
  gradient: the two libraries sum each convolution's products in other
  orders (about 1e-7 relative a layer, over ~25 layers and their
  transposes); measured 1.9e-6 at 64x64, batch 2, from JAX's init;
- the leaves after each of three AdamW steps, each step taken from JAX's
  leaves and Adam moments before it: elements whose gradient is at least
  1,000 times their leaf's largest gradient error within 0.002 lr + 5e-7,
  the rest within 2.01 lr;
- three steps run freely from the same start: each loss within 5e-5, and
  every leaf within the sum of the three steps' bounds on undecided
  elements (6.03 lr), since each run steps from its own leaves.
"""

import dataclasses
import hashlib
import importlib.util
import pathlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.models.fpn_resnet18 import FPNResNet18 as JFPN
from acmpc_tpu.perception.segmentation import TrackSegmenter as JTrackSegmenter
from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.bench import train_step as bench
from acmpc_tpu_torch.cli import train_segmenter as ts
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.models.checkpoint import read_checkpoint
from acmpc_tpu_torch.models.fpn_resnet18 import (
    BN_EPS,
    DROPOUT_RATE,
    BatchNorm,
    FPNResNet18,
    dropout,
    state_dict_from_flax,
)
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHECKPOINT = ROOT / "data" / "models" / "segmentation" / "synthetic_fpn.msgpack"
H, W, N, STEPS, LR = 64, 64, 2, 3, 3e-4
GRAD_RTOL = 1e-5
LOGIT_TOL = 1e-4  # tests/test_torch_fpn.py's, fp32 logits against Flax's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_train_segmenter", ROOT / "tools" / "train_segmenter.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The tool's step for STEPS steps from ``model.init(PRNGKey(0))``:
    the leaves and Adam state before each step, and each step's batch,
    loss and gradients (numpy)."""
    model = JFPN(num_classes=10, dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    tx = optax.adamw(LR)
    opt_state = tx.init(variables)

    @jax.jit
    def train_step(variables, opt_state, images, labels):
        def loss_fn(v):
            x = images.astype(jnp.float32) / 255.0
            logits = model.apply(v, x)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels.astype(jnp.int32))
            return ce.mean()

        loss, grads = jax.value_and_grad(loss_fn)(variables)
        updates, opt_state = tx.update(grads, opt_state, variables)
        return optax.apply_updates(variables, updates), opt_state, loss, grads

    rng = np.random.default_rng(0)
    run = {"variables": [_numpy(variables)], "adam": [_numpy(opt_state[0])], "batches": [], "loss": [], "grads": []}
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            images = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
            labels = rng.integers(0, 2, (N, H, W), dtype=np.uint8)
            variables, opt_state, loss, grads = train_step(
                variables, opt_state, jnp.asarray(images), jnp.asarray(labels)
            )
            run["batches"].append((images, labels))
            run["loss"].append(float(loss))
            run["grads"].append(_numpy(grads))
            run["variables"].append(_numpy(variables))
            run["adam"].append(_numpy(opt_state[0]))
    return run


def _load_adam(opt, model, adam):
    """optax's ScaleByAdamState as torch AdamW's state of every leaf."""
    mu, nu = state_dict_from_flax(adam.mu), state_dict_from_flax(adam.nu)
    for name, leaf in ts.leaves(model).items():
        opt.state[leaf] = {
            "step": torch.tensor(float(adam.count)),
            "exp_avg": torch.empty_like(leaf).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(leaf).copy_(nu[name]),
        }


def _want(jax_run, k):
    return {
        "loss": jax_run["loss"][k],
        "grads": state_dict_from_flax(jax_run["grads"][k]),
        "leaves": state_dict_from_flax(jax_run["variables"][k + 1]),
    }


def _port_step(jax_run, k):
    model = ts.make_model(jax_run["variables"][k], "cpu")
    opt = ts.make_optimizer(model, LR)
    _load_adam(opt, model, jax_run["adam"][k])
    images, labels = jax_run["batches"][k]
    return bench.step_record(model, opt, torch.from_numpy(images), torch.from_numpy(labels))


# -- the frames --------------------------------------------------------------


def test_sample_frames_bit_equal_to_the_tool(jax_tool):
    sim, rng = ts.make_sim()
    jsim, jrng = jax_tool.make_sim()
    for _ in range(2):  # the generator's state carries over as in the tool
        images, masks = ts.sample_frames(sim, rng, 2)
        jimages, jmasks = jax_tool.sample_frames(jsim, jrng, 2)
        assert images.shape == (2, 192, 320, 3) and images.dtype == np.uint8
        assert masks.shape == (2, 192, 320) and masks.dtype == np.uint8
        np.testing.assert_array_equal(images, jimages)
        np.testing.assert_array_equal(masks, jmasks)
    assert 0.05 < masks.mean() < 0.95  # both classes present
    assert (ts.TRAIN_H, ts.TRAIN_W) == (jax_tool.TRAIN_H, jax_tool.TRAIN_W)


# -- the FPN's training paths ----------------------------------------------------


def _old_forward(model, x):
    """The FPN's forward as it was before ``train``: no dropout."""
    from acmpc_tpu_torch.models.fpn_resnet18 import _upsample

    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    c2, c3, c4, c5 = model.encoder(x)
    p5 = model.p5(c5)
    p4 = model.p4(c4) + _upsample(p5, 2)
    p3 = model.p3(c3) + _upsample(p4, 2)
    p2 = model.p2(c2) + _upsample(p3, 2)
    x = model.s5(p5) + model.s4(p4) + model.s3(p3) + model.s2(p2)
    x = torch.nn.functional.conv2d(x.float(), model.head.weight.float(), model.head.bias.float())
    x = torch.nn.functional.interpolate(x, scale_factor=4, mode="bilinear", align_corners=True)
    return x.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def port_model(jax_run):
    model = FPNResNet18()
    model.load_state_dict(state_dict_from_flax(jax_run["variables"][1]))
    return model.to(memory_format=torch.channels_last).requires_grad_(False)


def _input(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random((N, H, W, 3)).astype(np.float32))


def test_train_false_is_the_old_forward_bit_for_bit(port_model):
    x = _input()
    want = _old_forward(port_model, x)
    for mode in (port_model.train, port_model.eval):
        mode()
        assert torch.equal(port_model(x), want)
        assert torch.equal(port_model(x, train=False, generator=torch.Generator().manual_seed(1)), want)
    port_model.eval()


def _features(model, x):
    """The summed segmentation features the dropout sees."""
    outs = {}
    hooks = [
        getattr(model, name).register_forward_hook(lambda m, i, o, name=name: outs.__setitem__(name, o))
        for name in ("s5", "s4", "s3", "s2")
    ]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return outs["s5"] + outs["s4"] + outs["s3"] + outs["s2"]


def test_dropout_zeroes_a_fifth_and_scales_the_rest(port_model):
    feats = _features(port_model, _input())
    dropped = dropout(feats, DROPOUT_RATE, torch.Generator().manual_seed(3))
    live = feats != 0  # a ReLU sum may be 0 before the dropout
    zero = live & (dropped == 0)
    # of 65,536 features most are live: the share's std is under 0.002
    assert int(live.sum()) > 40_000
    assert abs(int(zero.sum()) / int(live.sum()) - DROPOUT_RATE) < 0.01
    kept = live & ~zero
    # Flax divides by the keep probability: x / 0.8, i.e. 1.25 x in fp32
    assert torch.equal(dropped[kept], feats[kept] / (1.0 - DROPOUT_RATE))
    np.testing.assert_allclose(dropped[kept].numpy(), 1.25 * feats[kept].numpy(), rtol=2e-7)


def test_train_true_drops_before_the_head(port_model):
    x = _input()
    got = port_model(x, train=True, generator=torch.Generator().manual_seed(5))
    feats = dropout(_features(port_model, x), DROPOUT_RATE, torch.Generator().manual_seed(5))
    want = torch.nn.functional.conv2d(feats, port_model.head.weight, port_model.head.bias)
    want = torch.nn.functional.interpolate(want, scale_factor=4, mode="bilinear", align_corners=True)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    assert not torch.equal(got, port_model(x))


def test_dropout_repeats_with_the_generator_and_ignores_the_module_mode(port_model):
    x = _input()
    a = port_model(x, train=True, generator=torch.Generator().manual_seed(9))
    port_model.eval()
    b = port_model(x, train=True, generator=torch.Generator().manual_seed(9))
    port_model.train()
    c = port_model(x, train=True, generator=torch.Generator().manual_seed(9))
    d = port_model(x, train=True, generator=torch.Generator().manual_seed(10))
    port_model.eval()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, d)


def test_batchnorm_gradients_match_flax():
    rng = np.random.default_rng(11)
    c = 64
    x = rng.normal(size=(2, 8, 8, c)).astype(np.float32)
    w_out = rng.normal(size=(2, 8, 8, c)).astype(np.float32)
    scale, bias = (rng.normal(1.0, 0.2, c).astype(np.float32), rng.normal(0.0, 0.2, c).astype(np.float32))
    mean, var = rng.normal(0.0, 0.5, c).astype(np.float32), rng.uniform(0.2, 2.0, c).astype(np.float32)

    bn = nn.BatchNorm(use_running_average=True)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}

    def loss(v, x):
        return jnp.sum(bn.apply(v, x) * w_out)

    want_grads, want_gx = jax.grad(loss, argnums=(0, 1))(variables, x)

    port = BatchNorm(c)
    port.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var),
    })
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    # without grad on the statistics: F.batch_norm, the inference path
    with torch.no_grad():
        plain = port(xt)
    port.running_mean.requires_grad_(True)
    port.running_var.requires_grad_(True)
    y = port(xt)
    np.testing.assert_allclose(y.detach().numpy(), plain.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(bn.apply(variables, x)), rtol=0, atol=1e-6
    )
    torch.sum(y.permute(0, 2, 3, 1) * torch.from_numpy(w_out)).backward()
    for got, want in (
        (port.weight.grad, want_grads["params"]["scale"]),
        (port.bias.grad, want_grads["params"]["bias"]),
        (port.running_mean.grad, want_grads["batch_stats"]["mean"]),
        (port.running_var.grad, want_grads["batch_stats"]["var"]),
        (xt.grad.permute(0, 2, 3, 1), want_gx),
    ):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert float(port.running_var.grad.abs().max()) > 0
    assert BN_EPS == nn.BatchNorm.epsilon


def test_batchnorm_without_grad_on_statistics_is_f_batch_norm():
    port = BatchNorm(8)
    torch.nn.init.normal_(port.running_mean)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.batch_norm(
        x, port.running_mean, port.running_var, port.weight, port.bias, training=False, eps=BN_EPS
    )
    assert torch.equal(port(x), want)


# -- the step against the tool's -------------------------------------------------


def test_optimizer_is_optax_adamw_defaults(jax_run):
    model = ts.make_model(jax_run["variables"][0], "cpu")
    opt = ts.make_optimizer(model, LR)
    (group,) = opt.param_groups
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (LR, (0.9, 0.999), 1e-8, 1e-4)
    named = ts.leaves(model)
    # every floating leaf, the BatchNorm statistics included
    assert len(group["params"]) == len(named) == len(model.state_dict())
    assert sum(t.numel() for t in named.values()) == 13_057_994
    stats = [t for name, t in named.items() if name.endswith(("running_mean", "running_var"))]
    assert len(stats) == 40 and all(t.requires_grad and t.is_leaf for t in stats)


@pytest.mark.parametrize("k", range(STEPS))
def test_step_against_the_tools_step(jax_run, k):
    """Step k from JAX's leaves and Adam moments before it: the loss,
    every leaf's gradient (batch_stats included) and the leaves after."""
    got = _port_step(jax_run, k)
    want = _want(jax_run, k)
    errors = bench.compare_records(got, want, LR, GRAD_RTOL)
    assert errors["fails"] == [], errors
    # most elements are decided, and the statistics are trained
    assert errors["decided_elements"] > errors["elements"] // 4
    for name in ("encoder.bn1.running_mean", "encoder.layer4_1.bn2.running_var"):
        assert float(got["grads"][name].abs().max()) > 0
        assert not torch.equal(got["leaves"][name], state_dict_from_flax(jax_run["variables"][k])[name])


def test_three_free_steps_track_the_tool(jax_run):
    model = ts.make_model(jax_run["variables"][0], "cpu")
    opt = ts.make_optimizer(model, LR)
    for k in range(STEPS):
        images, labels = jax_run["batches"][k]
        loss = float(ts.train_step(model, opt, torch.from_numpy(images), torch.from_numpy(labels)))
        assert abs(loss - jax_run["loss"][k]) <= bench.LOSS_RTOL * abs(jax_run["loss"][k])
    want = state_dict_from_flax(jax_run["variables"][STEPS])
    for name, leaf in ts.leaves(model).items():
        err = float((leaf.detach() - want[name]).abs().max())
        assert err <= STEPS * bench.UNDECIDED_LR * LR, (name, err)


def test_channels_last_changes_gradients_by_rounding_only(jax_run):
    images, labels = (torch.from_numpy(a) for a in jax_run["batches"][0])
    last = ts.make_model(jax_run["variables"][0], "cpu")
    want = bench.step_record(last, ts.make_optimizer(last, LR), images, labels)
    plain = FPNResNet18()
    plain.load_state_dict(state_dict_from_flax(jax_run["variables"][0]))
    for name, buf in plain.named_buffers():
        buf.requires_grad_(True)
    assert plain.encoder.conv1.weight.is_contiguous()
    got = bench.step_record(plain, ts.make_optimizer(plain, LR), images, labels)
    errors = bench.compare_records(got, want, LR, GRAD_RTOL)
    assert errors["fails"] == [], errors


def test_init_variables_are_flax_init_for_prngkey_0(jax_run):
    """The port's numpy draws against ``FPNResNet18.init(PRNGKey(0))``:
    kernels within 2e-6 of each leaf's largest (``erf``/``erfinv`` in
    fp64, XLA's fp32 approximations; measured 5.5e-7), every other leaf
    equal."""
    got = ts.init_variables(0)
    want = jax_run["variables"][0]
    g_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(got)}
    w_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert g_leaves.keys() == w_leaves.keys()
    for key, value in g_leaves.items():
        w = w_leaves[key]
        assert value.shape == w.shape and value.dtype == w.dtype == np.float32, key
        if "kernel" in key:
            np.testing.assert_allclose(value, w, rtol=0, atol=2e-6 * np.abs(w).max(), err_msg=key)
        else:
            np.testing.assert_array_equal(value, w, err_msg=key)


def test_threefry_pieces_are_jax_random_bit_for_bit():
    from flax.core.scope import _fold_in_static

    from acmpc_tpu_torch.models import flax_init

    for seed in (0, 7, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        assert flax_init.prng_key(seed) == tuple(int(w) for w in np.asarray(key))
        assert flax_init.fold_in(flax_init.prng_key(seed), 123456789) == tuple(
            int(w) for w in np.asarray(jax.random.fold_in(key, 123456789))
        )
        np.testing.assert_array_equal(
            flax_init.random_bits(flax_init.prng_key(seed), (3, 5, 7)), np.asarray(jax.random.bits(key, (3, 5, 7)))
        )
        path = ("encoder", "layer1_0", "conv1", 1)
        assert flax_init.fold_in_path(flax_init.prng_key(seed), path) == tuple(
            int(w) for w in np.asarray(_fold_in_static(key, path))
        )
    np.testing.assert_allclose(
        flax_init.truncated_normal((0, 0), (4096,)),
        np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(0), -2, 2, (4096,))),
        rtol=0, atol=2e-6,
    )


def test_torch_draws_have_flax_distributions(jax_run):
    got = bench.torch_draws(0)
    want = jax_run["variables"][0]
    w_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}
    for path, value in jax.tree_util.tree_leaves_with_path(got):
        key = jax.tree_util.keystr(path)
        w = w_leaves[key]
        assert value.shape == w.shape, key
        if "kernel" not in key:
            np.testing.assert_array_equal(value, w, err_msg=key)
            continue
        # a normal truncated at 2 sigma', std sqrt(1 / fan_in)
        std = np.sqrt(1.0 / np.prod(value.shape[:-1]))
        assert np.abs(value).max() <= 2.0 * std / 0.87962566103423978 * (1 + 1e-6)
        assert not np.array_equal(value, w)
        if value.size > 100_000:
            assert abs(value.std() / std - 1) < 0.01 and abs(w.std() / std - 1) < 0.01


def test_gradients_against_fp64(jax_run):
    """Both fp32 steps against the fp64 one from the same leaves: the
    port's and JAX's gradients alike within 1e-4 of each leaf's largest."""
    images, labels = jax_run["batches"][0]
    exact = bench.fp64_gradients(jax_run["variables"][0], images, labels)
    port = bench.gradient_error(_port_step(jax_run, 0)["grads"], exact)
    jax_side = bench.gradient_error(_want(jax_run, 0)["grads"], exact)
    assert port["max_rel"] < 1e-4 and jax_side["max_rel"] < 1e-4, (port, jax_side)


def test_sim_frames_render_the_sim_masks():
    cfg = loop.perception_config(320, 192, "fp32")
    centre, left, right, _ = loop.circuit()
    images, masks = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, 3)
    want = loop.sim_masks(loop.make_sim(cfg, centre, left, right), centre, 3)
    assert len(images) == 3 and images[0].shape == (192, 320, 3) and images[0].dtype == np.uint8
    for got, w in zip(masks, want):
        np.testing.assert_array_equal(got, w)
    assert not np.array_equal(images[0], images[1])


# -- the checkpoint and the CLI ----------------------------------------------


def test_checkpoint_loads_in_both_packages(jax_run, tmp_path, monkeypatch):
    # JAX's loader draws a template with FPNResNet18.init; run it under
    # jit, since eager it compiles op by op (~18 s on one core)
    eager_init = JFPN.init
    monkeypatch.setattr(
        JFPN, "init", lambda self, key, x: jax.jit(lambda k, v: eager_init(self, k, v))(key, x)
    )
    model = ts.make_model(jax_run["variables"][0], "cpu")
    images, labels = (torch.from_numpy(a) for a in jax_run["batches"][0])
    ts.train_step(model, ts.make_optimizer(model, LR), images, labels)
    path = tmp_path / "trained.msgpack"
    from acmpc_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, ts.checkpoint_tree(model))
    tree = serialization.msgpack_restore(path.read_bytes())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert {v.dtype for _, v in leaves} == {np.dtype(np.float16)}
    assert sum(v.size for _, v in leaves) == 13_057_994
    want_paths = {str(p) for p, _ in jax.tree_util.tree_leaves_with_path(jax_run["variables"][0])}
    assert {str(p) for p, _ in leaves} == want_paths

    cfg = dataclasses.replace(
        j_load_config(ROOT / "configs" / "monza.yaml").perception,
        image_width=W, image_height=H, precision="fp32", model_path=str(path),
    )
    j_seg = JTrackSegmenter(cfg)
    port_cfg = dataclasses.replace(
        load_config(ROOT / "configs" / "monza.yaml").perception,
        image_width=W, image_height=H, precision="fp32", model_path=str(path),
    )
    seg = TrackSegmenter(port_cfg, device="cpu")
    x = np.random.default_rng(4).random((1, H, W, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(j_seg.model.apply)(j_seg.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = seg.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    # the fp16 leaves are the trained fp32 ones rounded
    np.testing.assert_array_equal(
        read_checkpoint(path)["batch_stats"]["encoder"]["bn1"]["var"],
        model.encoder.bn1.running_var.detach().half().numpy(),
    )


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_main_on_the_cpu_writes_only_its_out(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # four validation frames, not 32: two evaluations at 192x320 on one
    # core would take most of this test's time
    monkeypatch.setattr(ts, "VAL_FRAMES", 4)
    out = tmp_path / "ckpt" / "fpn.msgpack"
    shipped = _digest(CHECKPOINT)
    default = ts.DEFAULT_OUT.stat().st_mtime_ns if ts.DEFAULT_OUT.exists() else None
    with pytest.raises(SystemExit) as exit_info:  # one step does not pass the gate
        ts.main(["--steps", "1", "--batch", "1", "--out", str(out)], device="cpu")
    assert exit_info.value.code == 1
    printed = capsys.readouterr()
    assert printed.out.splitlines()[0].startswith("step 0: loss ")
    assert f"wrote {out}" in printed.out and "did not reach IoU 0.9" in printed.err
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == [
        pathlib.Path("ckpt"), pathlib.Path("ckpt/fpn.msgpack")
    ]
    assert _digest(CHECKPOINT) == shipped
    assert (ts.DEFAULT_OUT.stat().st_mtime_ns if ts.DEFAULT_OUT.exists() else None) == default
    assert sum(v.size for v in jax.tree_util.tree_leaves(read_checkpoint(out))) == 13_057_994


def test_default_out_is_not_the_shipped_checkpoint():
    assert ts.DEFAULT_OUT.resolve() != CHECKPOINT.resolve()
    assert ts.DEFAULT_OUT.relative_to(ROOT).parts[0] == "build"


def test_train_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.train(steps=1, batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.main(["--steps", "1"])


def test_train_refuses_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            ts.train(steps=1, batch=1, device="cpu")
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_flop_count_of_a_step_on_meta_tensors():
    """FlopCounterMode over one step at the tool's shape, on meta
    tensors: the forward's convolutions and products, and the backward's
    twice as many less the first convolution's input gradient."""
    model = FPNResNet18().to("meta", memory_format=torch.channels_last)
    for _, buf in model.named_buffers():
        buf.requires_grad_(True)
    opt = ts.make_optimizer(model, LR)
    images = torch.zeros((16, ts.TRAIN_H, ts.TRAIN_W, 3), dtype=torch.uint8, device="meta")
    labels = torch.zeros((16, ts.TRAIN_H, ts.TRAIN_W), dtype=torch.uint8, device="meta")
    convs = []
    hooks = [
        m.register_forward_hook(lambda m, i, o: convs.append(2 * o.numel() * m.in_channels * m.weight[0, 0].numel()))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)
    ]
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            model(images.float())
    for h in hooks:
        h.remove()
    forward = counter.get_total_flops()
    head = 2 * 16 * (ts.TRAIN_H // 4) * (ts.TRAIN_W // 4) * 10 * 128  # F.conv2d, no module call
    assert forward == sum(convs) + head
    total = bench.count_flops(model, opt, images, labels)
    stem = 2 * 16 * 96 * 160 * 64 * 3 * 49  # conv1's input gradient, never taken
    assert total == 3 * forward - stem
