"""The FPN-ResNet18 port and its checkpoint IO against the JAX package.

The port's msgpack reader against ``flax.serialization.msgpack_restore``
on the shipped checkpoint; the writer read back by Flax; the model's
logits against the Flax model's on the same weights (``variables``
carried across as numpy), fp32 on both sides with the JAX side under
``jax.default_matmul_precision("highest")``, since XLA's CPU
convolutions otherwise round fp32 operands through bf16.

Tolerance on fp32 logits: 1e-4 absolute (logits reach ~17). The two
libraries sum each convolution's products (up to 4,608 per output) in
different orders, ~1e-7 relative per layer over ~25 layers; measured
1.3e-5 at 192x320 on the shipped weights. The argmax masks are equal
except where the top two logits are within twice that tolerance.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from acmpc_tpu.models.fpn_resnet18 import FPNResNet18 as JFPN
from acmpc_tpu.models.fpn_resnet18 import convert_torch_state_dict as j_convert
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.convert import fpn_state_dict_from_numpy
from acmpc_tpu_torch.models.checkpoint import (
    msgpack_restore,
    msgpack_serialize,
    read_checkpoint,
    write_checkpoint,
)
from acmpc_tpu_torch.models.fpn_resnet18 import (
    FPNResNet18,
    convert_torch_state_dict,
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from acmpc_tpu_torch.perception.segmentation import (
    PRECISION,
    TrackSegmenter,
    TrackSegmenterAOT,
    load_variables,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_weight_converter import TorchSmpFPN, _randomise  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHECKPOINT = ROOT / "data" / "models" / "segmentation" / "synthetic_fpn.msgpack"
LOGIT_TOL = 1e-4
N_PARAMETERS = 13_057_994


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def shipped():
    return read_checkpoint(CHECKPOINT)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _random_variables(seed: int, shape=(1, 64, 96, 3)):
    """Flax-init weights with randomised norm scales, biases and running
    statistics, so every tensor moves the output (numpy leaves)."""
    v = JFPN().init(jax.random.PRNGKey(seed), jnp.zeros(shape))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, val in tree.items():
            if isinstance(val, dict):
                perturb(val)
            elif k == "mean":
                tree[k] = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif k in ("scale", "bias"):
                tree[k] = (val + rng.normal(0.0, 0.1, val.shape)).astype(np.float32)

    v = jax.tree_util.tree_map(np.array, v)
    perturb(v)
    return v


def _port_logits(variables, x: np.ndarray, dtype=torch.float32) -> np.ndarray:
    model = FPNResNet18()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model = model.to(dtype=dtype, memory_format=torch.channels_last).eval()
    with torch.no_grad():
        return model(torch.from_numpy(x).to(dtype)).float().numpy()


def _jax_logits(variables, x: np.ndarray) -> np.ndarray:
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(JFPN().apply)(variables, jnp.asarray(x)))


def _assert_masks_match(want: np.ndarray, got: np.ndarray):
    top2 = np.sort(want, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) < 2 * LOGIT_TOL
    differ = want.argmax(-1) != got.argmax(-1)
    assert not (differ & ~close).any()


# -- the msgpack checkpoint ----------------------------------------------


def test_reader_matches_flax_on_shipped_checkpoint(shipped):
    want = serialization.msgpack_restore(CHECKPOINT.read_bytes())
    _assert_trees_equal(want, shipped)
    dtypes = {x.dtype for _, x in _leaves(shipped)}
    assert dtypes == {np.dtype(np.float16)}
    assert sum(x.size for _, x in _leaves(shipped)) == N_PARAMETERS


def test_reader_raises_on_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_checkpoint(tmp_path / "absent.msgpack")


@pytest.mark.parametrize(
    "damage",
    ["empty", "truncated", "chunked", "unknown_ext", "unknown_dtype", "not_a_dict"],
)
def test_reader_raises_on_damaged_file(tmp_path, damage):
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    data = serialization.msgpack_serialize(tree)
    if damage == "empty":
        data = b""
    elif damage == "truncated":
        data = data[: len(data) // 2]
    elif damage == "chunked":
        # the form Flax gives arrays over 2**30 bytes
        chunked = {
            "__msgpack_chunked_array__": True,
            "shape": {"0": 6},
            "chunks": {"0": np.arange(6, dtype=np.float32)},
        }
        data = serialization.msgpack_serialize({"params": {"w": chunked}})
    elif damage == "unknown_ext":
        data = msgpack.packb({"params": {"w": msgpack.ExtType(7, b"\x00")}})
    elif damage == "unknown_dtype":
        payload = msgpack.packb(((2,), "float99", bytes(8)))
        data = msgpack.packb({"params": {"w": msgpack.ExtType(1, payload)}})
    else:
        data = msgpack.packb([1, 2, 3])
    path = tmp_path / "damaged.msgpack"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        read_checkpoint(path)


def test_reader_takes_numpy_scalars():
    tree = {"step": np.int32(7), "lr": np.float32(0.5), "w": np.ones((2,), np.float16)}
    got = msgpack_restore(serialization.msgpack_serialize(tree))
    assert got["step"] == 7 and got["step"].dtype == np.int32
    assert got["lr"] == 0.5 and got["w"].dtype == np.float16


def test_reader_widens_bfloat16_as_the_jax_package_saves_it():
    # TrackSegmenter.save_variables at bf16 precision stores bfloat16 leaves
    w = jnp.asarray(np.linspace(-3.0, 3.0, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    got = msgpack_restore(serialization.to_bytes({"params": {"w": w}}))["params"]["w"]
    assert got.dtype == np.float32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got, np.asarray(w.astype(jnp.float32)))


def test_writer_is_read_back_by_flax(tmp_path, shipped):
    path = tmp_path / "copy.msgpack"
    write_checkpoint(path, shipped)
    _assert_trees_equal(shipped, serialization.msgpack_restore(path.read_bytes()))
    _assert_trees_equal(shipped, read_checkpoint(path))
    # byte-for-byte the file Flax writes of the same tree
    assert path.read_bytes() == CHECKPOINT.read_bytes()


def test_writer_refuses_other_leaves():
    with pytest.raises(TypeError):
        msgpack_serialize({"w": object()})
    with pytest.raises(ValueError):
        msgpack_serialize({"w": np.array([None, 1], dtype=object)})


# -- the model -----------------------------------------------------------


def test_state_dict_covers_the_model(shipped):
    sd = state_dict_from_flax(shipped)
    model = FPNResNet18()
    assert set(sd) == set(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == N_PARAMETERS
    assert all(v.dtype == torch.float16 for v in sd.values())
    # HWIO -> OIHW
    np.testing.assert_array_equal(
        sd["encoder.conv1.weight"].numpy(),
        shipped["params"]["encoder"]["conv1"]["kernel"].transpose(3, 2, 0, 1),
    )
    assert fpn_state_dict_from_numpy(shipped).keys() == sd.keys()
    # and back: the same tree, leaves bit-equal and fp16
    _assert_trees_equal(shipped, flax_tree_from_state_dict(sd))


@pytest.mark.parametrize("seed", [0, 1])
def test_fpn_matches_flax_with_init_weights(seed):
    variables = _random_variables(seed)
    x = np.random.default_rng(100 + seed).random((1, 64, 96, 3)).astype(np.float32)
    want = _jax_logits(variables, x)
    got = _port_logits(variables, x)
    assert got.shape == want.shape == (1, 64, 96, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    _assert_masks_match(want, got)


def test_fpn_matches_flax_with_shipped_weights(shipped):
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float32), shipped)
    x = np.random.default_rng(7).random((1, 192, 320, 3)).astype(np.float32)
    want = _jax_logits(variables, x)
    got = _port_logits(variables, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    _assert_masks_match(want, got)


@pytest.mark.parametrize("shape", [(1, 48, 96, 3), (1, 64, 80, 3), (1, 33, 33, 3)])
def test_fpn_refuses_dims_not_divisible_by_32(shape):
    with pytest.raises(ValueError, match="divisible by 32"):
        FPNResNet18()(torch.zeros(shape))


def test_head_runs_in_fp32_in_bf16_model(shipped):
    x = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
    model = FPNResNet18()
    model.load_state_dict(state_dict_from_flax(shipped))
    model = model.to(dtype=torch.bfloat16).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.float32 and out.shape == (1, 64, 64, 10)


def test_converter_matches_jax_on_smp_state_dict(tmp_path):
    smp = TorchSmpFPN().eval()
    _randomise(smp, seed=1)
    sd = {k: v.numpy() for k, v in smp.state_dict().items()}
    want = jax.tree_util.tree_map(np.asarray, j_convert(sd))
    got = convert_torch_state_dict(sd)
    _assert_trees_equal(want, got)
    # the .pt branch of the loader, and the port model against the smp
    # replica's own forward pass
    path = tmp_path / "smp.pt"
    torch.save(smp.state_dict(), path)
    _assert_trees_equal(got, load_variables(path))
    x = np.random.default_rng(5).random((1, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        want_logits = smp(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(_port_logits(got, x), want_logits, rtol=0, atol=LOGIT_TOL)


# -- the segmenter ---------------------------------------------------------


def _small_cfg(precision="fp32"):
    cfg = load_config(ROOT / "configs" / "monza.yaml").perception
    return dataclasses.replace(
        cfg, image_width=96, image_height=64, n_rows_to_remove_bonnet=56, precision=precision
    )


@pytest.mark.parametrize("precision", sorted(PRECISION))
def test_segmenter_casts_parameters_to_compute_dtype(shipped, precision):
    seg = TrackSegmenter(_small_cfg(precision), shipped, device="cpu")
    assert {p.dtype for p in seg.model.state_dict().values()} == {PRECISION[precision]}
    # cast from the stored fp16 as the JAX package casts
    want = shipped["params"]["p5"]["bias"].astype(np.float32)
    got = seg.model.p5.bias.float().numpy()
    if precision in ("fp32", "full", "fp16"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, jnp.asarray(want, jnp.bfloat16).astype(np.float32))


def test_segmenter_raises_on_missing_checkpoint(tmp_path):
    cfg = dataclasses.replace(_small_cfg(), model_path=str(tmp_path / "absent.msgpack"))
    with pytest.raises(FileNotFoundError):
        TrackSegmenter(cfg, device="cpu")


def test_segmenter_loads_config_path_and_saves(tmp_path):
    seg = TrackSegmenterAOT(dataclasses.replace(_small_cfg(), model_path=str(CHECKPOINT)), device="cpu")
    path = tmp_path / "saved.msgpack"
    seg.save_variables(path)
    back = serialization.msgpack_restore(path.read_bytes())
    want = jax.tree_util.tree_map(lambda a: a.astype(np.float32), read_checkpoint(CHECKPOINT))
    _assert_trees_equal(want, back)
    image = np.random.default_rng(0).integers(0, 255, (64, 96, 3), dtype=np.uint8)
    drivable, semantics = seg.segment_drivable_area(image)
    assert drivable.shape == semantics.shape == (64, 96)
    assert drivable.dtype == semantics.dtype == torch.uint8
    assert set(np.unique(drivable.numpy())) <= {0, 1}
