"""SegFormer's head resample (``ops/segformer_resample.py``) on the CPU: the
plain version against the head's composition as it was written inline
(``F.interpolate`` of stages 2-4 and ``torch.cat``, deepest first), bit
for bit, at the stage grids of 1280x736 and of 640x384; the output's part
order and ``channels_last`` strides; ``DecodeHead`` through the op against
that composition; the wrapper's checks. The CUDA kernel runs on the card
only (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest
import torch
import torch.nn.functional as F

from acmpc_tpu_torch.bench.segformer_head import head_parts
from acmpc_tpu_torch.models import segformer as S
from acmpc_tpu_torch.ops import segformer_resample as op
from perfbench.reference.segformer import SHAPE_KEYS, random_state

SEED = 2**31 + 25
# the grids are what the resize's arithmetic depends on; the part width
# only repeats it, so the CPU runs the full grids at a narrow width
WIDTH = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inline(parts, size):
    """``DecodeHead.forward``'s resize and concatenation as it was written
    before the op."""
    resized = []
    for y in parts:
        if tuple(y.shape[-2:]) != tuple(size):
            y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
        resized.append(y)
    return torch.cat(resized[::-1], dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("frame", [(736, 1280), (384, 640)], ids=["1280x736", "640x384"])
def test_plain_version_is_the_inline_composition(frame, n, dtype):
    parts = head_parts(n, *frame, dtype, "cpu", seed=n, channels=WIDTH)
    size = parts[0].shape[-2:]
    got = op.segformer_resample(parts, size)
    want = _inline(parts, size)
    assert got.shape == (n, 4 * WIDTH, frame[0] // 4, frame[1] // 4) and got.dtype == dtype
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


def test_output_is_deepest_first_in_channels_last_memory():
    # each part constant at its own index: channel block q holds part 3 - q
    parts = head_parts(2, 64, 128, torch.float32, "cpu", channels=WIDTH)
    parts = [torch.full_like(p, float(i)) for i, p in enumerate(parts)]
    got = op.segformer_resample(parts, (16, 32))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.stride() == torch.empty(2, 4 * WIDTH, 16, 32, memory_format=torch.channels_last).stride()
    for q in range(4):
        assert bool((got[:, q * WIDTH:(q + 1) * WIDTH] == 3 - q).all()), q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_decode_head_equals_the_inline_composition(dtype):
    # the whole head (its Linears, the op, the fuse, BatchNorm, ReLU and
    # the classifier) against the same modules around the inline
    # composition, bit for bit, at the full decoder width
    cfg = S.SegformerConfig(depths=(1, 1, 1, 1))
    model = S.SegformerForSemanticSegmentation(cfg)
    model.load_state_dict(random_state(SEED, {k: getattr(cfg, k) for k in SHAPE_KEYS}))
    head = model.decode_head.eval().to(dtype)
    g = torch.Generator().manual_seed(3)
    feats = [S._map(torch.randn(1, h * w, c, generator=g).to(dtype), h, w)
             for c, (h, w) in zip(cfg.hidden_sizes, [(16, 32), (8, 16), (4, 8), (2, 4)])]
    with torch.no_grad():
        got = head(feats)
        parts = [S._map(mlp(S._tokens(x)), *x.shape[-2:]) for x, mlp in zip(feats, head.linear_c)]
        mixed = F.relu(head.batch_norm(head.linear_fuse(_inline(parts, (16, 32)))))
        want = head.classifier(mixed)
    assert got.shape == (1, 10, 16, 32) and got.dtype == dtype
    assert torch.equal(got, want)


def test_the_cpu_path_launches_no_kernel():
    op.segformer_resample.launches.clear()
    parts = head_parts(1, 64, 128, torch.bfloat16, "cpu", channels=S.SegformerConfig.decoder_hidden_size)
    op.segformer_resample(parts, (16, 32))
    assert sum(op.segformer_resample.launches.values()) == 0


def test_the_kernel_path_refuses_what_the_kernel_does_not_take():
    parts = head_parts(1, 64, 128, torch.bfloat16, "cpu")
    assert op._check(parts, (16, 32)) == (1, 16, 32)
    assert op._check([p.float() for p in parts], (16, 32)) == (1, 16, 32)
    with pytest.raises(ValueError, match="4 parts"):
        op._check(parts[:3], (16, 32))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        op._check([p.half() for p in parts], (16, 32))
    with pytest.raises(TypeError, match="part 2"):
        op._check([p.float() if i == 2 else p for i, p in enumerate(parts)], (16, 32))
    with pytest.raises(ValueError, match="channels_last"):
        op._check([p.contiguous() if i == 1 else p for i, p in enumerate(parts)], (16, 32))
    with pytest.raises(ValueError, match="768"):
        op._check(head_parts(1, 64, 128, torch.bfloat16, "cpu", channels=256), (16, 32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        op.segformer_resample([p.to("meta") for p in parts], (16, 32))
