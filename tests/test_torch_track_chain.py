"""The fused track-chain extraction (``ops/track_chain.chain_edges``)
against the JAX package, bit for bit.

``chain_edges_reference`` (the plain version) is held against JAX's
``select_vehicle_connected_runs`` + ``row_edge_columns`` on numpy masks:
bands 1-4 on heights that are not multiples of the band, bonnets inside
and at the frame's edge, the perception benchmark's adversarial and sim
masks, random masks, an empty frame and one whose chain never starts
(both the fallback), a chain that dies on its gap, seeds on the central
third's edge columns, runs across 32- and 64-bit word boundaries, full
rows, and widths 1280, 320 and ones that are not multiples of 64.
Columns, flags and masks are integers and bools, so all are exact.

A numpy model of ``csrc/track_chain_edges.cu``'s arithmetic (rows packed
to 64-bit words, word j on lane j % 32 of round j // 32; seeds spread by
an add's carry chain up each word and on bit-reversed words down it;
carries across lanes by carry-lookahead on 32-lane ballots; the banding,
the fallback and the edges from the packed bits) is held against the
plain version on the same rows, so the carry logic is proven without a
card. ``TrackLimitExtractor.extract`` is held against JAX through the
new call.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.perception import tracks as jtracks
from acmpc_tpu.perception.camera import CameraInfo as JCamera
from acmpc_tpu_torch.bench import chain_stages
from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.ops import track_chain
from acmpc_tpu_torch.perception import tracks
from acmpc_tpu_torch.perception.camera import CameraInfo

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANDS = (1, 2, 3, 4)
# the extractor's polylines, as tests/test_torch_perception.py: the
# homography and the 3x3 solves differ by fp32 rounding between the two
RAW_TOL = dict(rtol=1e-5, atol=1e-5)
POLY_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the cases ---------------------------------------------------------------


def _random(seed: int, H: int, W: int) -> np.ndarray:
    """Random vertical streaks and holes: runs that merge, split and
    break, long horizontal runs at high density."""
    rng = np.random.default_rng(seed)
    m = (rng.random((H, W)) < rng.uniform(0.3, 0.9)).astype(np.uint8)
    for r in range(H - 2, -1, -1):
        m[r] |= m[r + 1] & (rng.random(W) < 0.5)
    return m


def _road(H: int, W: int, lo: int, hi: int, rows: slice) -> np.ndarray:
    m = np.zeros((H, W), np.uint8)
    m[rows, lo:hi] = 1
    return m


def _never_starts(H: int, W: int) -> np.ndarray:
    # drivable only left and right of the central third [W // 3, 2W // 3)
    m = np.zeros((H, W), np.uint8)
    m[2:, : W // 3 - 1] = 1
    m[2:, 2 * W // 3 + 1 :] = 1
    return m


def _dies_on_gap(H: int, W: int) -> np.ndarray:
    # a road with a 9-row break: more than the tolerance in rows and in
    # bands at every band; the road above the break is another blob
    m = _road(H, W, W // 3, 2 * W // 3, slice(2, H))
    m[12:21] = 0
    return m


def _seed_edge(H: int, W: int, inside: bool) -> np.ndarray:
    # the lowest usable row touches the central third only in its first
    # and last column (or just outside them); runs above carry on from each
    lo, hi = W // 3, 2 * W // 3
    a, b = (lo, hi - 1) if inside else (lo - 1, hi)
    m = np.zeros((H, W), np.uint8)
    bonnet = H - 4
    m[: bonnet - 1, max(0, a - 40) : a + 1] = 1
    m[: bonnet - 1, b : min(W, b + 40)] = 1
    m[bonnet - 1, [a, b]] = 1
    return m


def _word_edges(H: int, W: int) -> np.ndarray:
    # a staircase of runs, each overlapping the one below, that start and
    # end on either side of 32- and 64-bit word edges
    m = np.zeros((H, W), np.uint8)
    spans = [(W // 3 - 5, 2 * W // 3 + 5), (W // 3 - 70, W // 3 + 1), (63, W // 3 - 60),
             (31, 65), (0, 33), (30, 128), (127, 129), (128, 193), (191, 256)]
    r = H - 4
    for lo, hi in spans:
        for _ in range(2):
            r -= 1
            m[r, max(0, lo) : min(W, hi)] = 1
    m[r - 1] = 1  # a full row closes it
    return m


def _cases():
    """name -> (mask, bonnet row, gap tolerance)."""
    cases = {}
    for H, W in ((70, 100), (48, 1280)):
        masks, bonnet = loop.adversarial_masks(H, W)
        for name, m in masks.items():
            cases[f"adversarial_{name}_{H}x{W}"] = (m, bonnet, 3)
    for seed, (H, W, bonnet, gap) in enumerate(
        [(40, 1280, 37, 3), (36, 320, 36, 1), (30, 100, 27, 0), (41, 1280, 45, 2), (23, 2500, 20, 3), (19, 320, 0, 3)]
    ):
        cases[f"random{seed}_{H}x{W}_bonnet{bonnet}_gap{gap}"] = (_random(seed, H, W), bonnet, gap)
    cases["empty_40x320"] = (np.zeros((40, 320), np.uint8), 36, 3)
    cases["never_starts_38x320"] = (_never_starts(38, 320), 34, 3)
    cases["dies_on_gap_42x320"] = (_dies_on_gap(42, 320), 38, 3)
    cases["seed_at_central_edges_30x320"] = (_seed_edge(30, 320, True), 26, 3)
    cases["seed_outside_central_30x320"] = (_seed_edge(30, 320, False), 26, 3)
    cases["word_edges_34x1280"] = (_word_edges(34, 1280), 30, 3)
    cases["word_edges_33x320"] = (_word_edges(33, 320), 33, 3)
    cases["full_rows_18x1280"] = (np.ones((18, 1280), np.uint8), 15, 3)
    cases["full_rows_10x100"] = (np.ones((10, 100), np.uint8), 10, 3)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def sim_masks():
    """Masks the port's sim renders at 320x192 on the perception
    benchmark's circuit (bonnet row 160)."""
    cfg = loop.perception_config(320, 192, "fp32")
    centre, left, right, _ = loop.circuit()
    return loop.sim_masks(loop.make_sim(cfg, centre, left, right), centre, 3)


def _jax_chain_edges(mask: np.ndarray, bonnet: int, gap: int, band: int):
    sel = jtracks.select_vehicle_connected_runs(jnp.asarray(mask), bonnet, gap, band)
    return (*(np.asarray(v) for v in jtracks.row_edge_columns(sel)), np.asarray(sel))


def _assert_equal(got, want):
    """(left, right, valid, mask) equal in values and numpy dtypes."""
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, w)
        assert g.shape == w.shape


# -- the plain version against JAX -------------------------------------------


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax(name, band):
    mask, bonnet, gap = CASES[name]
    want = _jax_chain_edges(mask, bonnet, gap, band)
    got = track_chain.chain_edges_reference(torch.from_numpy(mask), bonnet, gap, band, return_mask=True)
    assert [g.dtype for g in got] == [torch.int64, torch.int64, torch.bool, torch.uint8]
    _assert_equal(got, want)
    if name.startswith(("empty", "never_starts")):
        np.testing.assert_array_equal(want[3], mask)  # the fallback


@pytest.mark.parametrize("band", BANDS)
def test_reference_matches_jax_on_sim_masks(sim_masks, band):
    for mask in sim_masks:
        for bonnet in (160, 192):
            want = _jax_chain_edges(mask, bonnet, 3, band)
            _assert_equal(track_chain.chain_edges_reference(torch.from_numpy(mask), bonnet, 3, band, True), want)


def test_bands_walked_counts_the_kernel_steps():
    # the perception benchmark's count of the walk's steps (its chain
    # floor): rows 37..21 selected, then four empty rows end it
    mask, bonnet, gap = CASES["dies_on_gap_42x320"]
    assert chain_stages.bands_walked(torch.from_numpy(mask), bonnet, 1, gap) == 17 + 4
    # a chain that never starts walks every usable band
    mask, bonnet, gap = CASES["empty_40x320"]
    for band in BANDS:
        assert chain_stages.bands_walked(torch.from_numpy(mask), bonnet, band, gap) == -(-bonnet // band)


def test_cases_cover_what_they_claim():
    # the chain dies on the gap: rows above the break hold road but no selection
    sel = _jax_chain_edges(*CASES["dies_on_gap_42x320"], 1)[3]
    assert sel[2:12].sum() == 0 and sel[21:38].sum() > 0
    # a seed on the central third's first and last column starts both
    # runs; one column outside starts neither (the fallback)
    mask, bonnet, gap = CASES["seed_at_central_edges_30x320"]
    sel = _jax_chain_edges(mask, bonnet, gap, 1)[3]
    assert sel[0, 106 - 40] == 1 and sel[0, 212 + 39] == 1
    mask, bonnet, gap = CASES["seed_outside_central_30x320"]
    np.testing.assert_array_equal(_jax_chain_edges(mask, bonnet, gap, 1)[3], mask)
    # the staircase reaches its top: every run is selected
    mask, bonnet, gap = CASES["word_edges_34x1280"]
    np.testing.assert_array_equal(_jax_chain_edges(mask, bonnet, gap, 1)[3], mask)


# -- a numpy model of the kernel's word and lane arithmetic ------------------

LANES = 32
U64 = np.uint64
ALL_ONES = U64(0xFFFF_FFFF_FFFF_FFFF)
_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def _pack(bits: np.ndarray, n_words: int) -> np.ndarray:
    """(H, W) bool -> (H, n_words) uint64, column c at bit c % 64 of word
    c // 64 (the kernel's 16-bit stores of 16 columns, little-endian)."""
    H, W = bits.shape
    padded = np.zeros((H, 64 * n_words), bool)
    padded[:, :W] = bits
    return np.packbits(padded, axis=1, bitorder="little").view("<u8").reshape(H, n_words)


def _unpack(words: np.ndarray, W: int) -> np.ndarray:
    return np.unpackbits(words.astype("<u8").view(np.uint8), axis=1, bitorder="little")[:, :W]


def _brev64(x: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(x, dtype="<u8").view(np.uint8).reshape(x.shape + (8,))
    return np.ascontiguousarray(_REV8[b][..., ::-1]).view("<u8").reshape(x.shape)


def _brev32(v: int) -> int:
    return int(f"{v:032b}"[::-1], 2)


def _fill_up(x, s):
    return (((x + s) ^ x ^ s) | s) & x


def _bottom_run(x):
    return x & ~(x + U64(1))


def _ballot(pred: np.ndarray) -> int:
    return sum(1 << lane for lane in np.flatnonzero(pred))


def _lanes(mask32: int) -> np.ndarray:
    return ((mask32 >> np.arange(LANES)) & 1).astype(bool)


def spread(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The runs of the words ``x`` holding a seed of ``s``, as the walking
    warp computes them: (K * 32,) words, word j on lane j % 32 of round
    j // 32."""
    K = x.size // LANES
    up = _fill_up(x, s)
    rx = _brev64(x)
    dn = _brev64(_fill_up(rx, _brev64(s)))
    sel = up | dn
    full = [_ballot(x[i * LANES : (i + 1) * LANES] == ALL_ONES) for i in range(K)]
    carry = 0
    for i in range(K):  # up the lanes, round to round
        w = slice(i * LANES, (i + 1) * LANES)
        g = _ballot((up[w] >> U64(63)) == 1)
        a = g | full[i]
        total = a + g + carry
        carry_in = (total ^ a ^ g) & 0xFFFF_FFFF
        carry = total >> 32
        sel[w] |= np.where(_lanes(carry_in), _bottom_run(x[w]), U64(0))
    carry = 0
    for i in reversed(range(K)):  # down, on lane-reversed ballots
        w = slice(i * LANES, (i + 1) * LANES)
        g = _brev32(_ballot((dn[w] & U64(1)) == 1))
        a = g | _brev32(full[i])
        total = a + g + carry
        carry_in = _brev32((total ^ a ^ g) & 0xFFFF_FFFF)
        carry = total >> 32
        sel[w] |= np.where(_lanes(carry_in), _brev64(_bottom_run(rx[w])), U64(0))
    return sel


def model_chain_edges(mask: np.ndarray, bonnet: int, gap_tolerance: int, band: int):
    """The kernel's three stages in numpy: (left, right, valid, mask)."""
    H, W = mask.shape
    n_words = -(-W // 64)
    K = -(-n_words // LANES)
    raw = _pack(mask != 0, K * LANES)
    band = max(1, band)
    gap = gap_tolerance if band == 1 else max(1, round(gap_tolerance / band))
    rbot = min(max(bonnet, 0), H)
    n_bands = -(-H // band)
    cols = np.arange(K * LANES * 64).reshape(1, -1)
    central = _pack((cols >= W // 3) & (cols < 2 * W // 3), K * LANES)[0]
    band_sel = np.zeros((n_bands, K * LANES), U64)
    has = np.zeros(n_bands, bool)
    started, miss, prev = False, 0, np.zeros(K * LANES, U64)
    for k in range((rbot + band - 1) // band - 1, -1, -1):
        x = np.bitwise_or.reduce(raw[k * band : min(k * band + band, rbot)], axis=0)
        sel = spread(x, x & (prev if started else central))
        if sel.any():
            band_sel[k], has[k], prev = sel, True, sel
        started = started or has[k]
        miss = 0 if has[k] else miss + started
        if miss > gap:
            break
    rows = np.arange(H)
    if started:
        keep = (rows < rbot) & has[rows // band]
        raw = np.where(keep[:, None], raw & band_sel[rows // band], U64(0))
    bits = _unpack(raw, W)
    valid = bits.any(axis=1)
    left = np.where(valid, bits.argmax(axis=1), 0)
    right = np.where(valid, W - 1 - bits[:, ::-1].argmax(axis=1), 0)
    return left, right, valid, bits.astype(mask.dtype)


def test_band_quotient_by_multiply():
    # the kernel's r // band as the high word of r * ceil(2^32 / band),
    # exact while r * band < 2^32: every row of a frame the shared memory
    # holds, at every band up to its height
    r = np.arange(1 << 15, dtype=np.uint64)
    for band in range(2, 1 << 11):
        magic = np.uint64(0xFFFF_FFFF // band + 1)
        np.testing.assert_array_equal((r * magic) >> np.uint64(32), r // np.uint64(band))


def test_byte_packing_constants():
    """The kernel's 4-bytes-to-4-bits and 4-bits-to-4-bytes multiplies."""
    for n in range(16):
        ones = sum(((n >> i) & 1) << (8 * i) for i in range(4))  # __vsetne4's bytes
        assert ((ones * 0x10204080) & 0xFFFF_FFFF) >> 28 == n
        assert (n * 0x00204081) & 0x01010101 == ones


def test_spread_fills_runs_across_words_and_rounds():
    rng = np.random.default_rng(0)
    for K in (1, 2, 4):
        for density in (0.5, 0.97, 1.0):
            bits = rng.random(K * LANES * 64) < density
            seeds = bits & (rng.random(bits.size) < 0.002)
            x = _pack(bits[None], K * LANES)[0]
            got = _unpack(spread(x, _pack(seeds[None], K * LANES)[0])[None], bits.size)[0]
            # runs by label: a run is selected iff it holds a seed
            run = np.cumsum(~bits)
            seeded = np.zeros(bits.size + 1, bool)
            seeded[run[seeds]] = True
            np.testing.assert_array_equal(got.astype(bool), bits & seeded[run])


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_reference(name, band):
    mask, bonnet, gap = CASES[name]
    want = track_chain.chain_edges_reference(torch.from_numpy(mask), bonnet, gap, band, True)
    _assert_equal(model_chain_edges(mask, bonnet, gap, band), [w.numpy() for w in want])


@pytest.mark.parametrize(
    "H, W, bonnet", [(16, 4096, 14), (12, 8192, 12), (20, 2049, 17), (9, 64, 9), (7, 1, 6)]
)
def test_model_matches_reference_at_other_widths(H, W, bonnet):
    # two and four rounds of 32 lanes; one word over a round; one word; one column
    for mask in (_random(W, H, W), np.ones((H, W), np.uint8)):
        for band in (1, 4):
            want = track_chain.chain_edges_reference(torch.from_numpy(mask), bonnet, 3, band, True)
            _assert_equal(model_chain_edges(mask, bonnet, 3, band), [w.numpy() for w in want])


def test_model_matches_reference_on_sim_masks(sim_masks):
    for mask in sim_masks:
        for band in (1, 4):
            want = track_chain.chain_edges_reference(torch.from_numpy(mask), 160, 3, band, True)
            _assert_equal(model_chain_edges(mask, 160, 3, band), [w.numpy() for w in want])


# -- the wrapper on the CPU ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool])
def test_chain_edges_on_cpu_takes_the_plain_version(dtype):
    mask, bonnet, gap = CASES["random0_40x1280_bonnet37_gap3"]
    t = torch.from_numpy(mask).to(dtype)
    track_chain.chain_edges.launches.clear()
    for band in BANDS:
        got = track_chain.chain_edges(t, bonnet, gap, band, return_mask=True)
        want = track_chain.chain_edges_reference(t, bonnet, gap, band, return_mask=True)
        assert got[3].dtype == dtype
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        edges = track_chain.chain_edges(t, bonnet, gap, band)
        assert len(edges) == 3 and all(torch.equal(g, w) for g, w in zip(edges, want))
    assert sum(track_chain.chain_edges.launches.values()) == 0


def test_select_vehicle_connected_runs_is_the_chain_edges_mask():
    mask, bonnet, gap = CASES["adversarial_hairpin_70x100"]
    t = torch.from_numpy(mask)
    for band in BANDS:
        got = tracks.select_vehicle_connected_runs(t, bonnet, gap, band)
        assert torch.equal(got, track_chain.chain_edges(t, bonnet, gap, band, return_mask=True)[3])


@pytest.mark.parametrize(
    "mask, gap, error",
    [
        (torch.zeros(4, 8, dtype=torch.float32), 3, TypeError),
        (torch.zeros(4, 8, dtype=torch.int32), 3, TypeError),
        (torch.zeros(8, dtype=torch.uint8), 3, ValueError),
        (torch.zeros(2, 4, 8, dtype=torch.uint8), 3, ValueError),  # one frame only
        (torch.zeros(0, 8, dtype=torch.uint8), 3, ValueError),
        (torch.zeros(4, 0, dtype=torch.uint8), 3, ValueError),
        (torch.zeros(4, 8, dtype=torch.uint8), -1, ValueError),
        (torch.zeros(2, track_chain.EDGES_MAX_WIDTH + 1, dtype=torch.uint8), 3, ValueError),
        # more rows than the block's shared memory holds
        (torch.zeros(1500, 1280, dtype=torch.uint8), 3, ValueError),
    ],
)
def test_chain_edges_refuses_what_the_kernel_does_not_take(mask, gap, error):
    track_chain.chain_edges.launches.clear()
    with pytest.raises(error):
        track_chain.chain_edges(mask, 4, gap, 1)
    assert sum(track_chain.chain_edges.launches.values()) == 0


@pytest.mark.parametrize("band", BANDS)
def test_shipped_camera_fits_the_kernel(band):
    # every config's camera is 1280x736; the frame must fit at every band
    cfg = load_config(ROOT / "configs" / "monza.yaml").perception
    H, W = cfg.image_height, cfg.image_width
    words = -(-W // 64) | 1  # rows padded to an odd number of words
    expect = 8 * words * H + (8 * words * -(-H // band) if band > 1 else 0) + -(-H // band)
    assert track_chain.edges_smem_bytes(H, W, band) == expect <= track_chain.EDGES_MAX_SMEM
    assert track_chain.chain_edges(torch.zeros(H, W, dtype=torch.uint8), 600, 3, band)[2].sum() == 0


# -- the extractor through the new call ------------------------------------------

SMALL = dict(
    image_width=320, image_height=192, n_rows_to_remove_bonnet=160, n_polyfit_points=200,
    camera_position=(0.0, 0.0, 1.2), camera_pitch_deg=9.0, precision="fp32",
)


@pytest.mark.parametrize("band", BANDS)
def test_extract_matches_jax_through_chain_edges(sim_masks, band, monkeypatch):
    path = ROOT / "configs" / "monza.yaml"
    j = dataclasses.replace(j_load_config(path).perception, **SMALL)
    t = dataclasses.replace(load_config(path).perception, **SMALL)
    jcfg = dataclasses.replace(jtracks.TrackExtractionConfig.from_config(j), connectivity_band=band)
    tcfg = dataclasses.replace(tracks.TrackExtractionConfig.from_config(t), connectivity_band=band)
    jext = jax.jit(jtracks.TrackLimitExtractor(jcfg, JCamera.from_config(j)).extract)
    ext = tracks.TrackLimitExtractor(tcfg, CameraInfo.from_config(t), device="cpu")
    calls = []

    def counted(mask, bonnet_row, **kwargs):
        calls.append((bonnet_row, kwargs["band"]))
        return track_chain.chain_edges(mask, bonnet_row, **kwargs)

    monkeypatch.setattr(tracks, "chain_edges", counted)
    adversarial, _ = loop.adversarial_masks(192, 320)
    masks = [*sim_masks, adversarial["hairpin"], np.zeros_like(sim_masks[0])]
    for mask in masks:
        with jax.default_matmul_precision("highest"):
            want = jext(jnp.asarray(mask))
        got = ext.extract(torch.from_numpy(mask))
        assert set(got) == set(want)
        for key in ("left_raw_mask", "right_raw_mask"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        for key in ("left_raw", "right_raw"):
            valid = np.asarray(want[f"{key}_mask"])
            np.testing.assert_allclose(got[key].numpy()[valid], np.asarray(want[key])[valid], **RAW_TOL)
        for key in ("left", "right", "centre"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **POLY_TOL)
    # one call a frame, at the config's bonnet and band
    assert calls == [(160, band)] * len(masks)
