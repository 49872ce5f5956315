"""The port's YAML-subset parser and config schema against PyYAML and the
JAX package's load_config."""

import dataclasses
import pathlib

import pytest
import yaml

from acmpc_tpu.config import load_config as jax_load_config
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.config.yaml_subset import parse_yaml

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))
TRACKS = sorted(p.stem for p in (ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(ROOT)))
def test_parser_equals_safe_load(path):
    # exact: both produce Python scalars from the same text
    text = path.read_text()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_scalar_forms_equal_safe_load():
    text = (
        "# comment\n"
        "a: 1.0e-06\n"
        "b: 1e-5\n"
        "c: yes\n"
        "d: ~\n"
        "e: -.inf\n"
        "g:\n"
        "- 1\n"
        "- -2.5\n"
        "h:\n"
        "  i: null  # trailing\n"
        "  j: 0\n"
        "  k: text value\n"
        "m:\n"
    )
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    ["a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n", "a: |\n  b\n", "- a: 1\n", "a: 'q'\n"],
)
def test_unsupported_syntax_raises(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


@pytest.mark.parametrize("track", TRACKS)
def test_control_blocks_equal_jax(track):
    # exact: the same numbers, parsed by two parsers
    path = ROOT / "configs" / f"{track}.yaml"
    ours, ref = load_config(path), jax_load_config(path)
    for field in ("racing_control", "mapping_control", "vehicle"):
        assert dataclasses.asdict(getattr(ours, field)) == dataclasses.asdict(
            getattr(ref, field)
        ), field
    assert ours.map_speed_profile.ay_max == ref.map_speed_profile.ay_max
    assert ours.map_speed_profile.a_min == ref.map_speed_profile.a_min
    assert (ours.experiment, ours.seed) == (ref.experiment, ref.seed)
