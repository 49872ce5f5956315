"""The port's public surface against the JAX package's (CPU).

An AST walk of both packages: every public function, class, method,
field and argument of ``acmpc_tpu/`` must have a counterpart at the same
relative path of ``acmpc_tpu_torch/``, except the omissions listed in
OMITTED, each recorded in CHANGES.md with its reason. An omission that
is no longer missing fails too, so the list stays exact. Then the names
the port added last import and behave: ``solve_control_qp`` against
JAX's on the monza horizon-50 QP at tests/test_torch_admm.py's X_TOL.
"""

import ast
import dataclasses
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "acmpc_tpu", ROOT / "acmpc_tpu_torch"
X_TOL = dict(rtol=2e-2, atol=2e-2)

# key: a module, "module::name", "module::Class.member" or
# "module::function(argument)"; value: why the port has no counterpart
_FLAX_DTYPE = (
    "a Flax module's compute dtype is a field; an nn.Module's is its parameters' "
    "(Module.to), which TrackSegmenter sets from perception.precision"
)
_DRAWS = (
    "a jax.random key; the port's filter takes its draws from a source passed to each "
    "call (TorchDraws on a torch.Generator, or ScriptedDraws replaying JAX's numbers)"
)
_ONE_VALUE = "a JAX engine option with one value on every caller; the port has that value only"
OMITTED = {
    "ops/pallas_admm.py": "the TPU kernels; their Hopper kernels are csrc/admm_chunk*.cu "
    "behind ops/admm_chunk.py",
    "ops/__init__.py::admm_iterations_pallas": "goes with ops/pallas_admm.py",
    "utils/compile_cache.py": "XLA's persistent compile cache; ops/cuda_build.py keys the "
    "kernels' build cache by hash, and there is no XLA cache to keep",
    "qp/admm.py::ADMMConfig.use_pallas": _ONE_VALUE,
    "qp/admm.py::ADMMConfig.refine_steps": _ONE_VALUE,
    "qp/admm.py::ADMMConfig.iter_precision": _ONE_VALUE,
    "bench/lap_sweep.py::SweepGrid.perturbed(key)": "a jax.random key; the port draws from "
    "a torch.Generator (generator)",
    "localise/particle_filter.py::PFState.key": _DRAWS,
    "localise/particle_filter.py::ParticleFilter.reset(key)": _DRAWS,
    "models/fpn_resnet18.py::BasicBlock.dtype": _FLAX_DTYPE,
    "models/fpn_resnet18.py::ResNet18Encoder.dtype": _FLAX_DTYPE,
    "models/fpn_resnet18.py::Conv3x3GNReLU.dtype": _FLAX_DTYPE,
    "models/fpn_resnet18.py::SegmentationBlock.dtype": _FLAX_DTYPE,
    "models/fpn_resnet18.py::FPNResNet18.dtype": _FLAX_DTYPE,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one intra-op thread per test worker: the parallel run shares the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _arguments(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [f"*{a.vararg.arg}"] if a.vararg else []
    names += [f"**{a.kwarg.arg}"] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


@dataclasses.dataclass
class _Class:
    bases: list[str]
    members: dict  # name -> argument list (methods) or None (fields)


def _surface(path: pathlib.Path):
    """(names bound at top level, public functions -> arguments, classes,
    exported names: ``__all__``, else the names imported by ``from``) of
    one module."""
    tree = ast.parse(path.read_text())
    bound, functions, classes, from_imports, all_names = set(), {}, {}, [], None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            functions[node.name] = _arguments(node)
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
            members = {}
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members[item.name] = _arguments(item)
                elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                    members[item.target.id] = None
                elif isinstance(item, ast.Assign):
                    members.update({t.id: None for t in item.targets if isinstance(t, ast.Name)})
            classes[node.name] = _Class([b.id for b in node.bases if isinstance(b, ast.Name)], members)
        elif isinstance(node, ast.ImportFrom):
            names = [a.asname or a.name for a in node.names]
            bound.update(names)
            from_imports += names
        elif isinstance(node, ast.Import):
            bound.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            bound.update(targets)
            if "__all__" in targets:
                all_names = list(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            bound.add(node.target.id)
    exported = from_imports if all_names is None else all_names
    return bound, functions, classes, [n for n in exported if _public(n)]


def _members(classes: dict, name: str) -> dict:
    """A class's members with those of its bases in the same module."""
    cls = classes[name]
    out = {}
    for base in cls.bases:
        if base in classes:
            out.update(_members(classes, base))
    out.update(cls.members)
    return out


def _counterpart(rel: pathlib.Path) -> pathlib.Path | None:
    """The port's module at ``rel``, or the module that stands for a
    package (``native/__init__.py`` -> ``native.py``)."""
    if (PORT_PKG / rel).is_file():
        return PORT_PKG / rel
    if rel.name == "__init__.py" and rel.parent.name:
        module = PORT_PKG / rel.parent.with_suffix(".py")
        return module if module.is_file() else None
    return None


def _missing() -> list[str]:
    """Every public name or argument of the JAX package the port lacks."""
    missing = []
    for jax_path in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_path.relative_to(JAX_PKG)
        mod = rel.as_posix()
        port_path = _counterpart(rel)
        if port_path is None:
            missing.append(mod)
            continue
        j_bound, j_funcs, j_classes, j_exported = _surface(jax_path)
        p_bound, p_funcs, p_classes, _ = _surface(port_path)
        names = set(j_exported) if rel.name == "__init__.py" else set()
        names |= {n for n in list(j_funcs) + list(j_classes) if _public(n)}
        for name in sorted(names):
            if name not in p_bound:
                missing.append(f"{mod}::{name}")
            elif name in j_funcs and name in p_funcs:
                missing += [f"{mod}::{name}({a})" for a in j_funcs[name] if a not in p_funcs[name]]
            elif name in j_classes and name in p_classes:
                theirs = _members(j_classes, name)
                ours = _members(p_classes, name)
                init_args = ours.get("__init__") or []
                for member, args in theirs.items():
                    if not (_public(member) or member == "__init__"):
                        continue
                    if member not in ours and member not in init_args:
                        missing.append(f"{mod}::{name}.{member}")
                    elif args is not None and ours.get(member) is not None:
                        missing += [
                            f"{mod}::{name}.{member}({a})" for a in args if a not in ours[member]
                        ]
    return missing


def test_every_public_name_has_a_counterpart():
    missing = _missing()
    unlisted = [m for m in missing if m not in OMITTED]
    assert not unlisted, f"the port lacks {unlisted}"
    stale = sorted(set(OMITTED) - set(missing))
    assert not stale, f"listed as omitted, but present in the port: {stale}"


def test_every_omission_is_recorded_with_its_reason():
    changes = (ROOT / "CHANGES.md").read_text()
    for key, reason in OMITTED.items():
        assert len(reason) > 20, key
        assert f"`{key}`" in changes, f"{key} is not in CHANGES.md"


def test_the_walk_sees_the_surface():
    """The checker itself: it finds the port's counterparts of names the
    two packages share, and reports what a module lacks."""
    _, funcs, classes, exported = _surface(PORT_PKG / "mpc" / "__init__.py")
    assert {"solve_control_qp", "SpatialMPC"} <= set(exported)
    _, funcs, classes, _ = _surface(PORT_PKG / "mpc" / "spatial_mpc.py")
    members = _members(classes, "SpatialMPC")
    assert {"delta_max", "batched_get_control", "get_control"} <= set(members)
    assert "dtype" in members["__init__"] and "dtype" in funcs["build_mpc"]
    _, _, seg, _ = _surface(PORT_PKG / "perception" / "segmentation.py")
    assert "segment_drivable_area" in _members(seg, "TrackSegmenterAOT")  # inherited
    assert _counterpart(pathlib.Path("native/__init__.py")) == PORT_PKG / "native.py"
    assert _counterpart(pathlib.Path("ops/pallas_admm.py")) is None


# -- the names this slice added ---------------------------------------------------


def test_new_names_import():
    from acmpc_tpu.utils import convert_radians_to_plus_minus_pi as j_convert
    from acmpc_tpu_torch.config import LocalisationConfig, PerceptionConfig
    from acmpc_tpu_torch.config.schema import LocalisationConfig as L2, PerceptionConfig as P2
    from acmpc_tpu_torch.mpc import solve_control_qp
    from acmpc_tpu_torch.mpc.control_qp import solve_control_qp as direct
    from acmpc_tpu_torch.utils import convert_radians_to_plus_minus_pi

    assert solve_control_qp is direct
    assert (LocalisationConfig, PerceptionConfig) == (L2, P2)
    angles = np.linspace(-7.0, 7.0, 29)
    np.testing.assert_allclose(
        convert_radians_to_plus_minus_pi(angles), np.asarray(j_convert(angles)), atol=1e-12
    )


def _monza(horizon=50):
    """(port MPC, JAX MPC) of monza's racing control at ``horizon``."""
    from acmpc_tpu.config import load_config as j_load_config
    from acmpc_tpu.dynamics import SpatialBicycleModel as JModel
    from acmpc_tpu.mpc.spatial_mpc import SpatialMPC as JMPC
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    path = ROOT / "configs" / "monza.yaml"
    cfg, jcfg = load_config(path), j_load_config(path)
    control = dataclasses.replace(cfg.racing_control, horizon=horizon)
    jcontrol = dataclasses.replace(jcfg.racing_control, horizon=horizon)
    ours = SpatialMPC(
        control,
        SpatialBicycleModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max),
        device="cpu",
    )
    ref = JMPC(jcontrol, JModel(jcfg.vehicle, jcontrol.constraints.v_min, jcontrol.constraints.v_max))
    return ours, ref


def test_delta_max_and_dtype():
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC, build_mpc
    from acmpc_tpu_torch.runtime.controller import Controller

    ours, ref = _monza()
    assert ours.delta_max == ours.model.delta_max
    assert ours.delta_max == pytest.approx(float(ref.delta_max))
    assert SpatialMPC(ours.config, ours.model, "cpu", torch.float32).dtype == torch.float32
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="float32"):
            SpatialMPC(ours.config, ours.model, "cpu", dtype)
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = {
        "horizon": 20, "step_cost": [1.0, 1.0, 0.0], "r_term": [1.0, 1.0],
        "final_cost": [1.0, 0.0, 0.1],
        "speed_profile_constraints": dataclasses.asdict(cfg.racing_control.constraints),
    }
    assert build_mpc(control, cfg.vehicle, "cpu", torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        build_mpc(control, cfg.vehicle, "cpu", torch.float16)
    controller = Controller(cfg, device="cpu", dtype=torch.float32)
    assert controller.delta_max == controller.racing_mpc.delta_max
    with pytest.raises(ValueError, match="float32"):
        Controller(cfg, device="cpu", dtype=torch.float64)


def test_track_segmenter_load_variables_method(tmp_path):
    from acmpc_tpu_torch.models.checkpoint import write_checkpoint
    from acmpc_tpu_torch.perception.segmentation import TrackSegmenter, load_variables

    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    write_checkpoint(tmp_path / "tiny.msgpack", tree)
    segmenter = TrackSegmenter.__new__(TrackSegmenter)  # the method reads no state
    got = segmenter.load_variables(tmp_path / "tiny.msgpack")
    np.testing.assert_array_equal(got["params"]["w"], load_variables(tmp_path / "tiny.msgpack")["params"]["w"])
    with pytest.raises(FileNotFoundError):
        segmenter.load_variables(tmp_path / "none.msgpack")


def test_solve_speed_profile_ignores_cfg_and_v0():
    from acmpc_tpu_torch.qp.admm import ADMMConfig
    from acmpc_tpu_torch.qp.speed_profile import SpeedProfileConstraints, solve_speed_profile

    cons = SpeedProfileConstraints(5.0, 30.0, -3.0, 6.0, 5.5, 0.005, 10.0)
    ds = torch.full((40,), 2.0)
    kappas = 0.02 * torch.sin(torch.linspace(0.0, 6.0, 40))
    plain = solve_speed_profile(ds, kappas, cons)
    given = solve_speed_profile(ds, kappas, cons, cfg=ADMMConfig(max_iter=1), v0=torch.ones(40))
    assert torch.equal(plain.velocities, given.velocities)


def _control_inputs(mpc, window, t2s, construct_waypoints, solve_speed_profile, as_array):
    """(path with its speed profile, spatial state) of ``window``, as
    ``SpatialMPC._prepare`` builds them before assembling the QP."""
    path = construct_waypoints(as_array(window))
    speed = solve_speed_profile(
        path.distances, path.kappas, mpc.config.constraints, v_max_runtime=28.0,
        localised=False, use_end_velocity=True,
    )
    path = dataclasses.replace(path, velocities=speed.velocities)
    temporal = as_array(np.array([0.0, 0.0, math.pi / 2], np.float32))
    return path, t2s(path.state(0), temporal)


def test_solve_control_qp_matches_jax():
    """The monza horizon-50 QP (n = 248, m = 398) of three battery
    windows, through both packages' solve_control_qp; then the three as
    one batch, each lane equal to its own solve."""
    from acmpc_tpu.dynamics.spatial_bicycle import t2s as j_t2s
    from acmpc_tpu.geometry.path import construct_waypoints as j_waypoints
    from acmpc_tpu.mpc.control_qp import solve_control_qp as j_solve
    from acmpc_tpu.qp.speed_profile import solve_speed_profile as j_speed
    from acmpc_tpu_torch.dynamics.spatial_bicycle import t2s
    from acmpc_tpu_torch.geometry.path import construct_waypoints
    from acmpc_tpu_torch.geometry.tracks import battery
    from acmpc_tpu_torch.mpc import solve_control_qp
    from acmpc_tpu_torch.qp.speed_profile import solve_speed_profile

    ours, ref = _monza()
    windows = battery(50)
    names = ("curve", "chicane", "hairpin_r60")
    costs = [ours.config.step_cost, ours.config.r_term, ours.config.final_cost]
    singles, inputs = [], []
    for name in names:
        window = windows[name].astype(np.float32)
        path, state = _control_inputs(
            ours, window, t2s, construct_waypoints, solve_speed_profile, torch.as_tensor
        )
        sol = solve_control_qp(path, state, ours.model, *costs, ours.admm)
        jpath, jstate = _control_inputs(
            ref, window, j_t2s, j_waypoints, j_speed, lambda a: jnp.asarray(a, jnp.float32)
        )
        jsol = j_solve(
            jpath, jstate, ref.model, *(jnp.asarray(c, jnp.float32) for c in costs), ref.admm
        )
        assert sol.x.shape == (248,) and sol.y.shape == (398,)
        assert int(sol.status) == int(jsol.status) == 1, name
        np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), err_msg=name, **X_TOL)
        singles.append(sol)
        inputs.append((path, state))
    stacked_path = type(inputs[0][0])(
        *(torch.stack([getattr(p, f.name) for p, _ in inputs]) for f in dataclasses.fields(inputs[0][0]))
    )
    batch = solve_control_qp(
        stacked_path, torch.stack([s for _, s in inputs]), ours.model, *costs, ours.admm
    )
    for i, sol in enumerate(singles):
        assert int(batch.iterations[i]) == int(sol.iterations)
        np.testing.assert_array_equal(batch.x[i].numpy(), sol.x.numpy())
