"""The port's public surface against the JAX package's, name by name.

For every module of `spfsplatv2_tpu/`, every public top-level name (a
function, a class or a constant) and every public method or property of
a public class must exist in the port's module of the same path.  Read
with `ast` only: nothing is imported, so no JAX.  `ALLOWED` is the only
exception; each entry names the port's counterpart (which must exist) or
says why there is none.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "spfsplatv2_tpu"
PORT_PKG = ROOT / "spfsplatv2_tpu_torch"

# JAX module -> the port's module that takes its place.
MODULE_COUNTERPARTS = {
    "ops/raster_pallas.py": "ops/raster_cuda.py",
}

# "module:name" -> (the port's "module:name" counterpart or None, reason).
ALLOWED = {
    "geometry/se3.py:pose_auc": (
        "evaluation/metrics.py:pose_auc",
        "host-side numpy metric, kept beside its caller"),
    "losses/lpips.py:get_lpips_params": (
        "losses/lpips.py:get_lpips",
        "returns the torch module, not a flax parameter tree"),
    "losses/lpips.py:init_lpips_params": (
        "losses/lpips.py:build_lpips", "the seeded init of the torch module"),
    "losses/lpips.py:load_torch_lpips_weights": (
        "losses/lpips.py:from_lpips_state_dict",
        "the lpips state dict needs renaming only, not a flax conversion"),
    "models/croco/backbone_multi.py:CrocoMultiBackbone.setup": (
        None, "flax declares submodules in setup; torch in __init__"),
    "ops/raster_pallas.py:FEAT": (
        None, "the Pallas kernel's lane padding of its attribute rows; the "
              "CUDA kernels read rows of NUM_FIELDS floats"),
    "ops/raster_pallas.py:composite_pallas_prefix": (
        "ops/raster_cuda.py:composite_prefix",
        "K1 and K2 by hand for the H100 in place of the Pallas kernels"),
    "parallel/mesh.py:audit_collectives": (
        "parallel/mesh.py:CollectiveAudit",
        "counts DDP's all-reduces where JAX reads the compiled HLO"),
    "parallel/mesh.py:replicated": (
        None, "an XLA NamedSharding; the port's `replicate` broadcasts the "
              "parameters instead"),
    "training/optim.py:SkipState": (
        "training/optim.py:Optimizer",
        "the skip counters are the optimizer's attributes"),
    "training/optim.py:skip_bad_gradients": (
        "training/optim.py:Optimizer",
        "Optimizer.step skips a NaN or too large gradient"),
    "training/optim.py:make_optimizer": (
        "training/optim.py:Optimizer",
        "an optax chain in JAX, one torch optimizer in the port"),
    "training/step.py:peak_hbm_gb": (
        "training/loop.py:probe_peak_gb",
        "XLA's compiled memory analysis; the port measures a probe step"),
    "training/step.py:device_hbm_budget_gb": (
        "training/loop.py:device_memory_gb", "the card's memory"),
    "utils/profiling.py:StepTimer": (
        None, "nothing reads a rolling step mean; the benchmark's window "
              "and the program's spans replace it"),
    "utils/profiling.py:StepTimer.tick": (None, "as above"),
    "utils/profiling.py:StepTimer.mean": (None, "as above"),
    "utils/profiling.py:StepTimer.steps_per_s": (None, "as above"),
    "utils/ckpt_convert.py:convert_croco_block": (
        "utils/ckpt_convert.py:_croco_block",
        "converts to a torch state dict by name, not a flax tree"),
    "utils/ckpt_convert.py:convert_dpt_head": (
        "utils/ckpt_convert.py:_dpt_head", "as above"),
    "utils/ckpt_convert.py:convert_pose_head": (
        "utils/ckpt_convert.py:convert_spfsplat_checkpoint",
        "the pose heads' keys are renamed there"),
    "utils/ckpt_convert_vggt.py:convert_camera_head": (
        "utils/ckpt_convert_vggt.py:_camera_head", "as above"),
    "utils/ckpt_convert_vggt.py:convert_dinov2": (
        "utils/ckpt_convert_vggt.py:_dinov2", "as above"),
    "utils/ckpt_convert_vggt.py:convert_vggt_dpt_head": (
        "utils/ckpt_convert_vggt.py:_dpt_head", "as above"),
}


def defined_names(path: Path, public: bool = True) -> set[str]:
    """Top-level functions, classes and assigned names of a module, and
    `Class.method` for each method or property of its classes."""
    ok = (lambda n: not n.startswith("_")) if public else (lambda n: True)
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and ok(node.name):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not sub.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and ok(n.id):
                        names.add(n.id)
    return names


def jax_modules() -> list[str]:
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py"))


def port_path(module: str) -> Path:
    return PORT_PKG / MODULE_COUNTERPARTS.get(module, module)


@pytest.mark.parametrize("module", jax_modules())
def test_port_has_every_public_name(module):
    port = port_path(module)
    assert port.exists(), f"no port of {module}"
    missing = sorted(
        name for name in defined_names(JAX_PKG / module)
        - defined_names(port) if f"{module}:{name}" not in ALLOWED)
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_allow_list_entries_are_live_and_name_real_counterparts():
    modules = set(jax_modules())
    for key, (counterpart, reason) in ALLOWED.items():
        module, name = key.split(":")
        assert module in modules and reason, key
        assert name in defined_names(JAX_PKG / module), f"{key}: stale"
        assert name not in defined_names(port_path(module)), (
            f"{key}: the port has it now, drop the entry")
        if counterpart is not None:
            path, target = counterpart.split(":")
            assert target in defined_names(PORT_PKG / path, public=False), (
                f"{key}: counterpart {counterpart} missing")
