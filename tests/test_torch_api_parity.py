"""The port's public API covers the JAX package's: for every public function, class and
method of each ``tpuhar/`` module, the ``tpuhar_torch/`` module at the same path has a
counterpart of that name that takes every parameter name of it.

The sources are read with ``ast`` only: neither package is imported. A name the port
module imports from another module of the port (``ops/quant.py``'s ``int8_conv`` from
``ops/conv3x3.py``) or binds to another of its names (``make_classification_steps =
classification_step_fns``) counts, with the signature of what it names. Dunder methods
are left out (flax's ``__call__`` is the port's ``forward``).

What the port does otherwise is listed below, each entry with its reason: the port's
idioms (``ROADMAP.md`` §1) and what it does not port (its "Not ported" list).
"""
import ast
from pathlib import Path


ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "tpuhar", ROOT / "tpuhar_torch"

# A JAX parameter name, and the port's name for it. Each applies wherever the JAX name
# occurs and the port takes its counterpart.
IDIOMS = {
    "rng": ("generator", "a JAX PRNG key becomes a torch.Generator"),
    "key": ("generator", "a JAX PRNG key becomes a torch.Generator"),
    "params": ("model", "a parameter tree becomes an nn.Module, which holds its parameters"),
    "axis": ("dim", "torch's name for an array axis"),
}

_SETUP = "flax builds submodules in setup(); an nn.Module builds them in __init__"
_EXAMPLES = "flax needs example inputs to infer shapes at init; an nn.Module is built from the configuration"
_BATCH = "flax's init takes the batch size for its example inputs; an nn.Module needs none"
_TREE_RNG = ("a parameter tree becomes an nn.Module: the port's builders take weights drawn beforehand "
             "(bridge.init_params(config, generator)) where flax draws them from rng")
_DEVICES = ("JAX device lists and NamedShardings: the port's mesh is the torch.distributed group, one device "
            "a rank, and its batches are split by rank (parallel/mesh.shard_batch)")
_STEP_MODEL = ("the flax module the JAX steps apply beside the state's parameters: the port's steps call "
               "the nn.Module that their TrainState holds")
_TRAIN_STATE = ("flax's TrainState is built and stepped through optax; the port's TrainState holds the "
                "nn.Module and its AdamW, built by train/factory and stepped by its optimizer")

# (module path under tpuhar/, qualified name) -> (JAX parameters the port does not take,
# or None where the name itself is not ported; the reason)
ALLOWED = {
    ("models/crossmodal.py", "CrossModalModel.setup"): (None, _SETUP),
    ("models/crossmodal.py", "IMUClassifier.setup"): (None, _SETUP),
    ("models/crossmodal.py", "VideoClassifier.setup"): (None, _SETUP),
    ("models/crossmodal.py", "FusionClassifier.setup"): (None, _SETUP),
    ("models/layers.py", "norm_layer"): (
        {"name"}, "a flax submodule's name is an argument; an nn.Module's is the attribute it is assigned to"),
    ("ops/attention.py", "flash_mha"): (
        None, "Not ported: flash_mha's kernel and use_flash branches and block sizes; one Hopper kernel with "
              "fixed tiles replaces both branches, and attention without flash is MultiHeadDotProductAttention"),
    ("ops/flash_lean.py", "flash_lean"): (
        {"block_q", "block_k", "interpret"}, "Not ported: Pallas block and interpret options"),
    ("ops/fused_window.py", "featurize_windows_pallas"): (
        None, "Not ported: the Pallas kernel itself; its Hopper kernel's wrapper is featurize_windows_auto"),
    ("ops/conv3x3.py", "conv3x3_bn_act"): (
        {"block_m", "im2col", "interpret", "force_pallas"}, "Not ported: Pallas and MXU options"),
    ("ops/stem.py", "stem_gemm_u8"): (
        {"sub", "clip_lo", "out_dtype", "mxu_dtype"},
        "Not ported: Pallas and MXU options; no caller sets them apart from their int8 defaults"),
    ("ops/stem.py", "stem_gemm_u8_pallas"): (
        None, "Not ported: the Pallas kernel itself; its Hopper kernel's wrapper is stem_gemm_u8"),
    ("ops/stem.py", "stem_gemm_reference"): (
        None, "Not ported: the jnp reference of the Pallas kernel; the Hopper kernel's is stem_gemm_u8_reference"),
    ("ops/stem.py", "to_patch_major_jnp"): (
        None, "Not ported: the on-TPU shuffle; the port's device form is to_patch_major_tensor"),
    ("ops/quant.py", "int8_conv"): (
        {"strides"}, "torch's conv idiom: one int stride (the towers' strides are square) for XLA's strides pair"),
    ("parallel/mesh.py", "create_mesh"): ({"devices"}, _DEVICES),
    ("parallel/mesh.py", "maybe_mesh"): ({"devices"}, _DEVICES),
    ("parallel/mesh.py", "batch_sharding"): (None, _DEVICES),
    ("parallel/mesh.py", "replicated"): (None, _DEVICES),
    ("parallel/mesh.py", "shard_state"): (
        {"model_axis"}, _DEVICES + "; the model axis is the mesh's own (mesh.model_axis)"),
    ("train/steps.py", "TrainState.create"): (None, _TRAIN_STATE),
    ("train/steps.py", "TrainState.apply_gradients"): (None, _TRAIN_STATE),
    ("train/steps.py", "init_state"): (None, _TRAIN_STATE),
    ("train/steps.py", "make_crossmodal_steps"): ({"model"}, _STEP_MODEL),
    ("train/steps.py", "classification_step_fns"): ({"model"}, _STEP_MODEL),
    ("train/steps.py", "make_classification_steps"): (
        {"model", "num_classes"}, _STEP_MODEL + "; num_classes: the JAX function never reads it "
                                  "(tpuhar/train/steps.py:179-190): it jits the steps of "
                                  "classification_step_fns, to which the port binds the name"),
    ("train/steps.py", "make_video_steps"): ({"model"}, _STEP_MODEL),
    ("train/steps.py", "make_fusion_steps"): ({"model"}, _STEP_MODEL),
    ("train/factory.py", "example_imu"): (None, _EXAMPLES),
    ("train/factory.py", "example_video"): (None, _EXAMPLES),
    ("train/factory.py", "build_crossmodal_task"): ({"rng"}, _TREE_RNG),
    ("train/factory.py", "build_classification_task"): ({"rng", "batch_size"}, _TREE_RNG + "; " + _BATCH),
    ("train/factory.py", "build_video_task"): ({"rng", "batch_size"}, _TREE_RNG + "; " + _BATCH),
    ("train/factory.py", "build_fusion_task"): ({"rng", "batch_size"}, _TREE_RNG + "; " + _BATCH),
}


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _definitions(path: Path) -> tuple:
    """``({qualified name: parameter names, or None for a class}, {name: (module path,
    name)} of the names imported from sibling modules, {alias: name} bound by
    assignment)`` of the module at ``path``."""
    tree = ast.parse(path.read_text())
    defs, imports, aliases = {}, {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            defs[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(sub.name):
                    defs[f"{node.name}.{sub.name}"] = _params(sub)
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            base = path.parent
            for _ in range(node.level - 1):
                base = base.parent
            target = base.joinpath(*(node.module or "").split(".")).with_suffix(".py")
            for alias in node.names:
                imports[alias.asname or alias.name] = (target, alias.name)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases[t.id] = node.value.id
    return defs, imports, aliases


def _lookup(path: Path, name: str, depth: int = 0):
    """The parameter names of ``name`` in the module at ``path`` (None for a class),
    through the module's imports and aliases; ``KeyError`` where it has none."""
    defs, imports, aliases = _definitions(path)
    if name in defs:
        return defs[name]
    head, _, rest = name.partition(".")
    if depth < 4:
        if head in aliases:
            return _lookup(path, ".".join(filter(None, (aliases[head], rest))), depth + 1)
        if head in imports and imports[head][0].exists():
            target, original = imports[head]
            return _lookup(target, ".".join(filter(None, (original, rest))), depth + 1)
    raise KeyError(name)


def api_gaps(jax_root: Path = JAX, port_root: Path = PORT) -> list:
    """Every public JAX name or parameter that the port lacks and ``ALLOWED`` does not
    list, as ``"module: name"`` or ``"module: name(parameter)"``."""
    gaps = []
    for jax_path in sorted(jax_root.rglob("*.py")):
        rel = str(jax_path.relative_to(jax_root))
        port_path = port_root / rel
        if not port_path.exists():
            gaps.append(f"{rel}: no module")
            continue
        defs, _, _ = _definitions(jax_path)
        for name, params in defs.items():
            if not all(_public(part) for part in name.split(".")):
                continue
            missing, _ = ALLOWED.get((rel, name), (set(), ""))
            try:
                port_params = _lookup(port_path, name)
            except KeyError:
                if missing is not None:
                    gaps.append(f"{rel}: {name}")
                continue
            if params is None:
                continue
            for p in params:
                if p in port_params or p in (missing or ()):
                    continue
                if p in IDIOMS and IDIOMS[p][0] in port_params:
                    continue
                gaps.append(f"{rel}: {name}({p})")
    return gaps


def test_port_covers_every_public_name_and_parameter():
    assert api_gaps() == []


def test_allowlist_entries_are_still_needed():
    """Each entry names a JAX function or method that exists and still differs in the
    port as the entry says: an entry the port has caught up with must go."""
    for (rel, name), (missing, reason) in ALLOWED.items():
        assert reason, (rel, name)
        defs, _, _ = _definitions(JAX / rel)
        assert name in defs, (rel, name)
        try:
            port_params = _lookup(PORT / rel, name)
        except KeyError:
            assert missing is None, (rel, name, "the name is missing, not only its parameters")
            continue
        assert missing is not None, (rel, name, "the port has the name now")
        assert set(defs[name]) >= missing and not (missing & set(port_params)), (rel, name)
