"""Name-level coverage of the JAX package by the port.

Every public top-level ``def`` and ``class`` of ``mega_pytorch_tpu/`` (read
with ``ast``, nothing imported) has a counterpart of the same name in
``mega_pytorch_tpu_torch/`` (a definition or module-level name anywhere in
it), or stands in ``RENAMED`` with the port's name for it, or in
``JAX_ONLY`` with the reason it has none. Every root ``tools/*.py`` file
has a file of the same name in ``mega_pytorch_tpu_torch/tools/``, or stands
in ``TOOLS_RENAMED`` or ``TOOLS_WAITING``. The maps hold no stale entry.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PACKAGE, PORT = ROOT / "mega_pytorch_tpu", ROOT / "mega_pytorch_tpu_torch"

# (JAX module, name) -> the port's name for it
RENAMED = {
    ("engine/trainer.py", "make_train_step"): "train_step",
    ("models/backbone/flownet.py", "build_flownet"): "FlowNetS",
    ("models/backbone/flownet.py", "build_embednet"): "EmbedNet",
    ("models/detectors/rcnn.py", "make_empty_gt"): "pad_gt",
    ("models/roi_heads/attention.py", "extract_position_matrix"): "_log_ratios",
    ("models/roi_heads/attention.py", "extract_position_embedding"): "position_embedding",
    ("ops/pallas/relation_attention.py", "fused_relation_attention"): "flash_relation_attention",
    ("ops/pallas/relation_attention.py", "fused_relation_attention_pos"):
        "flash_relation_attention_pos",
    # the mesh's data axis is torchrun's ranks under DistributedDataParallel
    ("parallel/mesh.py", "make_mesh"): "init_distributed",
    ("parallel/mesh.py", "batch_sharding"): "samples_per_rank",
    ("parallel/mesh.py", "shard_batch"): "rank_share",
    ("parallel/mesh.py", "replicate"): "wrap",
    ("parallel/mesh.py", "replicated"): "wrap",
    ("parallel/mesh.py", "make_train_step"): "train_step",  # on the wrapped model
    ("solver/build.py", "warmup_multistep_schedule"): "warmup_multistep_factor",
    ("utils/logger.py", "Timer"): "MetricLogger",
    ("utils/model_ingest.py", "merge_params"): "merge_state_dict",
    ("utils/torch_ingest.py", "default_name_rule"): "translate_name",
    ("utils/torch_ingest.py", "ingest_state_dict"): "convert_reference_state_dict",
}
_JIT = "PyTorch runs eagerly and compiles no program ahead, so there is nothing to cache"
JAX_ONLY = {
    ("structures/image_list.py", "ImageBatch"):
        "the port passes (frames, sizes) tensor pairs, a (L, H, W, C) batch and its (L, 2) sizes",
    ("structures/image_list.py", "to_image_batch"): "as ImageBatch: (frames, sizes) pairs",
    ("utils/registry.py", "Registry"): "the port looks builders up in plain dicts",
    ("utils/misc.py", "honor_jax_platforms_env"):
        "JAX's platform selection; the port's entry points take --device",
    ("utils/misc.py", "host_cache_namespace"): _JIT,
    ("utils/misc.py", "setup_compilation_cache"): _JIT,
    ("utils/misc.py", "jit_init"):
        "flax makes parameters by tracing an init; a port module holds them from construction",
    ("utils/model_ingest.py", "init_inference_params"):
        "flax makes parameters by tracing an init; RCNNBase.init_weights draws the port's",
}
TOOLS_RENAMED = {
    # the kernels' check on the card at the flagship's shapes
    "verify_kernels.py": "chip_smoke.py",
    # kernel variants compared on the card (the Pallas tool picks TPU tiles)
    "bench_kernel_tiles.py": "mega_pytorch_tpu_torch/tools/kernel_ab.py",
}
# benchmarks of the JAX package on the TPU: the port's benchmark PR brings theirs
TOOLS_WAITING = {"bench_eval_path.py", "bench_host_feed.py", "bench_methods.py"}


def _public_names(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


def _port_names() -> set[str]:
    names = set()
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
        for node in tree.body:
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, ast.AnnAssign) else [])
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


MODULES = sorted(str(p.relative_to(JAX_PACKAGE)) for p in JAX_PACKAGE.rglob("*.py")
                 if _public_names(p))
TOOLS = sorted(p.name for p in (ROOT / "tools").glob("*.py"))
PORT_NAMES = _port_names()


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_port_counterparts(module):
    missing = [name for name in _public_names(JAX_PACKAGE / module)
               if name not in PORT_NAMES and (module, name) not in RENAMED
               and (module, name) not in JAX_ONLY]
    assert not missing, f"{module}: no port counterpart and no written map entry for {missing}"


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_have_port_counterparts(tool):
    if tool in TOOLS_RENAMED:
        assert (ROOT / TOOLS_RENAMED[tool]).is_file()
    else:
        assert tool in TOOLS_WAITING or (PORT / "tools" / tool).is_file(), tool


def test_maps_hold_no_stale_entry():
    for (module, name), port_name in RENAMED.items():
        assert name in _public_names(JAX_PACKAGE / module), (module, name)
        assert name not in PORT_NAMES and port_name in PORT_NAMES, (module, name, port_name)
    for (module, name), reason in JAX_ONLY.items():
        assert name in _public_names(JAX_PACKAGE / module) and name not in PORT_NAMES
        assert reason
    mapped = set(TOOLS_RENAMED) | TOOLS_WAITING
    assert mapped <= set(TOOLS)
    assert not mapped & {p.name for p in (PORT / "tools").glob("*.py")}
