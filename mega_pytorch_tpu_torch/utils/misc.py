"""Small helpers of the entry points (counterpart of
``mega_pytorch_tpu/utils/misc.py``): directories, the label map and the
config written beside a run, the environment lines of a startup log, a
Python file loaded as a module, and weight URIs resolved to local files.

There is no network: ``catalog://`` names resolve to files under
``MODEL_DIR`` that the user placed there, and an ``http(s)`` URI is
refused. The JAX module's compilation-cache, ``jit_init`` and JAX-platform
helpers have no counterpart (PyTorch compiles nothing ahead), nor has its
``init_distributed`` (``parallel/ddp.py:init_distributed`` starts the
process group here).
"""

from __future__ import annotations

import importlib.util
import json
import os
import platform

import torch

from . import comm


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def save_labels(label_list, output_dir: str) -> None:
    """``labels.json``: {class index: name} (the reference's
    ``miscellaneous.save_labels``)."""
    mkdir(output_dir)
    with open(os.path.join(output_dir, "labels.json"), "w") as f:
        json.dump(dict(enumerate(label_list)), f, indent=2)


def save_config(cfg, path: str) -> None:
    """The config's YAML dump at ``path``, its directory made first."""
    mkdir(os.path.dirname(path) or ".")
    with open(path, "w") as f:
        f.write(cfg.dump())


def collect_env_info() -> str:
    """The environment lines of a startup log: Python, torch and the CUDA
    it was built for, each visible card's name, and this process's rank in
    the world."""
    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    return "\n".join([
        f"python: {platform.python_version()}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda or 'none'})",
        f"cards: {cards or 'none'}",
        f"process: {comm.get_rank()}/{comm.get_world_size()}",
    ])


def import_file(module_name: str, file_path: str):
    """Run a Python file as the module ``module_name`` (a user's own
    dataset catalog, say) and return it."""
    spec = importlib.util.spec_from_file_location(module_name, file_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MODEL_DIR = os.environ.get("MEGA_TPU_MODEL_DIR", "models")

# catalog:// name → its file under MODEL_DIR (the reference's ModelCatalog
# maps these to URLs; with no network the user downloads them beforehand)
MODEL_CATALOG = {
    "ImageNetPretrained/MSRA/R-50": "R-50.pkl",
    "ImageNetPretrained/MSRA/R-101": "R-101.pkl",
    "ImageNetPretrained/MSRA/R-152": "R-152.pkl",
}


def resolve_weight(uri: str) -> str:
    """``catalog://X`` → its local path; an ``http(s)`` URI raises; any
    other string is a path and comes back as it is."""
    if uri.startswith("catalog://"):
        name = uri[len("catalog://"):]
        if name not in MODEL_CATALOG:
            raise KeyError(f"unknown catalog entry {name}")
        return os.path.join(MODEL_DIR, MODEL_CATALOG[name])
    if uri.startswith("http"):
        raise RuntimeError(f"no network to fetch {uri}: place the file under {MODEL_DIR}/ "
                           f"and point MODEL.WEIGHT at it")
    return uri
