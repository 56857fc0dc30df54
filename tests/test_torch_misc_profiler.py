"""The port's ``utils/misc.py`` and ``utils/profiler.py`` against the JAX
package's (``tests/test_ops_zoo.py::test_misc_utils`` as the model): the
same label map, config dump, catalog resolution and imported module; an
``http`` URI refused; the environment lines; zero device memory on the CPU
and a Chrome trace written by ``trace``."""

import json

import pytest
import torch

from mega_pytorch_tpu.config import get_default_cfg as jax_default_cfg
from mega_pytorch_tpu.utils import misc as jax_misc
from mega_pytorch_tpu_torch.config import get_default_cfg
from mega_pytorch_tpu_torch.utils import misc, profiler

LABELS = ["__background__", "airplane", "antelope", "bear"]


def test_save_labels_equals_jax(tmp_path):
    misc.save_labels(LABELS, str(tmp_path / "port"))
    jax_misc.save_labels(LABELS, str(tmp_path / "jax"))
    got = (tmp_path / "port" / "labels.json").read_text()
    assert got == (tmp_path / "jax" / "labels.json").read_text()
    assert json.loads(got)["1"] == "airplane"


def test_save_config_equals_jax(tmp_path):
    misc.save_config(get_default_cfg(), str(tmp_path / "a" / "config.yml"))
    jax_misc.save_config(jax_default_cfg(), str(tmp_path / "b" / "config.yml"))
    got = (tmp_path / "a" / "config.yml").read_text()
    assert got == (tmp_path / "b" / "config.yml").read_text()
    assert got.startswith("AMP_VERBOSE")


@pytest.mark.parametrize("uri", ["catalog://ImageNetPretrained/MSRA/R-50",
                                 "catalog://ImageNetPretrained/MSRA/R-101",
                                 "catalog://ImageNetPretrained/MSRA/R-152",
                                 "/abs/path.pth", "models/mega_R_101.pth"])
def test_resolve_weight_equals_jax(uri):
    assert misc.resolve_weight(uri) == jax_misc.resolve_weight(uri)
    assert misc.MODEL_CATALOG == jax_misc.MODEL_CATALOG
    assert misc.MODEL_DIR == jax_misc.MODEL_DIR


@pytest.mark.parametrize("uri,error", [("https://example.com/w.pth", RuntimeError),
                                       ("http://example.com/w.pkl", RuntimeError),
                                       ("catalog://ImageNetPretrained/MSRA/X-152", KeyError)])
def test_resolve_weight_refuses(uri, error):
    with pytest.raises(error):
        misc.resolve_weight(uri)
    with pytest.raises(error):
        jax_misc.resolve_weight(uri)


def test_import_file_equals_jax(tmp_path):
    path = tmp_path / "catalog.py"
    path.write_text("DATA_DIR = 'datasets'\nDATASETS = {'VID_val': {'img_dir': 'x'}}\n")
    got = misc.import_file("user_catalog", str(path))
    want = jax_misc.import_file("user_catalog", str(path))
    assert (got.DATA_DIR, got.DATASETS) == (want.DATA_DIR, want.DATASETS)
    misc.mkdir(str(tmp_path / "x" / "y"))
    misc.mkdir(str(tmp_path / "x" / "y"))
    assert (tmp_path / "x" / "y").is_dir()


def test_collect_env_info():
    lines = misc.collect_env_info().splitlines()
    assert [line.split(":")[0] for line in lines] == ["python", "torch", "cards", "process"]
    assert torch.__version__ in lines[1]
    assert lines[2] == "cards: none" and lines[3] == "process: 0/1"


def test_profiler_on_the_cpu(tmp_path):
    assert profiler.device_memory_stats() == {"bytes_in_use": 0, "peak_bytes_in_use": 0}
    with profiler.trace(str(tmp_path / "trace")):
        with profiler.annotate("matmul"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)
