"""The port's serial engine (``StreamingInferencer`` through
``compute_on_dataset`` with one lane) against the JAX package's serial
engine, for base, mega, rdn, fgfa and dff on ``tiny_root`` with bridged
weights, each side reading its own package's dataset and preprocessor;
the port's serial engine against its own lockstep engine at two lanes; and
``evaluate_predictions`` on both packages.

Tolerances: against JAX, every frame has the same number of boxes and, in
score order, the same labels, scores within 1e-3 and boxes within 0.2 px
(original image coordinates), as the lockstep parity suite. Serial against
lockstep, test_engine.py's: scores 1e-3 for MEGA and 3e-3 for the others
(RDN's multi-stage attention amplifies the drift of batch-dependent CPU
rounding), boxes 0.2, labels equal. The methods whose JAX serial-vs-lockstep
twins are slow (rdn, fgfa, dff) are slow here too."""

import jax
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.datasets.vid import VIDDataset, VIDMEGADataset
from mega_pytorch_tpu.data.loader import EvalPreprocessor as JaxEvalPreprocessor
from mega_pytorch_tpu.engine.inference import compute_on_dataset as jax_compute_on_dataset
from mega_pytorch_tpu.engine.inference import evaluate_predictions as jax_evaluate_predictions
from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN as JaxRCNN
from mega_pytorch_tpu.utils.model_ingest import init_inference_params
from mega_pytorch_tpu_torch.data.loader import EvalPreprocessor
from mega_pytorch_tpu_torch.engine.inference import compute_on_dataset, evaluate_predictions
from mega_pytorch_tpu_torch.models import detectors
from test_engine import TINY_C as ENGINE_C
from test_engine import _dataset, _prep_kwargs
from test_torch_lockstep import _assert_predictions_match, _engine_setup, _method_setup
from torch_port_harness import (
    _perturb,
    off_relu_corner,
    port_configs,
    port_dataset,
    port_model_from,
    to_np,
)

torch.set_num_threads(2)

_PORT = {"base": "GeneralizedRCNN", "mega": "GeneralizedRCNNMEGA",
         "rdn": "GeneralizedRCNNRDN", "fgfa": "GeneralizedRCNNFGFA",
         "dff": "GeneralizedRCNNDFF"}
_DATASET = {"base": ("VIDDataset", {}),
            "mega": ("VIDMEGADataset", dict(max_offset=1, all_frame_interval=3,
                                            global_size=2, global_seed=0)),
            "rdn": ("VIDRDNDataset", dict(max_offset=1)),
            "fgfa": ("VIDFGFADataset", dict(max_offset=1)),
            "dff": ("VIDDFFDataset", dict(key_interval=2))}
_RUNS: dict = {}


def _run(method, tiny_root):
    """(port model, port dataset, port preprocessor, JAX dataset, JAX serial
    predictions, port serial predictions) of one method, computed once."""
    if method in _RUNS:
        return _RUNS[method]
    jax_prep = JaxEvalPreprocessor(**_prep_kwargs())
    if method in ("rdn", "fgfa", "dff"):
        model, jax_ds, params = _method_setup(method, tiny_root)
    else:
        if method == "mega":
            model, _ = _engine_setup()
            jax_ds = _dataset(tiny_root, VIDMEGADataset, is_train=False,
                              **_DATASET["mega"][1])
        else:
            model = JaxRCNN(c=ENGINE_C)
            jax_ds = _dataset(tiny_root, VIDDataset, is_train=False)
        params = init_inference_params(model, method, jax_prep, jax_ds)
        params = off_relu_corner(_perturb(to_np(params), np.random.RandomState(1)))
    indices = list(range(len(jax_ds)))
    want = jax_compute_on_dataset(model, params, jax_ds, indices, jax_prep, method)
    args = port_configs(ENGINE_C, model.v) if method != "base" else port_configs(ENGINE_C)[:1]
    port = port_model_from(getattr(detectors, _PORT[method]), params, *args)
    cls_name, kw = _DATASET[method]
    ds = port_dataset(tiny_root, cls_name, **kw)
    prep = EvalPreprocessor(**_prep_kwargs())
    got = compute_on_dataset(port, ds, indices, prep, method)
    _RUNS[method] = (port, ds, prep, jax_ds, want, got)
    return _RUNS[method]


@pytest.mark.parametrize("method", ["base", "mega", "rdn", "fgfa", "dff"])
def test_serial_engine_matches_jax(tiny_root, method):
    _, _, _, _, want, got = _run(method, tiny_root)
    _assert_predictions_match(got, want, list(range(10)))


def _compare_serial_lockstep(serial, lockstep, atol):
    assert sorted(serial) == sorted(lockstep) == list(range(10))
    n_boxes = 0
    for i in serial:
        s, l = serial[i], lockstep[i]
        assert len(s["boxes"]) == len(l["boxes"]), i
        n_boxes += len(s["boxes"])
        so, lo = np.argsort(-s["scores"], kind="stable"), np.argsort(-l["scores"], kind="stable")
        np.testing.assert_allclose(s["scores"][so], l["scores"][lo], rtol=0, atol=atol,
                                   err_msg=str(i))
        np.testing.assert_allclose(s["boxes"][so], l["boxes"][lo], rtol=0, atol=0.2,
                                   err_msg=str(i))
        np.testing.assert_array_equal(s["labels"][so], l["labels"][lo], err_msg=str(i))
    assert n_boxes > 0


@pytest.mark.parametrize("method", [
    "mega",
    pytest.param("rdn", marks=pytest.mark.slow),
    pytest.param("fgfa", marks=pytest.mark.slow),
    pytest.param("dff", marks=pytest.mark.slow),
])
def test_serial_engine_matches_lockstep(tiny_root, method):
    """MEGA's serial protocol applies the video's initial globals before its
    first detect; the lockstep engine spreads them over the warm-up. The
    detections agree all the same."""
    port, ds, prep, _, _, serial = _run(method, tiny_root)
    lockstep = compute_on_dataset(port, ds, list(range(len(ds))), prep, method, lanes=2)
    _compare_serial_lockstep(serial, lockstep, 1e-3 if method == "mega" else 3e-3)


def test_evaluate_predictions_equal_jax(tiny_root):
    """AP50 of the port's and of JAX's predictions, scored by either
    package's evaluation over its own dataset, to 1e-12."""
    _, ds, _, jax_ds, want, got = _run("mega", tiny_root)
    for preds in (want, got):
        a = evaluate_predictions(ds, preds)
        b = jax_evaluate_predictions(jax_ds, preds)
        assert a.keys() == b.keys() == {"all"}
        np.testing.assert_allclose(a["all"]["ap"], b["all"]["ap"], rtol=0, atol=1e-12)
        assert np.isfinite(a["all"]["map"])


def test_compute_on_dataset_dispatch(tiny_root):
    """Several lanes of the base method still take the serial engine; a
    method that is not the model's is refused."""
    port, ds, prep, _, _, serial = _run("base", tiny_root)
    again = compute_on_dataset(port, ds, list(range(len(ds))), prep, "base", lanes=4)
    assert sorted(again) == sorted(serial)
    for i in serial:
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(again[i][k], serial[i][k])
    with pytest.raises(ValueError, match="model is 'base'"):
        compute_on_dataset(port, ds, [0], prep, "mega")
    assert jax.devices()[0].platform == "cpu"
