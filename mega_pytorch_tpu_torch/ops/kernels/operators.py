"""The kernels' entries as PyTorch operators, each with a count of its work.

Each hand-written kernel whose function computes a product (relation
attention modes "none", "compute" and "input"; ``fused_position_bias``) is
the operator ``torch.ops.mega_pytorch_tpu_torch.<name>``: one Python
implementation for CPU and CUDA tensors (the plain version on the CPU, the
kernel on the card) and a FLOP formula registered with
``torch.utils.flop_counter.register_flop_formula``. Under ``FlopCounterMode``
an entry then counts its formula, twice the multiply-adds of the products
the function defines, and not the aten work of the plain version beneath
it, so a step counts the same FLOPs on the CPU and on the card. The stem
pool computes no product (an affine, relu, maxima) and stays a plain
function: it counts 0 either way.

``SPECIAL_FUNCTIONS`` maps each operator to its count of sines and
cosines, exponentials and logarithms, which the FLOPs leave out.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "mega_pytorch_tpu_torch"
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")
# operator (overload packet) -> count(*argument shapes) -> {"sin_cos", "exp", "log"}
SPECIAL_FUNCTIONS: dict = {}


def kernel_op(name: str, schema: str, impl: Callable, flops: Callable, special: Callable):
    """Define ``torch.ops.mega_pytorch_tpu_torch.<name>`` with ``schema``,
    ``impl`` for CPU and CUDA tensors, ``flops(*argument shapes)`` as its
    FLOP formula and ``special(*argument shapes)`` as its special-function
    count; returns the operator."""
    _LIBRARY.define(name + schema)
    for key in ("CPU", "CUDA"):
        _LIBRARY.impl(name, impl, key)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(op)(lambda *shapes, out_shape=None, **_: flops(*shapes))
    SPECIAL_FUNCTIONS[op] = special
    return op
