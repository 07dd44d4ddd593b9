"""Parameter conversion from the JAX package's pytree.

``params_from_jax`` takes the reference's parameter pytree with every leaf
already a numpy array (``jax.device_get(params)``) and returns the port's
parameter dict with the same structure and layouts (``decoder.param_shapes``:
q/k stay ``[L, out, in]``). It is how the tests make both packages compute
the same function; it imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from llmss_tpu_torch.ops.layers import LinearParams, NormParams


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params):
    """Convert a numpy-leaf copy of the reference's params to CPU tensors."""
    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields == ("w", "b"):
            return LinearParams(*(walk(x) for x in node))
        if fields == ("scale", "bias"):
            return NormParams(*(walk(x) for x in node))
        return _tensor(node)

    return walk(np_params)
