"""Carry parameters from the JAX package into the port.

``params_from_jax`` turns a JAX model's flat ``{name: array}`` params (as
numpy arrays, e.g. ``{k: np.asarray(v) for k, v in jax_model.params.items()}``)
into tensors under the same names; ``BasePipeline.load_params`` installs
them.  With it both packages compute the same function, which is how the
parity tests compare them.  Whole models travel through the shared npz
format instead (``save_model`` / ``load_model_path``).
"""
from typing import Dict, Union

import numpy as np
import torch


def params_from_jax(params: Dict[str, np.ndarray],
                    device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``,
    copied.  bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16, which torch
    cannot wrap) go through float32, which holds them exactly."""
    out = {}
    for name, value in params.items():
        value = np.asarray(value)
        if value.dtype.name == 'bfloat16':
            tensor = torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
        else:
            tensor = torch.from_numpy(np.array(value))
        out[name] = tensor.to(device)
    return out
