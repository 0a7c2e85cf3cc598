"""Weight conversion: reference parameters → the port's `Params`, and
reference AdamW states → the port's optimizer state.

`repro.models.transformer.init` returns nested dicts of arrays; the port's
`state_dict` keys are those paths joined with "." with the same layout
(layers stacked on a leading L axis) and dtype, so conversion is a rename.
The MoE family's layer params convert the same way: "layers.moe.router"
(L, d, E) stays f32, the experts stay stacked as "layers.moe.w_gate" /
"w_up" (L, E, d, f) and "w_down" (L, E, f, d) in the weight dtype, and
arctic's parallel dense MLP is "layers.mlp". The encoder-decoder family's
tree (`repro.models.whisper.init`) converts the same way: "enc_layers.*" and
"dec_layers.*" stacked on their own layer axes (a decoder layer's "cross"
attention beside its "attn"), "dec_pos", "enc_norm", "final_norm" and
"head.table". The SSM family's (`repro.models.mamba2.init`) too:
"layers.ssm.*" (in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w,
out_proj) and "layers.pre_norm" stacked on the layer axis, A_log, D,
dt_bias and norm_w f32.
The input is the nested dict with numpy leaves (``np.asarray`` of each JAX
array); bfloat16 leaves (numpy's ml_dtypes bfloat16) keep their bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.transformer import Params


def _tensor(x: Any) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _convert(tree: Dict[str, Any], device) -> Dict[str, Any]:
    return {name: (_convert(v, device) if isinstance(v, dict)
                   else _tensor(v).to(device))
            for name, v in tree.items()}


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Params:
    """Nested dict of numpy arrays (reference parameter tree) → `Params`
    on ``device``."""
    return Params(_convert(tree, torch.device(device)))


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def opt_state_from_numpy(state: Dict[str, Any], device="cuda"
                         ) -> Dict[str, Any]:
    """Reference train-step optimizer state {"adam": {"m", "v", "count"}}
    (nested dicts of numpy arrays, f32 moments) → the port's state, whose
    moments are keyed by the parameters' `state_dict` names."""
    adam = state["adam"]
    dev = torch.device(device)
    return {"adam": {
        "m": {k: _tensor(v).to(dev) for k, v in _flatten(adam["m"]).items()},
        "v": {k: _tensor(v).to(dev) for k, v in _flatten(adam["v"]).items()},
        "count": _tensor(adam["count"]).to(dev, torch.int32),
    }}
