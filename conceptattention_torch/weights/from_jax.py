"""Parameter trees from the JAX package, handed over as numpy arrays.

The JAX package's parameter pytrees (nested dicts and lists; linear weights
[in, out], fused qkv [D, 3, H, head_dim] for flux and [D, 3*H*head_dim] for
CogVideoX, depth-stacked layers, OIHW and OIDHW conv weights, quantized
cells) share the port's layout, so conversion is leaf by leaf. The caller
does the `jax -> numpy` step (`jax.tree.map(np.asarray, tree)`); this module
never sees a JAX object.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from conceptattention_torch.models.flux.params import tree_map


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16, which torch cannot wrap
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy: JAX's arrays are read-only
    if dtype is None or not t.is_floating_point():
        return t.to(device=device)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """A parameter tree of numpy arrays -> the port's tensors on `device`.
    Floating leaves take `dtype` (or keep their own); integer leaves (the
    int8 and packed int4 cells of a quantized tree) keep theirs."""
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)


# The DiT's and the VAE's trees convert the same way; so do the video trees,
# the ViT's (`models/vit.py`) and open_clip's ({"visual", "text"},
# `models/clip_vit.py`), whose blocks JAX stacks by depth as the port does,
# and the SD UNet's (`models/sd_unet.py`), whose levels, resnets and
# transformer blocks are lists in both packages.
flux_params_from_numpy = params_from_numpy
ae_params_from_numpy = params_from_numpy
vit_params_from_numpy = params_from_numpy
open_clip_params_from_numpy = params_from_numpy
unet_params_from_numpy = params_from_numpy
