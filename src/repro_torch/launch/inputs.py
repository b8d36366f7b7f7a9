"""Empty stand-ins for every model input of a dry-run cell.

The reference's ``repro/launch/inputs.py`` gives ``ShapeDtypeStruct``s;
here they are empty tensors on a device the caller names: ``"meta"``,
or a fake ``"cuda"`` (or ``"cpu"``) device under a ``FakeTensorMode``
(``compat.fake_tensor_mode``), so a dry run allocates nothing.  The
shapes are the reference's; the dtypes are the ones the port's batches
carry:

* ``tokens``, ``labels`` (B, S): int32, as the reference's and as
  ``data/pipeline.py::synthetic_batch`` draws them;
* ``patch_embeds`` (B, N, embed_dim) of a ``vit_stub`` model and
  ``frames`` (B, S, embed_dim) of an encoder-decoder: the params' dtype
  (``cfg.dtype``; bfloat16 for every config, as the reference's), as the
  train and serve CLIs cast them;
* the decode token (B,): int32.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                      device="meta") -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=device),
        "labels": torch.empty((b, s), dtype=torch.int32, device=device),
    }
    dtype = getattr(torch, cfg.dtype)
    if cfg.frontend is not None and cfg.frontend.kind == "vit_stub":
        specs["patch_embeds"] = torch.empty(
            (b, cfg.frontend.num_tokens, cfg.frontend.embed_dim),
            dtype=dtype, device=device)
    if cfg.is_encdec:
        specs["frames"] = torch.empty((b, s, cfg.frontend.embed_dim),
                                      dtype=dtype, device=device)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                        device="meta") -> Dict[str, torch.Tensor]:
    """The train inputs without ``labels``."""
    specs = train_input_specs(cfg, shape, device)
    specs.pop("labels")
    return specs


def decode_token_spec(shape: ShapeConfig, device="meta") -> torch.Tensor:
    return torch.empty((shape.global_batch,), dtype=torch.int32,
                       device=device)
