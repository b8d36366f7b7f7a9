"""CNN inference on torch tensors — ``repro/models/cnn.py`` (VGG /
ResNet), in its two numerics modes:

* dense — float32 convolutions (the accuracy oracle);
* cim — every conv and FC layer through the Domino PE pipeline: im2col,
  then the CIM linear (8-bit weights resident in crossbars, per-tensor
  8-bit activations, the per-subarray ADC), whose ADC pipeline is the
  CIM kernel on a CUDA tensor and its plain version on a CPU one.

Layouts stay NHWC activations and HWIO conv kernels at the public
functions, as in the reference; the dense convolution runs in PyTorch's
NCHW/OIHW.  BatchNorm is assumed folded into conv weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.cnn import CNNConfig, ConvLayer, FCLayer
from repro_torch.core.cim import CIMSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def init_cnn(cnn: CNNConfig, generator: Optional[torch.Generator] = None,
             device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-style normal init (``N(0, 1) / sqrt(fan_in)``) drawn from
    ``generator`` on the CPU, then moved to ``device``.  These are not
    the reference's numbers (different generators): parity tests feed
    the same numpy params to both packages instead."""
    dev = resolve_device(device)
    params = {}
    for layer in cnn.layers:
        if isinstance(layer, ConvLayer):
            shape = (layer.k, layer.k, layer.c, layer.m)
            fan_in = layer.c * layer.k * layer.k
        else:
            shape = (layer.c_in, layer.c_out)
            fan_in = layer.c_in
        w = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
        params[layer.name] = w.to(dev, dtype)
    return params


def _cim_linear(x: torch.Tensor, wmat: torch.Tensor,
                cim: CIMSpec) -> torch.Tensor:
    """The reference's ``cim_linear_reference``: weights quantized per
    column, activations per tensor, the ADC pipeline (the CIM kernel on
    a CUDA tensor), dequantized."""
    return ops.cim_linear(x, *ops.quantize_weights(wmat, cim), spec=cim)


def im2col(x: torch.Tensor, layer: ConvLayer) -> torch.Tensor:
    """(B, H, W, C) -> (B, E, F, C*K*K) receptive-field rows, features in
    (C, K, K) order as ``lax.conv_general_dilated_patches`` emits them
    (``F.unfold`` on NCHW gives the same order)."""
    b = x.shape[0]
    cols = F.unfold(x.permute(0, 3, 1, 2), layer.k, padding=layer.p,
                    stride=layer.s)                     # (B, C*K*K, E*F)
    e = (x.shape[1] + 2 * layer.p - layer.k) // layer.s + 1
    f = (x.shape[2] + 2 * layer.p - layer.k) // layer.s + 1
    return cols.transpose(1, 2).reshape(b, e, f, -1)


def _conv(x: torch.Tensor, w: torch.Tensor, layer: ConvLayer,
          cim: Optional[CIMSpec] = None) -> torch.Tensor:
    """NHWC x HWIO -> NHWC: a float convolution, or with a spec an im2col
    whose rows go through the CIM linear against the (K*K*C, M) weight
    matrix resident in crossbars."""
    if cim is None:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=layer.s, padding=layer.p)
        return y.permute(0, 2, 3, 1)
    patches = im2col(x, layer)
    b, e, f = patches.shape[:3]
    # the patches' (C, K, K) feature order: weights reordered to match
    wmat = w.permute(2, 0, 1, 3).reshape(-1, layer.m)
    out = _cim_linear(patches.reshape(b * e * f, -1), wmat, cim)
    return out.reshape(b, e, f, layer.m)


def _max_pool(x: torch.Tensor, layer: ConvLayer) -> torch.Tensor:
    """VALID max pool (window ``pool_k``, stride ``pool_s``), NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), layer.pool_k, layer.pool_s)
    return y.permute(0, 2, 3, 1)


def cnn_forward(params: Dict[str, torch.Tensor], images: torch.Tensor,
                cnn: CNNConfig, cim: Optional[CIMSpec] = None,
                capture: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, classes).

    ``cim`` selects the CIM mode (every conv and FC layer through the PE
    pipeline with this crossbar spec); ``None`` is the dense mode.  The
    activation scale is per tensor over the whole batch, as in the
    reference, so a frame's logits depend on its batch.

    ``capture`` (a dict, filled in place) records every layer's *input*
    activation keyed by layer name — the quantized engine calibrates
    its per-layer activation scale and ADC gain from it.
    """
    # full-precision float32 on the card: cuDNN convolutions default to
    # TF32 (about three decimal digits), which would move calibration
    # far more than the reference's float32 forward; matmuls are pinned
    # too so the setting does not depend on the caller
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = images
    saved: Dict[str, torch.Tensor] = {}
    layers: List = list(cnn.layers)
    i = 0
    while i < len(layers):
        layer = layers[i]
        if isinstance(layer, FCLayer):
            if x.dim() == 4:
                if cnn.name.startswith("resnet"):
                    x = x.mean(dim=(1, 2))  # global average pool
                else:
                    x = x.reshape(x.shape[0], -1)
            if capture is not None:
                capture[layer.name] = x
            if cim is None:
                x = x @ params[layer.name]
            else:
                x = _cim_linear(x, params[layer.name], cim)
            if i < len(layers) - 1:
                x = torch.relu(x)
            i += 1
            continue

        if layer.name.endswith("_a"):
            saved["block_in"] = x
        if capture is not None:
            capture[layer.name] = x
        y = _conv(x, params[layer.name], layer, cim)
        if layer.residual_from is not None:
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if isinstance(nxt, ConvLayer) and nxt.name.endswith("_sc"):
                if capture is not None:
                    capture[nxt.name] = saved["block_in"]
                shortcut = _conv(saved["block_in"], params[nxt.name], nxt,
                                 cim)
                i += 1  # consume the shortcut layer
            else:
                shortcut = saved["block_in"]
            y = y + shortcut
        x = torch.relu(y)
        if layer.pool_s:
            x = _max_pool(x, layer)
        i += 1
    return x


def collect_layer_inputs(params: Dict[str, torch.Tensor],
                         images: torch.Tensor, cnn: CNNConfig
                         ) -> Dict[str, torch.Tensor]:
    """Float forward pass capturing each layer's input activation — the
    calibration hook for the quantized engine."""
    capture: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        cnn_forward(params, images, cnn, capture=capture)
    return capture
