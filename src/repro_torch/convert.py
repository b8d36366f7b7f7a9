"""Carrying weights and calibration across from the JAX reference.

The reference keeps CNN params as numpy / jax arrays (name -> HWIO conv
kernel or (C_in, C_out) FC matrix, or a ``{"q", "s"}`` quantized leaf);
the port keeps the same layout as tensors on a device.  Nothing here
imports the reference: it reads plain arrays and duck-typed engines.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_reference(params: Dict[str, Any], device=None
                          ) -> Dict[str, Any]:
    """The reference's CNN params (arrays, or ``{"q", "s"}`` leaves) as
    the port's tensors on ``device`` (``None`` = the card), same layout
    and dtypes."""
    dev = resolve_device(device)

    def one(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    return {name: ({"q": one(leaf["q"]), "s": one(leaf["s"])}
                   if isinstance(leaf, dict) else one(leaf))
            for name, leaf in params.items()}


def copy_calibration(ref_engine, engine):
    """Give ``engine`` (a port ``CIMEngine``) the per-layer calibration of
    ``ref_engine`` (a reference or port ``CIMEngine``): each layer's
    ``(a_scale, gain)`` through ``set_layer``.  Calibration runs a float
    forward whose convolutions differ between frameworks and devices by
    an ulp, and an ulp can move an ADC code; copying it makes the two
    engines convert identically."""
    for name, cal in ref_engine.calib.items():
        engine.set_layer(name, a_scale=cal.a_scale, gain=cal.gain)
    return engine
