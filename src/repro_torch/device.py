"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises:
    the port never falls back to the CPU on its own — pass
    ``device="cpu"`` to ask for it.  Under a ``FakeTensorMode`` (a dry
    run, ``launch/dryrun_lib.py``) tensors on ``"cuda"`` are fake and
    need no card."""
    from repro_torch.compat import fake_mode_active

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and not fake_mode_active():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
