"""Device selection shared by the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``; with
no card present and no CPU asked for, it raises instead of quietly running
the plain PyTorch versions on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device!r}")
