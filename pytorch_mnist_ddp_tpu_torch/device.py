"""Device selection: the card by default, the CPU only when asked."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; ``"cpu"`` is honoured only when asked.

    Asking for CUDA on a host without a usable card raises instead of
    dropping to the CPU: a serving process that silently ran its forward
    on the host would report CPU latencies under a GPU deployment's name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested (the default device) but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(--device cpu to the server, --no-cuda to the trainer) "
                "to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev
