"""Point-coordinate embedding for the decoders: learnable Gaussian Fourier
features, sin(x @ B), B ~ N(0, 25^2), 93 output dims (reference
decoder.py:7-30).  The NeRF positional encoding waits for the iMAP* slice.
"""

from __future__ import annotations

from typing import Optional

import torch

EMB_DIM = 93


def init_fourier_embedding(gen: Optional[torch.Generator], in_dim: int = 3,
                           mapping_size: int = EMB_DIM, scale: float = 25.0,
                           device="cpu"):
    return {"B": torch.randn(in_dim, mapping_size, generator=gen,
                             device=device) * scale}


def embedding_dim(method: str) -> int:
    if method == "fourier":
        return EMB_DIM
    raise NotImplementedError(
        f"embedding {method!r} is not in the PyTorch port yet")


def apply_embedding(params, x: torch.Tensor, method: str) -> torch.Tensor:
    """sin(x @ B).  The arguments reach O(100), so the product stays in
    full fp32 (the port never enables TF32)."""
    if method == "fourier":
        return torch.sin(torch.matmul(x, params["B"]))
    raise NotImplementedError(
        f"embedding {method!r} is not in the PyTorch port yet")
