"""Point-coordinate embeddings for the decoders (reference decoder.py):

- 'fourier': learnable Gaussian Fourier features, sin(x @ B), B ~ N(0, 25^2),
  93 output dims (decoder.py:7-30);
- 'nerf': the NeRF positional encoding [x, sin(fx), cos(fx), ...]; a colour
  decoder uses multires 10 log-sampled, the others multires 5 linear
  (decoder.py:33-67, 135-144);
- 'same': the identity (decoder.py:82-88);
- 'fc_relu': relu(x @ w + b), 93 output dims.
"""

from __future__ import annotations

from typing import Optional

import torch

EMB_DIM = 93


def init_fourier_embedding(gen: Optional[torch.Generator], in_dim: int = 3,
                           mapping_size: int = EMB_DIM, scale: float = 25.0,
                           device="cuda"):
    return {"B": torch.randn(in_dim, mapping_size, generator=gen,
                             device=device) * scale}


def embedding_dim(method: str, name: str = "", in_dim: int = 3) -> int:
    if method in ("fourier", "fc_relu"):
        return EMB_DIM
    if method == "same":
        return in_dim
    if method == "nerf":
        multires = 10 if "color" in name else 5
        return multires * 2 * in_dim + in_dim
    raise ValueError(f"unknown embedding method {method}")


def _nerf_pe(x: torch.Tensor, multires: int, log_sampling: bool):
    if log_sampling:
        freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires)
    else:
        freqs = torch.linspace(2.0 ** 0.0, 2.0 ** (multires - 1), multires)
    outs = [x]
    for f in freqs.tolist():
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def apply_embedding(params, x: torch.Tensor, method: str,
                    name: str = "") -> torch.Tensor:
    """The products stay in full fp32 (the port never enables TF32): the
    Fourier arguments reach O(100)."""
    if method == "fourier":
        return torch.sin(torch.matmul(x, params["B"]))
    if method == "same":
        return x
    if method == "nerf":
        multires = 10 if "color" in name else 5
        return _nerf_pe(x, multires, log_sampling="color" in name)
    if method == "fc_relu":
        return torch.relu(torch.matmul(x, params["w"]) + params["b"])
    raise ValueError(f"unknown embedding method {method}")
