"""Rows and queries made on the device from the run's seed.

A configuration's ``data`` block names a Gaussian mixture seen through a
low-rank map, the shape real text embeddings have (a few dozen
directions carry most of the variance, and the rows gather in topics):

    z = centre[c] + within * g,   g ~ N(0, I_m),  c uniform over centres
    x = normalize(z @ basis + noise * e / sqrt(dim)),  e ~ N(0, I_dim)

with ``centres`` centres ~ N(0, I_m) and ``basis`` (m, dim) ~ N(0, 1/m).
Every draw comes from a CUDA (or CPU) ``torch.Generator`` seeded by a
hash of (seed, what, block), so the same seed and row count give the
same rows on any call; rows are drawn ``BLOCK_ROWS`` at a time.
Nothing here imports the program.
"""

from __future__ import annotations

import hashlib

import torch

BLOCK_ROWS = 131072


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one purpose of one run's seed."""
    text = repr((int(seed),) + tuple(parts)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def _gen(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, *parts))
    return g


def mixture_params(spec: dict, dim: int, seed: int, device):
    """The mixture's centres (C, m) and basis (m, dim), from the seed."""
    m = int(spec["intrinsic_dim"])
    g = _gen(device, seed, "mixture")
    centres = torch.randn((int(spec["centres"]), m), generator=g,
                          device=device) * float(spec["centre_scale"])
    basis = torch.randn((m, dim), generator=g, device=device) / m ** 0.5
    return centres, basis


def draw(spec: dict, params, n: int, dim: int, gen: torch.Generator,
         device) -> torch.Tensor:
    """n unit rows (f32) of the mixture."""
    centres, basis = params
    c = torch.randint(0, centres.shape[0], (n,), generator=gen,
                      device=device)
    z = centres[c] + float(spec["within_scale"]) * torch.randn(
        (n, centres.shape[1]), generator=gen, device=device)
    x = z @ basis + (float(spec["ambient_noise"]) / dim ** 0.5) * torch.randn(
        (n, dim), generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def row_blocks(spec: dict, n: int, dim: int, seed: int, device):
    """Yield (start, rows) over the n rows, ``BLOCK_ROWS`` at a time."""
    params = mixture_params(spec, dim, seed, device)
    for b, start in enumerate(range(0, n, BLOCK_ROWS)):
        stop = min(n, start + BLOCK_ROWS)
        yield start, draw(spec, params, stop - start, dim,
                          _gen(device, seed, "rows", b), device)


def rows(spec: dict, n: int, dim: int, seed: int, device) -> torch.Tensor:
    """All n rows as one (n, dim) f32 tensor on ``device``."""
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for start, block in row_blocks(spec, n, dim, seed, device):
        out[start:start + block.shape[0]] = block
    return out


def query_pool(spec: dict, n: int, dim: int, seed: int,
               device) -> torch.Tensor:
    """n fresh draws of the same mixture (never copies of rows)."""
    params = mixture_params(spec, dim, seed, device)
    return draw(spec, params, n, dim, _gen(device, seed, "pool"), device)
