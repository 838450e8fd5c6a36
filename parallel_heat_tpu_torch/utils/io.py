"""Grid file I/O — byte-compatible with the reference's ``prtdat``.

Format: iterate ``iy`` from ``ny-1`` down to 0 (outer) and ``ix`` from 0
to ``nx-1`` (inner), printing ``u[ix, iy]`` with C ``"%6.1f"``, one
space between values and a newline after each ``iy`` row, so each line
is one ``iy`` column of the array. This is the JAX package's pure-Python
writer and reader (its native C++ path is not ported); the bytes are
identical.
"""

from __future__ import annotations

import os

import numpy as np


def _as_numpy(u) -> np.ndarray:
    """The grid as float32 values, as the JAX writer casts them: exact for
    bfloat16 (numpy has no bfloat16, so a tensor of it is widened by
    ``.float()`` first), rounded once for float64."""
    if hasattr(u, "detach"):  # a torch tensor, on any device
        u = u.detach()
        if str(u.dtype) == "torch.bfloat16":
            u = u.float()
        u = u.cpu().numpy()
    return np.asarray(u, dtype=np.float32)


def save_npy(path: str | os.PathLike, t) -> None:
    """``np.save`` of the tensor ``t`` with the JAX CLI's bytes: a
    bfloat16 tensor as its raw 2-byte cells under the ``'<V2'`` descr that
    ``np.save`` gives an ``ml_dtypes`` bfloat16 array (numpy has no
    bfloat16 of its own), any other dtype as ``np.save`` writes it."""
    t = t.detach().cpu().contiguous()
    if str(t.dtype) != "torch.bfloat16":
        np.save(path, t.numpy())
        return
    import torch

    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(t.shape)})
        f.write(t.view(torch.int16).numpy().tobytes())


def _format_dat_python(u: np.ndarray) -> str:
    nx, ny = u.shape
    lines = []
    for iy in range(ny - 1, -1, -1):
        lines.append(" ".join(f"{float(u[ix, iy]):6.1f}" for ix in range(nx)))
    return "\n".join(lines) + "\n"


def write_dat(path: str | os.PathLike, u) -> None:
    """Write a 2D grid (tensor or array) in the reference ``.dat`` format."""
    u = _as_numpy(u)
    if u.ndim != 2:
        raise ValueError(f".dat format is 2D-only, got shape {u.shape}")
    with open(path, "w") as fp:
        fp.write(_format_dat_python(u))


def read_dat(path: str | os.PathLike) -> np.ndarray:
    """Read a ``.dat`` file back into the ``(nx, ny)`` array convention."""
    rows = []
    with open(path) as fp:
        for line in fp:
            line = line.strip("\n")
            if not line.strip():
                continue
            rows.append([float(tok) for tok in line.split()])
    arr = np.array(rows, dtype=np.float32)  # (ny, nx), iy descending
    return arr[::-1].T.copy()  # back to u[ix, iy]
