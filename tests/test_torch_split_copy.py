"""Kernel E-uni's split-copy probe
(``parallel_heat_tpu_torch.tools.probe_split_copy``) against the JAX
package's ``tools/probe_split_copy.py``.

Every form of either probe computes kernel E's K steps (no residual): the
JAX one on its strip pipeline with the copy split each way, run here in
interpret mode as the JAX package's own tests run its Pallas kernels on
the CPU; the port's, on the CPU, through E-uni's plain version. The
port's forms other than ``whole`` and ``branchy`` refuse a geometry whose
boxes would not land on 128-byte boundaries of shared memory, on every
device; at K = 2 and 4 E-uni's 112-wide tile gives rows of 120 floats,
so the parity cases pass a 120-wide tile (rows of 128 floats), which the
plain version does not read. Tolerance ``rtol=1e-5, atol=1e-5``: the two
packages round the combine differently by a few ulps a step; the
Dirichlet ring bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.probe_split_copy as jsplit
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import probe_split_copy as sc

# A tile at which every form's boxes land on 128-byte boundaries at K = 1
# .. 4 (shared rows of 128 floats).
SPLIT_TILE = (96, 120)


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(np.float32)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("form", sc.TPU_FORMS)
def test_form_matches_the_jax_probe(monkeypatch, form, k):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    shape = (64, 256)
    u = _rand(shape, k)
    grid, _ = jsplit.build(shape, k, form)(jnp.asarray(u))
    got = torch.empty(shape, dtype=torch.float32)
    sc.split_steps(form, torch.from_numpy(u), got, k, cx=0.1, cy=0.1,
                   tile=SPLIT_TILE)
    np.testing.assert_allclose(got.numpy(), np.asarray(grid), rtol=1e-5,
                               atol=1e-5)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got.numpy()[sl], u[sl])


@pytest.mark.parametrize("form", sc.variants())
@pytest.mark.parametrize("k", [1, 5, 8])
def test_every_form_is_e_uni_plain_on_the_cpu(form, k):
    u = torch.from_numpy(_rand((45, 52), k))
    got, want = torch.empty_like(u), torch.empty_like(u)
    tile = None if sc.refusal(form, k) is None else SPLIT_TILE
    sk.reset_counts()
    sc.counts["heat_probe_split_copy"] = 0
    sc.split_steps(form, u, got, k, cx=0.1, cy=0.2, tile=tile)
    assert sk.counts["temporal_steps_uni_plain"] == 1
    assert sc.counts["heat_probe_split_copy"] == 0
    sk.temporal_steps_uni_plain(u, want, k, False, cx=0.1, cy=0.2)
    assert torch.equal(got, want)


def test_forms_keep_the_tpu_names_and_add_row_bands():
    assert sc.variants() == sc.TPU_FORMS + ("rows8",)
    assert sc.variants((32, 4))[-1] == "rows4"
    assert [sc.code(f) for f in sc.variants()] == list(range(8))


@pytest.mark.parametrize("k", range(1, 9))
def test_main_path_geometry(k):
    # E-uni's tile: rows of 120 floats at K <= 4, 128 at K = 5 .. 8.
    refused = {f for f in sc.variants() if sc.refusal(f, k) is not None}
    if k <= 4:
        assert refused == set(sc.variants()) - {"whole", "branchy"}
    else:
        assert refused == set()


@pytest.mark.parametrize("case", ["form", "rows", "lanes4", "lanes2",
                                  "rows2", "k", "width"])
def test_split_refuses_bad_input(case):
    u = torch.zeros((20, 26) if case == "width" else (20, 24))
    form, k, tile = {"form": ("rows3", 8, None),
                     "rows": ("lanes2", 2, None),
                     "lanes4": ("lanes4", 8, (96, 144)),
                     "lanes2": ("lanes2", 8, (96, 144)),
                     "rows2": ("rows2", 8, (95, 112)),
                     "k": ("whole", 0, None),
                     "width": ("whole", 4, None)}[case]
    with pytest.raises(ValueError):
        sc.split_steps(form, u, torch.empty_like(u), k, cx=0.1, cy=0.1,
                       tile=tile)


def test_split_copy_builds_beside_the_twenty_kernels():
    assert "heat_probe_split_copy" in build.TOOLS
    assert "heat_probe_split_copy" not in build.KERNELS
    assert "heat_probe_split_copy" not in sk.counts
    assert build.TOOLS["heat_probe_split_copy"][1][1:] == \
        build.KERNELS["heat_e_uni_temporal"][1]
