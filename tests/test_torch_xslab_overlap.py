"""Kernel F's overlap probe
(``parallel_heat_tpu_torch.tools.probe_xslab_overlap``) against the JAX
package's ``tools/ab_xslab_overlap.py``.

The JAX probe's ``build_3buf`` is kernel F's K 7-point steps over X-slabs
of ``sx`` planes with the K - 1 intermediate sweeps in two buffers of
their own, no residual; it runs here in interpret mode, as the JAX
package's own tests run its Pallas kernels on the CPU. The port's probe
compiles F's launch at K = 3 only (F's default depth); its one function
form, ``full``, takes F's plain version on the CPU, so at K = 1 and 2 the
JAX probe is held to that plain version directly. ``no_step`` and
``no_load`` are measurements and refuse the CPU. Tolerance ``rtol=1e-5,
atol=1e-5``: the JAX probe's and the port's step round differently by a
few ulps a step; the six faces bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.ab_xslab_overlap as jxo
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.tools import probe_xslab_overlap as xo

KW = dict(cx=0.1, cy=0.1, cz=0.1)


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("sx", [8, 16])
@pytest.mark.parametrize("shape", [(32, 24, 128), (48, 16, 128)])
def test_full_matches_the_jax_probe(monkeypatch, shape, sx, k):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    u = _rand(shape, sx + k)
    want = np.asarray(jxo.build_3buf(shape, sx, k)(jnp.asarray(u)))
    got = torch.empty(shape, dtype=torch.float32)
    if k == 3:
        assert xo.overlap_steps("full", torch.from_numpy(u), got, k,
                                **KW) is None
    else:
        sk3.xslab_steps_3d_plain(torch.from_numpy(u), got, k, False, **KW)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
               np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(got.numpy()[sl], u[sl])


@pytest.mark.parametrize("load", [None, "tma", "cp.async"])
@pytest.mark.parametrize("with_residual", [True, False])
def test_full_is_f_plain_on_the_cpu(with_residual, load):
    u = torch.from_numpy(_rand((21, 18, 36), 5))
    got, want = torch.empty_like(u), torch.empty_like(u)
    sk.reset_counts()
    xo.counts["heat_probe_xslab_overlap"] = 0
    r = xo.overlap_steps("full", u, got, 3, with_residual, load=load, **KW)
    assert sk.counts["xslab_steps_3d_plain"] == 1
    assert xo.counts["heat_probe_xslab_overlap"] == 0
    rq = sk3.xslab_steps_3d_plain(u, want, 3, with_residual, **KW)
    assert torch.equal(got, want)
    assert (r is None and rq is None) or torch.equal(r, rq)


@pytest.mark.parametrize("variant", ["no_step", "no_load"])
def test_measurement_variants_raise_on_the_cpu(variant):
    u = torch.from_numpy(_rand((12, 10, 16), 0))
    with pytest.raises(ValueError, match="runs only on the card"):
        xo.overlap_steps(variant, u, torch.empty_like(u), 3, **KW)


@pytest.mark.parametrize("case", ["variant", "k", "tma_width", "load",
                                  "prefetch", "shape"])
def test_bad_input_is_refused(case):
    u = torch.zeros((12, 10, 18) if case == "tma_width" else (12, 10, 16))
    out = (torch.empty(12, 10, 17) if case == "shape"
           else torch.empty_like(u))
    kw = dict(KW, load={"tma_width": "tma", "load": "bulk"}.get(case),
              prefetch=9 if case == "prefetch" else None)
    with pytest.raises(ValueError):
        xo.overlap_steps("overlap" if case == "variant" else "full", u, out,
                         2 if case == "k" else 3, **kw)


def test_ring_ladder_fits_shared_memory():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    block, rows, prefetch = p.f_shape(3)
    top = xo.prefetch_max(3)
    assert prefetch <= top <= p.f_prefetch_max
    assert (p.f_smem_bytes(3, block, rows, top) + p.static_smem_bytes
            <= p.smem_per_block_max)
    assert top == p.f_prefetch_max or (
        p.f_smem_bytes(3, block, rows, top + 1) + p.static_smem_bytes
        > p.smem_per_block_max)


def test_probe_builds_beside_the_twenty_kernels():
    assert "heat_probe_xslab_overlap" in build.TOOLS
    assert "heat_probe_xslab_overlap" not in build.KERNELS
    assert "heat_probe_xslab_overlap" not in sk.counts
    assert set(xo.CODES) == set(xo.VARIANTS) and xo.CODES["full"] == 0
