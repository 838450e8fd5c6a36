"""The port's sharded 2D solve() against the JAX package's sharded solve().

The JAX runs are ``shard_map`` over the 8 virtual CPU devices of
``tests/conftest.py``; the port's runs cut the grid into blocks on the
CPU. ``backend="torch"`` is held to JAX ``backend="jnp"`` on the
meshes (2, 1), (1, 2), (2, 2), (2, 4) and (4, 2) at 32^2, at halo depths
1, 2, 4 and 8, for step counts that are and are not a multiple of the
depth, and bitwise to the port's one-block torch run.
``backend="cuda"`` on the CPU (the G kernels' plain versions) is held to
JAX ``backend="pallas"`` (kernel G in interpret mode) at 32^2 on (2, 2)
with K = 8, and bitwise to the port's one-block cuda run (E's plain
version). Converge mode must give JAX's ``steps_run`` and ``converged``,
with check intervals that are and are not multiples of K.

Tolerances: ``rtol=1e-5, atol=1e-5`` on grids and ``rtol=1e-4`` on
residuals (the few-ulp contract of ``tests/test_torch_kernels.py``:
XLA:CPU may contract multiply-adds into FMAs where eager PyTorch rounds
every operation); the Dirichlet ring bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu_torch import HeatConfig, HeatMesh, explain, solve
from parallel_heat_tpu_torch.config import HeatConfig as PortConfig
from parallel_heat_tpu_torch.convert import from_jax
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
from parallel_heat_tpu_torch.parallel import temporal

MESHES = [(2, 1), (1, 2), (2, 2), (2, 4), (4, 2)]


def _close_grid(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _ring_exact(got, want):
    g, w = np.asarray(got), np.asarray(want)
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(g[sl], w[sl])


def _port(**kw):
    return solve(HeatConfig(**kw), device="cpu")


@pytest.mark.parametrize("remainder", [False, True],
                         ids=["steps_multiple_of_k", "steps_with_remainder"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_torch_backend_matches_jax_jnp_sharded(mesh, depth, remainder):
    steps = 3 * depth + (1 if remainder else 0)
    base = dict(nx=32, ny=32, steps=steps)
    want = jx.solve(jx.HeatConfig(backend="jnp", mesh_shape=mesh,
                                  halo_depth=depth, **base)).to_numpy()
    got = _port(backend="torch", mesh_shape=mesh, halo_depth=depth, **base)
    assert got.steps_run == steps
    _close_grid(got.to_numpy(), want)
    _ring_exact(got.to_numpy(), want)
    one = _port(backend="torch", **base)
    assert torch.equal(got.grid, one.grid)


@pytest.mark.parametrize("mode", ["overlap", "phase"])
def test_cuda_backend_matches_jax_pallas_sharded(mode):
    # 27 steps: three K = 8 rounds of kernel G and a remainder of 3 (the
    # JAX package runs its jnp rounds there, the port G at depth 3).
    base = dict(nx=32, ny=32, steps=27)
    want = jx.solve(jx.HeatConfig(backend="pallas", mesh_shape=(2, 2),
                                  halo_depth=8, halo_overlap=mode,
                                  **base)).to_numpy()
    sk.reset_counts()
    got = _port(backend="cuda", mesh_shape=(2, 2), halo_overlap=mode,
                **base)
    used = "block_uniform_plain"
    assert sk.counts[used] == 4 * 4
    # Every block's bands in one call a round: 4 rounds.
    assert sk.counts["band_fix_plain"] == (4 if mode == "overlap" else 0)
    _close_grid(got.to_numpy(), want)
    _ring_exact(got.to_numpy(), want)
    one = _port(backend="cuda", **base)
    assert torch.equal(got.grid, one.grid)
    # The batched bands leave the grid as the other schedule computes it.
    other = "phase" if mode == "overlap" else "overlap"
    assert torch.equal(got.grid, _port(backend="cuda", mesh_shape=(2, 2),
                                       halo_overlap=other, **base).grid)


@pytest.mark.parametrize("backend,depth,ci", [
    ("torch", 4, 20), ("torch", 4, 13), ("torch", 1, 20),
    ("cuda", 8, 20), ("cuda", 8, 13), ("cuda", 3, 7)])
def test_converge_matches_jax(backend, depth, ci):
    kw = dict(nx=20, ny=20, steps=10_000, converge=True, check_interval=ci,
              eps=1e-3)
    want = jx.solve(jx.HeatConfig(backend="jnp", mesh_shape=(2, 2),
                                  halo_depth=depth, **kw))
    got = _port(backend=backend, mesh_shape=(2, 2), halo_depth=depth, **kw)
    assert (got.steps_run, got.converged) == (want.steps_run,
                                              bool(want.converged))
    np.testing.assert_allclose(got.residual, float(want.residual),
                               rtol=1e-4)
    _close_grid(got.to_numpy(), want.to_numpy())
    one = _port(backend=backend, **kw)
    assert (got.steps_run, got.converged, got.residual) == (
        one.steps_run, one.converged, one.residual)
    assert torch.equal(got.grid, one.grid)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_schedules_and_forms_bitwise_equal(backend):
    base = dict(nx=48, ny=40, steps=37, cx=0.1, cy=0.2, backend=backend,
                mesh_shape=(3, 2), halo_depth=5)
    grids = [_port(halo_overlap=m, **base).grid for m in ("overlap",
                                                           "phase")]
    if backend == "torch":
        grids += [_port(**{**base, "halo_depth": 1, "overlap": o}).grid
                  for o in (True, False)]
    else:
        from parallel_heat_tpu_torch import tune

        for kind in ("G-fuse", "G-circ", "G"):
            with tune.force("block_temporal_2d", kind):
                grids.append(_port(**base).grid)
        # Pinned to the torch rounds, the cuda backend runs the textbook
        # tree: the torch backend's grid, not the kernels'.
        with tune.force("block_temporal_2d", "torch"):
            textbook = _port(**base).grid
        assert torch.equal(textbook,
                           _port(**{**base, "backend": "torch"}).grid)
    for g in grids[1:]:
        assert torch.equal(g, grids[0])


def test_bulk_reads_no_phase_two_buffer():
    """Fill the halo rows with NaN before the bulk: its rows [k, bx-k)
    and its residual do not change (the port's counterpart of the JAX
    package's data-dependence argument for the overlapped round)."""
    rng = np.random.default_rng(2)
    mesh = HeatMesh((2, 2))
    grid = (32, 48)
    us = mesh.split(torch.from_numpy(
        (rng.standard_normal(grid) * 10).astype(np.float32)))
    k = 5
    xch = temporal.DeepExchange2D(mesh, (16, 24), k, "cpu")
    xch.phase1(us)
    for b in range(mesh.size):
        kw = dict(origin=mesh.origin(b, (16, 24)), grid_shape=grid, cx=0.1,
                  cy=0.1)
        clean = torch.empty(16, 24)
        r_clean = skb.block_uniform(us[b], xch.tail[b], None, None, clean, k,
                                    **kw)
        xch.halo_n[b].fill_(float("nan"))
        xch.halo_s[b].fill_(float("nan"))
        out = torch.empty(16, 24)
        r = skb.block_uniform(us[b], xch.tail[b], None, None, out, k, **kw)
        assert torch.equal(out[k:-k], clean[k:-k])
        assert float(r) == float(r_clean)
    # And the round itself never reads them before phase 2 rewrites them.
    round_ = temporal._cuda_round_2d(xch, "G-uni", "overlap", grid_shape=grid,
                                     cx=0.1, cy=0.1)
    vs = [torch.empty_like(u) for u in us]
    round_(us, vs, True)
    want = [torch.empty_like(u) for u in us]
    temporal._cuda_round_2d(
        temporal.DeepExchange2D(mesh, (16, 24), k, "cpu"), "G-uni", "phase",
        grid_shape=grid, cx=0.1, cy=0.1)(us, want, True)
    assert all(torch.equal(v, w) for v, w in zip(vs, want))


def test_sharded_cli_matches_one_block(tmp_path):
    from parallel_heat_tpu_torch.cli import main
    from parallel_heat_tpu_torch.utils.io import read_dat

    a, b = tmp_path / "mesh.dat", tmp_path / "one.dat"
    assert main(["--nx", "64", "--ny", "48", "--steps", "30", "--mesh",
                 "2,4", "--backend", "cuda", "--device", "cpu", "--out",
                 str(a)]) == 0
    assert main(["--nx", "64", "--ny", "48", "--steps", "30", "--backend",
                 "cuda", "--device", "cpu", "--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert read_dat(str(a)).shape == (64, 48)
    assert main(["--nx", "64", "--ny", "64", "--mesh", "2,2",
                 "--halo-overlap", "pipeline", "--device", "cpu"]) == 2
    assert main(["--nx", "64", "--ny", "64", "--mesh", "3,2",
                 "--device", "cpu"]) == 2


def test_explain_reports_the_sharded_path():
    out = explain(HeatConfig(nx=1000, ny=1000, mesh_shape=(2, 4),
                             backend="cuda"), device="cpu")
    assert out["mesh"] == (2, 4) and out["block_shape"] == (500, 250)
    assert out["halo_depth"] == "8 (auto)"
    assert out["halo_overlap"] == "overlap (auto)"
    assert out["decided_by"]["block_temporal_2d"]["choice"] == "G-fuse"
    assert "heat_g_block_fused" in out["path"]
    assert "heat_g_band_fix" in out["path"]
    assert "not a multiple of 4" in out["path"]
    small = explain(HeatConfig(nx=20, ny=20, mesh_shape=(2, 2),
                               backend="cuda"), device="cpu")
    assert "fewer than 2K = 16" in small["path"]
    phase = explain(HeatConfig(nx=64, ny=64, mesh_shape=(2, 2),
                               backend="cuda", halo_overlap="phase",
                               halo_depth=4), device="cpu")
    assert phase["halo_depth"] == 4 and phase["halo_overlap"] == "phase"
    assert "monolithic round: heat_g_block_uniform" in phase["path"]
    torch_path = explain(HeatConfig(nx=64, ny=64, mesh_shape=(2, 2)),
                         device="cpu")
    assert torch_path["halo_depth"] == "1 (auto)"
    assert "per-step 1-deep" in torch_path["path"]


def test_validation_mirrors_jax_and_refuses_what_is_not_ported():
    bad = dict(nx=30, ny=32, mesh_shape=(4, 2))
    with pytest.raises(ValueError) as jax_err:
        jx.HeatConfig(**bad).validate()
    with pytest.raises(ValueError) as port_err:
        HeatConfig(**bad).validate()
    assert str(port_err.value) == str(jax_err.value)
    assert "valid 8-device mesh shapes" in str(port_err.value)
    with pytest.raises(ValueError, match="exceeds the smallest block"):
        HeatConfig(nx=32, ny=32, mesh_shape=(4, 2), halo_depth=9,
                   backend="torch").validate()
    with pytest.raises(ValueError, match="G kernels' shared-memory bound"):
        HeatConfig(nx=64, ny=64, mesh_shape=(2, 2), halo_depth=9,
                   backend="cuda").validate()
    HeatConfig(nx=64, ny=64, mesh_shape=(2, 2), halo_depth=9,
               backend="torch").validate()
    with pytest.raises(ValueError, match="halo_depth must be >= 1"):
        HeatConfig(mesh_shape=(2, 2), halo_depth=0).validate()
    with pytest.raises(ValueError, match="halo_overlap must be one of"):
        HeatConfig(mesh_shape=(2, 2), halo_overlap="later").validate()
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        HeatConfig(mesh_shape=(2, 2), halo_overlap="pipeline").validate()
    # A 3D mesh is ported (tests/test_torch_sharded3d.py).
    HeatConfig(nx=8, ny=8, nz=8, mesh_shape=(2, 1, 1)).validate()
    with pytest.raises(ValueError, match="queue 1 item 9"):
        HeatConfig(nx=18, ny=18, cx=22.5, cy=22.5, scheme="backward_euler",
                   mesh_shape=(2, 1)).validate()
    with pytest.raises(ValueError, match="rank does not match"):
        HeatConfig(mesh_shape=(2, 2, 1)).validate()


def test_from_dict_and_from_jax_carry_the_mesh():
    jcfg = jx.HeatConfig(nx=32, ny=32, steps=21, backend="jnp",
                         mesh_shape=(2, 4), halo_depth=4,
                         halo_overlap="phase")
    spec = dataclasses.asdict(jcfg)
    spec["mesh_shape"] = list(spec["mesh_shape"])  # as JSON gives it
    port = PortConfig.from_dict({**spec, "backend": "torch",
                                 "device": "cpu"})
    assert port.mesh_shape == (2, 4) and port.halo_depth == 4
    assert port.halo_overlap == "phase" and hash(port)
    result = jx.solve(jcfg)
    cfg, blocks = from_jax(spec, np.asarray(result.grid), device="cpu")
    assert isinstance(blocks, list) and len(blocks) == 8
    assert tuple(blocks[0].shape) == (16, 8)
    assert torch.equal(HeatMesh((2, 4)).assemble(blocks),
                       torch.from_numpy(np.asarray(result.grid)))
    # The blocks go straight back into solve().
    more = solve(cfg.replace(steps=5), initial=blocks, device="cpu")
    again = solve(cfg.replace(steps=5, mesh_shape=None),
                  initial=np.asarray(result.grid), device="cpu")
    assert torch.equal(more.grid, again.grid)


def test_mesh_helpers_match_jax():
    from parallel_heat_tpu.config import divisible_factorizations as jdf
    from parallel_heat_tpu.parallel.mesh import pick_mesh_shape as jpick
    from parallel_heat_tpu_torch.parallel.mesh import (
        divisible_factorizations, pick_mesh_shape)

    for n in (1, 2, 6, 8, 12, 30):
        for ndim in (2, 3):
            assert pick_mesh_shape(n, ndim) == jpick(n, ndim)
        assert divisible_factorizations(n, (60, 24)) == jdf(n, (60, 24))
    mesh = HeatMesh((2, 4))
    g = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    blocks = mesh.split(g)
    assert torch.equal(blocks[5], g[4:8, 3:6])
    assert torch.equal(mesh.assemble(blocks), g)
    assert mesh.neighbour(0, 0, -1) is None and mesh.neighbour(0, 1, 1) == 1
    down = mesh.shift_down(blocks, 1)
    assert torch.equal(down[1], blocks[0]) and not down[0].any()
