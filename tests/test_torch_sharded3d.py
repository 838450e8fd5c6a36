"""The port's sharded 3D solve() against the JAX package's sharded 3D solve().

The JAX runs are ``shard_map`` over the 8 virtual CPU devices of
``tests/conftest.py``; the port's runs cut the grid into blocks on the
CPU. ``backend="torch"`` is held to JAX ``backend="jnp"`` on the meshes
(2, 2, 2) and (2, 2, 1) at 16^3 and a ragged 16 x 20 x 24, at halo depths
1, 3 and 4, for step counts that are and are not a multiple of the depth,
and bitwise to the port's one-block torch run. ``backend="cuda"`` on the
CPU (the H kernels' plain versions) is held to JAX ``backend="pallas"``
(kernel H in interpret mode) and bitwise to the port's one-block cuda run
(F's plain version). Converge mode must give JAX's ``steps_run`` and
``converged``.

Tolerances: ``rtol=1e-5, atol=1e-5`` on grids whose values stay near 10
(random initial grids), relative 1e-5 of the grid's scale on the model's
polynomial grid (values up to 1e8), and ``rtol=1e-4`` on residuals: the
few-ulp contract of ``tests/test_torch_kernels.py`` (XLA:CPU may contract
multiply-adds into FMAs where eager PyTorch rounds every operation); the
Dirichlet faces bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu_torch import HeatConfig, HeatMesh, explain, solve, tune
from parallel_heat_tpu_torch.config import HeatConfig as PortConfig
from parallel_heat_tpu_torch.convert import from_jax
from parallel_heat_tpu_torch.ops import stencil_kernels as sk

MESHES = [(2, 2, 2), (2, 2, 1)]
SHAPES = [(16, 16, 16), (16, 20, 24)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def _faces_exact(got, want):
    g, w = np.asarray(got), np.asarray(want)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
               np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(g[sl], w[sl])


def _port(**kw):
    return solve(HeatConfig(**kw), device="cpu")


def _dims(shape):
    return dict(zip(("nx", "ny", "nz"), shape))


@pytest.mark.parametrize("remainder", [False, True],
                         ids=["steps_multiple_of_k", "steps_with_remainder"])
@pytest.mark.parametrize("depth", [1, 3, 4])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_torch_backend_matches_jax_jnp_sharded(shape, mesh, depth,
                                               remainder):
    steps = 2 * depth + (1 if remainder else 0)
    base = dict(steps=steps, **_dims(shape))
    want = jx.solve(jx.HeatConfig(backend="jnp", mesh_shape=mesh,
                                  halo_depth=depth, **base)).to_numpy()
    got = _port(backend="torch", mesh_shape=mesh, halo_depth=depth, **base)
    assert got.steps_run == steps
    _close(got.to_numpy(), want)
    _faces_exact(got.to_numpy(), want)
    one = _port(backend="torch", **base)
    assert torch.equal(got.grid, one.grid)


@pytest.mark.parametrize("depth,steps", [(4, 8), (4, 9), (3, 7)])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_cuda_backend_matches_jax_pallas_sharded(mesh, depth, steps):
    # With a remainder the JAX package runs its jnp rounds there, the port
    # kernel H at depth steps % K.
    rng = np.random.default_rng(depth + steps)
    init = (rng.standard_normal((16, 16, 16)) * 10).astype(np.float32)
    base = dict(nx=16, ny=16, nz=16, steps=steps)
    want = jx.solve(jx.HeatConfig(backend="pallas", mesh_shape=mesh,
                                  halo_depth=depth, **base),
                    initial=init).to_numpy()
    sk.reset_counts()
    got = solve(HeatConfig(backend="cuda", mesh_shape=mesh,
                           halo_depth=depth, **base), initial=init,
                device="cpu")
    rounds = -(-steps // depth)
    assert sk.counts["h_block_fused_plain"] == rounds * 8 // (
        2 if mesh[2] == 1 else 1)
    _close(got.to_numpy(), want)
    _faces_exact(got.to_numpy(), want)
    one = solve(HeatConfig(backend="cuda", **base), initial=init,
                device="cpu")
    assert torch.equal(got.grid, one.grid)


@pytest.mark.parametrize("backend,jax_backend,depth", [
    ("torch", "jnp", 1), ("torch", "jnp", 3), ("cuda", "pallas", 4)])
def test_converge_matches_jax(backend, jax_backend, depth):
    kw = dict(nx=16, ny=16, nz=16, steps=400, converge=True,
              check_interval=6, eps=1e-3)
    rng = np.random.default_rng(7)
    init = rng.uniform(0, 1, (16, 16, 16)).astype(np.float32)
    want = jx.solve(jx.HeatConfig(backend=jax_backend, mesh_shape=(2, 2, 2),
                                  halo_depth=depth, **kw), initial=init)
    got = solve(HeatConfig(backend=backend, mesh_shape=(2, 2, 2),
                           halo_depth=depth, **kw), initial=init,
                device="cpu")
    assert (got.steps_run, got.converged) == (want.steps_run, want.converged)
    assert got.converged and got.steps_run < 400
    np.testing.assert_allclose(got.residual, want.residual, rtol=1e-4)
    _close(got.to_numpy(), want.to_numpy())
    one = solve(HeatConfig(backend=backend, **kw), initial=init,
                device="cpu")
    assert torch.equal(got.grid, one.grid)
    assert (got.steps_run, got.residual) == (one.steps_run, one.residual)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_schedules_and_kinds_bitwise_one_block(backend):
    base = dict(nx=16, ny=20, nz=24, steps=11, backend=backend)
    one = _port(**base)
    for mesh in ((2, 2, 2), (2, 4, 1), (1, 2, 2)):
        for mode in ("overlap", "phase"):
            for depth in (None, 1, 4):
                got = _port(mesh_shape=mesh, halo_overlap=mode,
                            halo_depth=depth, **base)
                assert torch.equal(got.grid, one.grid), (mesh, mode, depth)
    if backend == "cuda":
        for kind in ("H", "H-defer"):
            with tune.force("block_temporal_3d", kind):
                sk.reset_counts()
                got = _port(mesh_shape=(2, 2, 2), **base)
                assert torch.equal(got.grid, one.grid), kind
                plain = ("h_block_plain" if kind == "H"
                         else "h_band_fix_plain")
                assert sk.counts[plain] > 0


def test_explain_reports_the_sharded_3d_path():
    cfg = HeatConfig(nx=64, ny=64, nz=64, mesh_shape=(2, 2, 2),
                     backend="cuda")
    out = explain(cfg, device="cpu")
    assert out["halo_depth"] == "3 (auto)"
    assert out["block_shape"] == (32, 32, 32)
    assert out["decided_by"]["block_temporal_3d"]["choice"] == "H-fused"
    assert "kernel H-fused (monolithic round: heat_h_block_3d_fused" in \
        out["path"]
    # Blocks of 2 cap the auto depth.
    small = explain(HeatConfig(nx=4, ny=8, nz=8, mesh_shape=(2, 2, 2),
                               backend="cuda"), device="cpu")
    assert small["halo_depth"] == "2 (auto)"
    with tune.force("block_temporal_3d", "H-defer"):
        defer = explain(cfg, device="cpu")
    assert "overlapped round: deferred bulk heat_h_block_3d_fused" in \
        defer["path"] and "heat_h_band_fix_3d" in defer["path"]
    with tune.force("block_temporal_3d", "H"):
        assert "heat_h_block_3d on the assembled" in explain(
            cfg, device="cpu")["path"]
    torch_path = explain(HeatConfig(nx=16, ny=16, nz=16,
                                    mesh_shape=(2, 2, 2)), device="cpu")
    assert torch_path["halo_depth"] == "1 (auto)"
    assert "per-step 1-deep" in torch_path["path"]


def test_validation_mirrors_jax_and_refuses_what_is_not_ported():
    bad = dict(nx=30, ny=32, nz=32, mesh_shape=(4, 2, 1))
    with pytest.raises(ValueError) as jax_err:
        jx.HeatConfig(**bad).validate()
    with pytest.raises(ValueError) as port_err:
        HeatConfig(**bad).validate()
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="exceeds the smallest block"):
        HeatConfig(nx=16, ny=16, nz=8, mesh_shape=(2, 2, 2), halo_depth=5,
                   backend="torch").validate()
    with pytest.raises(ValueError, match="H kernels' compiled depths"):
        HeatConfig(nx=64, ny=64, nz=64, mesh_shape=(2, 2, 2), halo_depth=9,
                   backend="cuda").validate()
    HeatConfig(nx=64, ny=64, nz=64, mesh_shape=(2, 2, 2), halo_depth=9,
               backend="torch").validate()
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        HeatConfig(nx=8, ny=8, nz=8, mesh_shape=(2, 2, 2),
                   halo_overlap="pipeline").validate()
    with pytest.raises(ValueError, match="rank does not match"):
        HeatConfig(nx=8, ny=8, nz=8, mesh_shape=(2, 2)).validate()
    HeatConfig(nx=8, ny=8, nz=8, mesh_shape=(2, 1, 1)).validate()


def test_sharded_3d_cli_matches_one_block(tmp_path, capsys):
    from parallel_heat_tpu_torch.cli import main

    path = tmp_path / "mesh.npy"
    assert main(["--nx", "16", "--ny", "16", "--nz", "16", "--steps", "10",
                 "--mesh", "2,2,2", "--backend", "cuda", "--device", "cpu",
                 "--out", str(path)]) == 0
    assert "mesh (2, 2, 2)" in capsys.readouterr().out
    one = _port(nx=16, ny=16, nz=16, steps=10, backend="cuda")
    assert np.array_equal(np.load(path), one.to_numpy())


def test_from_jax_carries_a_3d_mesh():
    jcfg = jx.HeatConfig(nx=16, ny=16, nz=16, steps=7, backend="jnp",
                         mesh_shape=(2, 2, 2), halo_depth=3)
    spec = dataclasses.asdict(jcfg)
    spec["mesh_shape"] = list(spec["mesh_shape"])  # as JSON gives it
    port = PortConfig.from_dict({**spec, "backend": "torch",
                                 "device": "cpu"})
    assert port.mesh_shape == (2, 2, 2) and port.halo_depth == 3
    result = jx.solve(jcfg)
    cfg, blocks = from_jax(spec, np.asarray(result.grid), device="cpu")
    assert isinstance(blocks, list) and len(blocks) == 8
    assert tuple(blocks[0].shape) == (8, 8, 8)
    assert torch.equal(HeatMesh((2, 2, 2)).assemble(blocks),
                       torch.from_numpy(np.asarray(result.grid)))
    more = solve(cfg.replace(steps=5), initial=blocks, device="cpu")
    again = solve(cfg.replace(steps=5, mesh_shape=None),
                  initial=np.asarray(result.grid), device="cpu")
    assert torch.equal(more.grid, again.grid)


def test_init_block_matches_jax_and_solve_builds_blocks():
    import jax.numpy as jnp

    from parallel_heat_tpu.models.plate3d import HeatPlate3D as JaxPlate3D
    from parallel_heat_tpu_torch.models import HeatPlate3D

    shape, mesh_shape = (16, 20, 24), (2, 2, 2)
    mesh = HeatMesh(mesh_shape)
    bs = mesh.block_shape(shape)
    full = HeatPlate3D(*shape).init_grid("cpu")
    for b in range(mesh.size):
        got = HeatPlate3D(*shape).init_block("cpu", mesh.origin(b, bs), bs)
        want = np.asarray(JaxPlate3D(*shape).init_block(
            bs, mesh.coords(b), jnp.float32))
        np.testing.assert_array_equal(got.numpy(), want)
        o = mesh.origin(b, bs)
        assert torch.equal(got, full[tuple(slice(a, a + n)
                                           for a, n in zip(o, bs))])
    zero = solve(HeatConfig(steps=0, mesh_shape=mesh_shape, **_dims(shape)),
                 device="cpu")
    assert torch.equal(zero.grid, full)


def test_mesh_helpers_on_a_3_axis_mesh():
    mesh = HeatMesh((2, 3, 2))
    g = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    blocks = mesh.split(g)
    assert mesh.coords(7) == (1, 0, 1) and mesh.index((1, 0, 1)) == 7
    assert mesh.origin(7, (2, 2, 4)) == (2, 0, 4)
    assert torch.equal(blocks[7], g[2:4, 0:2, 4:8])
    assert torch.equal(mesh.assemble(blocks), g)
    assert mesh.neighbour(7, 0, -1) == 1 and mesh.neighbour(7, 0, 1) is None
    assert mesh.neighbour(7, 2, -1) == 6 and mesh.neighbour(7, 1, 1) == 9
