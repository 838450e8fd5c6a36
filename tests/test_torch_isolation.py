"""The PyTorch port stands alone: it imports nothing of JAX and nothing
of the JAX package ``parallel_heat_tpu``, and neither does
``chip_smoke.py``. Checked twice: statically, by walking every import
statement, and live, in a subprocess where importing ``jax`` or
``parallel_heat_tpu`` fails."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "parallel_heat_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "parallel_heat_tpu")


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.name for f in files}
    assert {"batched.py", "multigrid.py", "engine.py", "mesh.py", "halo.py",
            "temporal.py", "stencil_kernels_block.py", "halo3d.py",
            "temporal3d.py", "stencil_kernels_block_3d.py",
            "kernel_probe.py", "vpu_roofline.py", "probe_temporal.py",
            "ab_temporal.py", "probing.py", "probe_split_copy.py",
            "probe_gather_dma.py", "probe_sweep_width.py",
            "probe_store_align.py"} <= names
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {mod}"
           for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


_BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "parallel_heat_tpu"):
    sys.modules[name] = None  # any import of these now raises
import torch
import parallel_heat_tpu_torch as pt
import chip_smoke  # noqa: F401
res = pt.solve(pt.HeatConfig(nx=32, ny=32, steps=40, backend="cuda"),
               device="cpu")
assert res.steps_run == 40 and tuple(res.grid.shape) == (32, 32)
# The ensemble engine (kernel M's module) and the implicit V-cycle (the
# transfer kernels' module), each through its entry point.
from parallel_heat_tpu_torch.ensemble import engine
from parallel_heat_tpu_torch.ops import batched, multigrid
ens = pt.EnsembleSolver(pt.HeatConfig(nx=16, ny=16, steps=9, backend="cuda",
                                      device="cpu"), 3)
assert ens.path == "M" and ens.solve().members == 3
imp = pt.solve(pt.HeatConfig(nx=18, ny=18, cx=22.5, cy=22.5, steps=2,
                             scheme="backward_euler", backend="cuda"),
               device="cpu")
assert imp.steps_run == 2 and multigrid.stats["steps"] == 2
# The sharded path (the G kernels' module and the mesh package), through
# solve().
from parallel_heat_tpu_torch.ops import stencil_kernels_block
from parallel_heat_tpu_torch.parallel import halo, mesh, temporal
shard = pt.solve(pt.HeatConfig(nx=32, ny=32, steps=40, backend="cuda",
                               mesh_shape=(2, 2)), device="cpu")
assert torch.equal(shard.grid, res.grid)
# The sharded 3D path (the H kernels' module), through solve().
from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d
from parallel_heat_tpu_torch.parallel import halo3d, temporal3d
cfg3 = pt.HeatConfig(nx=12, ny=12, nz=12, steps=7, backend="cuda")
shard3 = pt.solve(cfg3.replace(mesh_shape=(2, 2, 2)), device="cpu")
assert torch.equal(shard3.grid, pt.solve(cfg3, device="cpu").grid)
# The measurement probes (tools/), each through a function it computes.
from parallel_heat_tpu_torch.tools import (ab_temporal, kernel_probe,
                                           probe_temporal, vpu_roofline)
g = torch.rand(20, 24)
assert torch.equal(probe_temporal.probe_steps("full", g, torch.empty_like(g),
                                              4, cx=0.1, cy=0.1),
                   ab_temporal.ab_steps("rowcopy", g, torch.empty_like(g), 4,
                                        cx=0.1, cy=0.1))
st = torch.rand(2, 20, 32)
vpu_roofline.sweep("stencil", st, torch.empty_like(st), 3)
from parallel_heat_tpu_torch.tools import (probe_gather_dma, probe_split_copy,
                                           probe_store_align,
                                           probe_sweep_width)
sp = torch.empty_like(g)
probe_split_copy.split_steps("rows8", g, sp, 6, cx=0.1, cy=0.1)
elem, _ = probe_gather_dma.gather_dma("dense", torch.rand(48, 64), rows=16,
                                      k=4, cols=32, stride=28)
sa, sb = torch.empty_like(st), torch.empty_like(st)
probe_sweep_width.sweep(st, sa, 4, lo=2, rows=16)
probe_store_align.align_sweep(st, sb, 4, lo=2, rows=16)
assert torch.equal(sa, sb) and elem.shape == ()
assert not any(m.split(".")[0] in ("jax", "jaxlib")
               for m, v in sys.modules.items() if v is not None)
print("ok", float(res.grid.sum()))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_package_runs_with_jax_unimportable():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok ")


def test_chip_smoke_refuses_to_run_without_a_card_or_the_repo(tmp_path):
    # Alone in a directory, without the package beside it, and on a
    # machine without CUDA, the smoke test must fail and print no result.
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
