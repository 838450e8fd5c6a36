"""Runtime configuration of one simulation — the port's ``HeatConfig``.

The field names, defaults and JSON spec are those of
``parallel_heat_tpu.config.HeatConfig`` for every field this package
implements, so one spec runs on either package. What differs:

- ``backend`` has this package's own vocabulary: ``"cuda"`` (the
  hand-written Hopper kernels), ``"torch"`` (the textbook stencil in
  plain PyTorch) or ``"auto"`` (cuda on a GPU device, torch on the CPU);
- ``device`` is new: where the grid lives and the steps run
  (``"cuda"`` means ``cuda:0``; ``"cpu"`` must be asked for);
- ``dtype`` takes the JAX package's three storage dtypes, and
  ``accumulate`` its two sub-float32 modes, with its rules
  (``SEMANTICS.md`` "Precision"): arithmetic is float32 at every dtype;
  ``"storage"`` rounds the state to the dtype after every step;
  ``"f32chunk"`` (bfloat16, 2D, one block, explicit) carries float32
  through chunks of :data:`~.ops.stencil.F32CHUNK_DEPTH` steps. bfloat16
  and float64 run on one block, 2D or 3D: the explicit scheme, ensembles,
  and the implicit schemes in 2D (which widen the state to float32 once a
  step and round the interior to storage once); on meshes the explicit
  scheme, float64 in 2D and 3D, bfloat16 in 2D. The explicit scheme runs
  float64 on the torch route only (the stencil kernels store float32 and
  bfloat16): ``backend="cuda"`` with float64 is refused there, and
  ``"auto"`` takes the torch route for float64 on the card too; the
  implicit schemes take ``backend="cuda"`` at float64, their transfer
  kernels seeing float32 levels only. On a 3D mesh bfloat16 is refused,
  naming the ROADMAP.md item;
- ``nz`` set makes the run 3D (7-point stencil, coefficients
  ``cx, cy, cz``), as in the JAX package;
- ``scheme`` and the ``mg_*`` knobs select the implicit integrators
  (backward Euler, Crank-Nicolson: one multigrid V-cycle solve per
  step, ``ops/multigrid.py``) exactly as in the JAX package;
- ``mesh_shape``, ``overlap``, ``halo_depth`` and ``halo_overlap`` cut a
  2D or 3D explicit run over a mesh of blocks (``parallel/``), all on
  the run's one device in this slice. ``halo_depth`` auto resolves to
  kernel G's depth (2D) or kernel H's (3D, capped at the smallest block
  extent) under ``backend="cuda"`` and to 1 otherwise; an explicit depth
  past what the G or H kernels take is refused under ``"cuda"``. An
  implicit scheme on a mesh and the ``"pipeline"`` schedule are
  refused, naming the ROADMAP.md item;
- ``guard_interval``, ``diag_interval`` and ``pipeline_depth`` configure
  the observers of ``solver.solve_stream`` and ``solve`` (the runtime
  guard, the grid diagnostics, the stream's dispatch depth) with the JAX
  package's defaults and rules; they never change a bit of the grid;
- the field of the JAX package that this one does not implement yet
  (the partitioned V-cycle's ``mg_partition``) is rejected by
  :meth:`HeatConfig.from_dict` when they are set away from their
  defaults, instead of being dropped silently.

:class:`EnsembleConfig` is the JAX package's, field for field.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

_VALID_DTYPES = ("float32", "bfloat16", "float64")
_VALID_ACCUMULATE = ("storage", "f32chunk")
_VALID_BACKENDS = ("auto", "cuda", "torch")
# "explicit" is the forward-Euler Jacobi update, whose step is capped by
# the stability bound; the implicit schemes solve (I - theta*L) u' = b
# every step and are unconditionally stable.
_VALID_SCHEMES = ("explicit", "backward_euler", "crank_nicolson")
_VALID_HALO_OVERLAP = (None, "auto", "phase", "overlap", "pipeline")

# --- cache-key partition ---------------------------------------------------
#
# Every HeatConfig field is classified exactly once, as in the JAX
# package. SEMANTIC fields select what the simulation computes or which
# program computes it; OBSERVATION_ONLY fields configure observers and
# the stream's dispatch order, which never change a bit of the grid
# (``solver._observer_free`` resets them before any loop is built).
# ``device`` is semantic: it selects the kernel or its plain version.
SEMANTIC_FIELDS = (
    "nx", "ny", "nz", "cx", "cy", "cz",
    "steps", "converge", "eps", "check_interval",
    "dtype", "backend", "device",
    "mesh_shape", "overlap", "halo_depth", "halo_overlap", "accumulate",
    "scheme", "mg_tol", "mg_cycles", "mg_smooth", "mg_levels",
)
OBSERVATION_ONLY_FIELDS = ("guard_interval", "diag_interval",
                           "pipeline_depth")

# Fields of the JAX package's HeatConfig that this package does not
# implement yet, with the JAX defaults. A spec that leaves them at these
# values means the same run on both packages; any other value names a
# feature this package would silently drop, so from_dict refuses it.
JAX_ONLY_DEFAULTS = {
    "mg_partition": "auto",
}

# --- ensemble cache-key partition -----------------------------------------
#
# The same discipline for EnsembleConfig: SEMANTIC fields shape what the
# batched member programs compute; ORCHESTRATION fields shape only the
# host's dispatch schedule (windows per dispatch, when the live batch is
# compacted) and cannot move a member's trajectory.
ENSEMBLE_SEMANTIC_FIELDS = ("members",)
ENSEMBLE_ORCHESTRATION_FIELDS = ("compact_threshold", "window_rounds")


@dataclass(frozen=True)
class EnsembleConfig:
    """Configuration of one batched ensemble run (``ensemble/``).

    ``members`` is B, the extent of the leading member axis: B
    independent grids of one :class:`HeatConfig` run as one program. The
    other knobs are orchestration only: they move dispatch boundaries
    and compaction points, never a member's arithmetic.
    """

    members: int = 1

    # Converge mode: when the live fraction of the current batch drops
    # strictly below this at a dispatch boundary, finished members are
    # parked and the live ones packed into a smaller batch. None = never.
    compact_threshold: Optional[float] = 0.5

    # Converge mode: check windows per dispatch, i.e. between two reads
    # of the per-member verdicts on the host. A member freezes at its
    # own converging window however many windows share a dispatch.
    window_rounds: int = 4

    def validate(self) -> "EnsembleConfig":
        if self.members < 1:
            raise ValueError(
                f"ensemble members must be >= 1, got {self.members}")
        if self.compact_threshold is not None and not (
                0.0 < self.compact_threshold <= 1.0):
            raise ValueError(
                f"compact_threshold must be in (0, 1] (or None to "
                f"disable compaction), got {self.compact_threshold}")
        if self.window_rounds < 1:
            raise ValueError(
                f"window_rounds must be >= 1, got {self.window_rounds}")
        return self

    def orchestration_free(self) -> "EnsembleConfig":
        """Every orchestration-only field reset to its default."""
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        kw = {name: defaults[name] for name in ENSEMBLE_ORCHESTRATION_FIELDS
              if getattr(self, name) != defaults[name]}
        return self.replace(**kw) if kw else self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "EnsembleConfig":
        return cls(**json.loads(s)).validate()

    def replace(self, **kw) -> "EnsembleConfig":
        return dataclasses.replace(self, **kw)


def _mesh_hint(config) -> str:
    """The divisibility error's hint: the mesh shapes of the same device
    count that divide the grid, or the nearest divisible grid sizes."""
    from parallel_heat_tpu_torch.parallel.mesh import divisible_factorizations

    mesh = config.mesh_or_unit()
    n_dev = 1
    for d in mesh:
        n_dev *= d
    valid = divisible_factorizations(n_dev, config.shape)
    if valid:
        return (f"; valid {n_dev}-device mesh shapes for this grid: "
                + ", ".join(str(v) for v in valid[:8])
                + (" ..." if len(valid) > 8 else ""))
    near = []
    for n, d, name in zip(config.shape, mesh, "xyz"):
        if n % d != 0:
            lo, hi = (n // d) * d, (n // d + 1) * d
            near.append(f"n{name}={hi}" if lo == 0
                        else f"n{name}={lo} or {hi}")
    return (f"; no factorization of {n_dev} devices divides this grid — "
            f"nearest divisible sizes: " + ", ".join(near))


def multigrid_level_shapes(shape, mg_levels: Optional[int] = None,
                           min_interior: int = 3) -> list:
    """The geometric-multigrid hierarchy of a 2D grid ``shape`` (cells
    including the Dirichlet ring): ``[(nx0, ny0), (nx1, ny1), ...]``
    finest first, each level's interior the floor-half of the previous
    (``m -> m // 2``, the vertex map ``fine = 2*coarse + 1``, defined for
    any interior size), until an interior would drop below
    ``min_interior`` or ``mg_levels`` levels exist. The one source of the
    hierarchy for the V-cycle and ``solver.explain``."""
    nx, ny = int(shape[0]), int(shape[1])
    levels = [(nx, ny)]
    while mg_levels is None or len(levels) < mg_levels:
        mi, ni = levels[-1][0] - 2, levels[-1][1] - 2
        mc, nc = mi // 2, ni // 2
        if mc < min_interior or nc < min_interior:
            break
        levels.append((mc + 2, nc + 2))
    return levels


@dataclass(frozen=True)
class HeatConfig:
    """Full runtime configuration of one 2D or 3D simulation.

    Defaults mirror the JAX package (and through it the reference's
    in-source macros: ``NXPROB=NYPROB=20``, ``STEP=20``, ``cx=cy=0.1``).
    """

    # Grid extent (cells including the fixed Dirichlet boundary).
    nx: int = 20
    ny: int = 20
    nz: Optional[int] = None  # set for the 3D 7-point stencil

    # Diffusion coefficients (cz is read only in 3D).
    cx: float = 0.1
    cy: float = 0.1
    cz: float = 0.1

    # Stepping. `steps` is the exact step count in fixed mode and the
    # upper bound in converge mode.
    steps: int = 100
    converge: bool = False
    eps: float = 1e-3
    check_interval: int = 20

    # Storage dtype ("float32", "bfloat16", "float64"); arithmetic is
    # float32 at every dtype.
    dtype: str = "float32"

    # "cuda" (Hopper kernels), "torch" (textbook stencil) or "auto".
    backend: str = "auto"

    # Where the grid lives: "cuda" (= cuda:0), "cuda:N" or "cpu".
    device: str = "cuda"

    # Device mesh (dx, dy) or (dx, dy, dz) cutting the grid into blocks,
    # or None for one block. Every block lives on `device` in this slice.
    mesh_shape: Optional[Tuple[int, ...]] = None
    # The per-step (halo_depth 1) torch path's interior/edge split: the
    # block's interior is computed from the block alone.
    overlap: bool = True
    # Steps per halo exchange: K-deep halos once per K steps. None =
    # auto: hopper_params.g_k_default under backend "cuda" on a mesh
    # whose blocks hold it, else 1.
    halo_depth: Optional[int] = None
    # Schedule of the K-deep rounds: "phase" (both exchange phases, then
    # the kernel), "overlap" (the bulk between the phases, then the
    # bands) or None/"auto" (= "overlap"). Bitwise equal results.
    halo_overlap: Optional[str] = None

    # Sub-float32 accumulation (SEMANTICS.md "Precision"): "storage" rounds
    # the state to the storage dtype after every step, so a K-step kernel
    # is bitwise K single steps; "f32chunk" (bfloat16, 2D, one block)
    # carries float32 through chunks of ops.stencil.F32CHUNK_DEPTH steps
    # and rounds once a chunk (and once after a remainder chunk).
    accumulate: str = "storage"

    # Time integrator: "explicit", or "backward_euler" /
    # "crank_nicolson", which solve (I - theta*L) u' = b every step with
    # a geometric-multigrid V-cycle (2D only) and take coefficients far
    # past the explicit bound.
    scheme: str = "explicit"
    # Implicit-solve knobs; they must stay at their defaults for
    # scheme="explicit". Cycles stop when
    # max|b - A u| <= mg_tol * max|b| or after mg_cycles cycles;
    # mg_smooth weighted-Jacobi sweeps before and after each coarse
    # correction; mg_levels caps the hierarchy (None: coarsen fully).
    mg_tol: float = 1e-3
    mg_cycles: int = 50
    mg_smooth: int = 1
    mg_levels: Optional[int] = None

    # The runtime guard: steps between isfinite-all checks of the grid
    # (None = off). `solve_stream` checks at the first chunk boundary
    # at-or-after each multiple and at its last chunk, `solve` the final
    # grid once. Observation-only: it reads the grid, never writes it.
    guard_interval: Optional[int] = None
    # Grid diagnostics: steps between grid-stats samples (min, max, total
    # heat, L2/L-inf of the update since the previous sample;
    # `solver.grid_stats`), on the guard's boundary rule. None = off.
    # Observation-only; costs one retained grid copy (the baseline).
    diag_interval: Optional[int] = None
    # `solve_stream`'s dispatch depth: chunks in flight on the card at
    # once. None = auto: 2 for fixed-step runs on the card, else 1. A
    # depth > 1 with converge=True is an error (a converge chunk's
    # verdict must be read before the next chunk is dispatched).
    # Dispatch order only: grids and observations equal depth 1's.
    pipeline_depth: Optional[int] = None

    def __post_init__(self):
        # A JSON spec gives the mesh as a list; keep the config hashable.
        if self.mesh_shape is not None:
            object.__setattr__(self, "mesh_shape",
                               tuple(int(d) for d in self.mesh_shape))

    @property
    def ndim(self) -> int:
        return 3 if self.nz is not None else 2

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.ndim == 3:
            return (self.nx, self.ny, self.nz)
        return (self.nx, self.ny)

    @property
    def coefficients(self) -> Tuple[float, ...]:
        if self.ndim == 3:
            return (self.cx, self.cy, self.cz)
        return (self.cx, self.cy)

    def mesh_or_unit(self) -> Tuple[int, ...]:
        """The mesh shape, the all-ones mesh when none is set."""
        if self.mesh_shape is None:
            return (1,) * self.ndim
        return tuple(self.mesh_shape)

    def is_sharded(self) -> bool:
        return any(d > 1 for d in self.mesh_or_unit())

    def block_shape(self) -> Tuple[int, ...]:
        """The extent of one block of the mesh."""
        return tuple(n // d for n, d in zip(self.shape, self.mesh_or_unit()))

    def stability_margin(self) -> float:
        """``1/2 - (cx + cy)``: negative means the explicit scheme
        diverges."""
        return 0.5 - sum(self.coefficients)

    def validate(self) -> "HeatConfig":
        if self.scheme == "explicit" and self.stability_margin() < 0.0:
            # Warn, never error: instability can be the thing studied.
            # The implicit schemes are unconditionally stable.
            warnings.warn(
                f"coefficient sum {sum(self.coefficients):g} exceeds the "
                f"stability bound 1/2 — the explicit scheme will diverge "
                f"(values blow up to inf); to take steps this large, "
                f"switch to the implicit integrator: "
                f"scheme='backward_euler' (--scheme backward_euler), "
                f"which is unconditionally stable",
                RuntimeWarning,
            )
        if self.nx < 3 or self.ny < 3 or (self.nz is not None
                                          and self.nz < 3):
            raise ValueError(
                f"grid must be at least 3 cells per axis, got {self.shape}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if self.converge and self.check_interval < 1:
            raise ValueError(
                f"check_interval must be >= 1, got {self.check_interval}")
        if self.converge and self.eps <= 0.0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if self.dtype not in _VALID_DTYPES:
            raise ValueError(
                f"dtype must be one of {_VALID_DTYPES}, got {self.dtype!r} "
                f"(float16 is not a storage dtype of the JAX package "
                f"either)")
        if self.accumulate not in _VALID_ACCUMULATE:
            raise ValueError(
                f"accumulate must be 'storage' or 'f32chunk', got "
                f"{self.accumulate!r}")
        if self.backend not in _VALID_BACKENDS:
            raise ValueError(
                f"backend must be one of {_VALID_BACKENDS}, got "
                f"{self.backend!r}")
        dev = self.device
        if not (dev in ("cpu", "cuda")
                or (dev.startswith("cuda:") and dev[5:].isdigit())):
            raise ValueError(
                f"device must be 'cuda', 'cuda:N' or 'cpu', got {dev!r}")
        if self.scheme not in _VALID_SCHEMES:
            raise ValueError(
                f"scheme must be one of {_VALID_SCHEMES}, got "
                f"{self.scheme!r}")
        if self.mg_tol <= 0.0:
            raise ValueError(f"mg_tol must be > 0, got {self.mg_tol}")
        if self.mg_cycles < 1:
            raise ValueError(
                f"mg_cycles must be >= 1, got {self.mg_cycles}")
        if self.mg_smooth < 1:
            raise ValueError(
                f"mg_smooth must be >= 1, got {self.mg_smooth}")
        if self.mg_levels is not None and self.mg_levels < 1:
            raise ValueError(
                f"mg_levels must be >= 1 (or None for full "
                f"coarsening), got {self.mg_levels}")
        if self.guard_interval is not None and self.guard_interval < 1:
            raise ValueError(
                f"guard_interval must be >= 1 (or None to disable the "
                f"runtime guard), got {self.guard_interval}")
        if self.diag_interval is not None and self.diag_interval < 1:
            raise ValueError(
                f"diag_interval must be >= 1 (or None to disable grid "
                f"diagnostics), got {self.diag_interval}")
        if self.pipeline_depth is not None:
            if self.pipeline_depth < 1:
                raise ValueError(
                    f"pipeline_depth must be >= 1 (or None for auto), "
                    f"got {self.pipeline_depth}")
            if self.pipeline_depth > 1 and self.converge:
                raise ValueError(
                    "pipeline_depth > 1 is fixed-step only: converge "
                    "mode must read each chunk's on-device convergence "
                    "verdict before dispatching the next chunk, so "
                    "dispatch-ahead would speculate past the stopping "
                    "point (use pipeline_depth=1 or drop the flag — "
                    "auto already resolves converge runs to 1)")
        self._validate_mesh()
        if self.scheme == "explicit":
            # Inert knobs stay at their defaults: a loud decline, not a
            # silent no-op.
            defaults = HeatConfig()
            off = [n for n in ("mg_tol", "mg_cycles", "mg_smooth",
                               "mg_levels")
                   if getattr(self, n) != getattr(defaults, n)]
            if off:
                raise ValueError(
                    f"{', '.join(off)} only apply to the implicit "
                    f"schemes (scheme='backward_euler' or "
                    f"'crank_nicolson'); scheme='explicit' takes no "
                    f"multigrid knobs")
        else:
            if self.ndim != 2:
                raise ValueError(
                    f"scheme={self.scheme!r} is 2D-only in this "
                    f"build: the 3D multigrid transfer operators are "
                    f"not yet built (the 5-point V-cycle is — use "
                    f"nz=None)")
            if self.accumulate != "storage":
                raise ValueError(
                    "accumulate='f32chunk' applies to the explicit "
                    "temporal kernels only; the implicit V-cycle "
                    "already carries float32 through every step solve "
                    "and rounds to storage once per step")
        self._validate_precision()
        return self

    def _validate_precision(self) -> None:
        """The JAX package's f32chunk rules (same messages), then this
        package's: bfloat16 runs on one block (2D or 3D) and on 2D meshes,
        not yet on 3D meshes (the H family's bfloat16 forms); float64 runs
        everywhere, an explicit float64 run on the torch route only."""
        if self.accumulate == "f32chunk":
            if self.dtype != "bfloat16":
                raise ValueError(
                    f"accumulate='f32chunk' only applies to sub-f32 "
                    f"storage dtypes (got {self.dtype}: f32+ storage "
                    f"already carries full f32 state — SEMANTICS.md)")
            if self.ndim != 2:
                raise ValueError(
                    "accumulate='f32chunk' is 2D-only (the priced "
                    "config-4 capability); 3D chunked accumulation is "
                    "not yet built")
            if self.is_sharded():
                raise ValueError(
                    "accumulate='f32chunk' is single-device only: "
                    "sharded temporal rounds exchange storage-dtype "
                    "halos, so the chunk carry cannot stay f32 across "
                    "the mesh")
        if self.dtype == "float32":
            return
        if (self.dtype == "bfloat16" and self.is_sharded()
                and self.ndim == 3):
            raise ValueError(
                "dtype='bfloat16' runs on one block and on 2D meshes in "
                "this package for now, not on a 3D mesh: ROADMAP.md queue 2 "
                "item 24.4 (the bfloat16 forms of H, H-fused and the 3D "
                "band)")
        if (self.dtype == "float64" and self.backend == "cuda"
                and self.scheme == "explicit"):
            raise ValueError(
                "backend='cuda' does not take dtype='float64' for the "
                "explicit scheme: the stencil kernels store float32 and "
                "bfloat16 (arithmetic is float32 at every dtype); float64 "
                "runs the plain torch route (backend='torch' or 'auto', on "
                "the card or the CPU). The implicit schemes take it: their "
                "transfer kernels see float32 levels only")

    def _validate_mesh(self) -> None:
        """The mesh fields: the JAX package's rules, the cuda depth rule,
        and this slice's refusals."""
        mesh = self.mesh_or_unit()
        if len(mesh) != self.ndim:
            raise ValueError(f"mesh_shape {mesh} rank does not match grid "
                             f"rank {self.ndim}")
        if any(d < 1 for d in mesh):
            raise ValueError(f"mesh_shape entries must be >= 1, got {mesh}")
        for n, d, name in zip(self.shape, mesh, "xyz"):
            if n % d != 0:
                raise ValueError(f"grid n{name}={n} is not divisible by "
                                 f"mesh d{name}={d}" + _mesh_hint(self))
        if self.halo_depth is not None and self.halo_depth < 1:
            raise ValueError(f"halo_depth must be >= 1 (or None for auto), "
                             f"got {self.halo_depth}")
        if self.halo_overlap not in _VALID_HALO_OVERLAP:
            raise ValueError(f"halo_overlap must be one of 'auto'/None, "
                             f"'phase', 'overlap', 'pipeline', got "
                             f"{self.halo_overlap!r}")
        if self.scheme != "explicit":
            # The JAX package's inert-knob rules for the implicit schemes.
            if self.halo_depth not in (None, 1):
                raise ValueError(
                    f"halo_depth={self.halo_depth} is an explicit-scheme "
                    f"exchange schedule (K steps per round); it does not "
                    f"apply to scheme={self.scheme!r} — drop the flag")
            if self.halo_overlap not in (None, "auto"):
                raise ValueError(
                    f"halo_overlap={self.halo_overlap!r} schedules the "
                    f"explicit temporal rounds; it does not apply to "
                    f"scheme={self.scheme!r} — drop the flag")
            if not self.overlap:
                raise ValueError(
                    f"overlap=False schedules the explicit per-step "
                    f"interior/edge split; it does not apply to "
                    f"scheme={self.scheme!r} — drop the flag")
        if not self.is_sharded():
            return
        if self.scheme != "explicit":
            raise ValueError(
                f"scheme={self.scheme!r} on a mesh is not ported yet "
                f"(ROADMAP.md queue 1 item 9, sharded implicit); run it on "
                f"one block (mesh_shape=None)")
        if self.halo_overlap == "pipeline":
            raise NotImplementedError(
                "halo_overlap='pipeline' (the double-buffered edge-strip "
                "rounds, _panel_strips_2d) is not ported yet: ROADMAP.md "
                "queue 1 item 8; use 'overlap' or 'phase' (bitwise the "
                "same results)")
        if self.halo_depth is not None and self.halo_depth > 1:
            bmin = min(self.block_shape())
            if self.halo_depth > bmin:
                # Deeper than a block: a neighbour owns too few cells.
                raise ValueError(f"halo_depth={self.halo_depth} exceeds the "
                                 f"smallest block extent {bmin}")
            if self.backend == "cuda":
                from parallel_heat_tpu_torch.ops.hopper_params import params

                p = params()
                if self.ndim == 2:
                    k_max, why = p.g_k_max(), (f"the G kernels' shared-memory "
                                               f"bound at tile {p.g_tile}")
                else:
                    k_max, why = p.h_k_max(), (
                        f"the H kernels' compiled depths and shared memory "
                        f"at block {p.h_block}, {p.h_rows} rows a thread")
                if self.halo_depth > k_max:
                    raise ValueError(
                        f"backend='cuda' takes halo_depth <= {k_max} "
                        f"({why}), got {self.halo_depth}; deeper rounds run "
                        f"under backend='torch'")

    # --- (de)serialization -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "HeatConfig":
        """Build from a spec dict, refusing JAX-only fields that are set
        away from their defaults (a spec this package would run
        differently) and unknown fields."""
        d = dict(d)
        off = []
        for name, default in JAX_ONLY_DEFAULTS.items():
            if name in d:
                value = d.pop(name)
                if value != default:
                    off.append(f"{name}={value!r}")
        if off:
            raise ValueError(
                f"{', '.join(off)}: not implemented in "
                f"parallel_heat_tpu_torch yet (see ROADMAP.md queue 1)")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown HeatConfig fields: {unknown}")
        return cls(**d).validate()

    @classmethod
    def from_json(cls, s: str) -> "HeatConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "HeatConfig":
        return dataclasses.replace(self, **kw)
