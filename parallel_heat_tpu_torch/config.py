"""Runtime configuration of one simulation — the port's ``HeatConfig``.

The field names, defaults and JSON spec are those of
``parallel_heat_tpu.config.HeatConfig`` for every field this package
implements, so one spec runs on either package. What differs:

- ``backend`` has this package's own vocabulary: ``"cuda"`` (the
  hand-written Hopper kernels), ``"torch"`` (the textbook stencil in
  plain PyTorch) or ``"auto"`` (cuda on a GPU device, torch on the CPU);
- ``device`` is new: where the grid lives and the steps run
  (``"cuda"`` means ``cuda:0``; ``"cpu"`` must be asked for);
- ``dtype`` accepts only ``"float32"`` in this slice;
- ``nz`` set makes the run 3D (7-point stencil, coefficients
  ``cx, cy, cz``), as in the JAX package;
- the fields of the JAX package that this one does not implement yet
  (meshes, implicit schemes, observers) are rejected by
  :meth:`HeatConfig.from_dict` when they are set away from their
  defaults, instead of being dropped silently.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

_VALID_DTYPES = ("float32",)
_VALID_BACKENDS = ("auto", "cuda", "torch")

# --- cache-key partition ---------------------------------------------------
#
# Every HeatConfig field is classified exactly once, as in the JAX
# package. SEMANTIC fields select what the simulation computes or which
# program computes it; OBSERVATION_ONLY fields would configure observers
# that never change a bit of the grid (none exist in this slice yet).
# ``device`` is semantic: it selects the kernel or its plain version.
SEMANTIC_FIELDS = (
    "nx", "ny", "nz", "cx", "cy", "cz",
    "steps", "converge", "eps", "check_interval",
    "dtype", "backend", "device",
)
OBSERVATION_ONLY_FIELDS: Tuple[str, ...] = ()

# Fields of the JAX package's HeatConfig that this package does not
# implement yet, with the JAX defaults. A spec that leaves them at these
# values means the same run on both packages; any other value names a
# feature this package would silently drop, so from_dict refuses it.
JAX_ONLY_DEFAULTS = {
    "mesh_shape": None,
    "overlap": True,
    "halo_depth": None,
    "halo_overlap": None,
    "accumulate": "storage",
    "scheme": "explicit",
    "mg_tol": 1e-3,
    "mg_cycles": 50,
    "mg_smooth": 1,
    "mg_levels": None,
    "mg_partition": "auto",
    "guard_interval": None,
    "diag_interval": None,
    "pipeline_depth": None,
}


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

    # Storage dtype; arithmetic is float32 either way.
    dtype: str = "float32"

    # "cuda" (Hopper kernels), "torch" (textbook stencil) or "auto".
    backend: str = "auto"

    # Where the grid lives: "cuda" (= cuda:0), "cuda:N" or "cpu".
    device: str = "cuda"

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

    def stability_margin(self) -> float:
        """``1/2 - (cx + cy)``: negative means the explicit scheme
        diverges."""
        return 0.5 - sum(self.coefficients)

    def validate(self) -> "HeatConfig":
        if self.stability_margin() < 0.0:
            # Warn, never error: instability can be the thing studied.
            warnings.warn(
                f"coefficient sum {sum(self.coefficients):g} exceeds the "
                f"stability bound 1/2 — the explicit scheme will diverge "
                f"(values blow up to inf)",
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
                f"dtype must be 'float32' in this package for now, got "
                f"{self.dtype!r}: bfloat16 and float64 storage are "
                f"ROADMAP queue 1 item 3 (precision)")
        if self.backend not in _VALID_BACKENDS:
            raise ValueError(
                f"backend must be one of {_VALID_BACKENDS}, got "
                f"{self.backend!r}")
        dev = self.device
        if not (dev in ("cpu", "cuda")
                or (dev.startswith("cuda:") and dev[5:].isdigit())):
            raise ValueError(
                f"device must be 'cuda', 'cuda:N' or 'cpu', got {dev!r}")
        return self

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
                f"parallel_heat_tpu_torch yet (see ROADMAP.md queue 1); "
                f"only the single-device explicit float32 path (2D or "
                f"3D) is")
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
