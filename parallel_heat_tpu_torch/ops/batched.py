"""Kernel M: the member-batched resident kernel of the ensemble engine.

The port of ``parallel_heat_tpu/ops/batched.py``. B independent member
grids of one config, stacked on a leading member axis, advance K steps
in ONE launch of ``heat_m_ensemble`` (csrc/heat_m_ensemble.cu), the
counterpart of ``heat_m_ens_vmem_multistep``: kernel A's resident
multi-step for each member, with the member's own last-step residual.

Parity contract: a member of a launch is bitwise a launch of kernel A
(:func:`~.stencil_kernels.resident_steps`) on that member alone, with
the same grid and residual; the CUDA source steps with A's own device
code. :func:`pick_ensemble_2d` admits M where the solo picker takes A
for the member shape and storage dtype, under ``accumulate="storage"``,
and M's own launch plan (:meth:`~.hopper_params.HopperParams.m_plan`)
fits the card, so the batched and the solo path compute the same thing
wherever M runs.

Storage precision: M takes float32 and bfloat16 stacks
(``heat_m_ensemble_bf16``, the counterpart of the JAX builder at
``dtype_name="bfloat16"``): every level of every member rounds to
bfloat16 as A's bfloat16 form rounds it, the residual is the last step's
float32 update against the float32 of the level it read. The chains are
held on the card by ``chip_smoke.py``: its ``kernels_ens`` phase holds a
member of a float32 launch against A on it alone, and its
``kernels_bf16`` phase a member of a bfloat16 launch against
``heat_a_resident_bf16`` on it alone, and A's bfloat16 form against K
launches of ``heat_b_step_bf16``.

:func:`ensemble_steps` takes its plain version only because the tensor it
was given lies on the CPU. For a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32, combine_2d


def pick_ensemble_2d(shape, dtype="float32", accumulate="storage") -> str:
    """The batched-kernel decision: ``"M"`` under ``accumulate="storage"``
    when the member shape at storage ``dtype`` is one the solo picker
    gives kernel A and M has a launch plan for it (a member fits resident
    under M's own tiling, whatever the number of members), ``"vmap"``
    (the general path: the solo torch multistep over a leading member
    axis) otherwise: under ``"f32chunk"`` (the solo run takes E or E-uni,
    which have no batched twin) and at float64 (the torch route). The JAX
    rule (``batched.py`` pick_ensemble_2d). One decision site, shared by
    the ensemble engine and ``solver.explain``.

    A choice pinned with ``tune.force("ensemble_2d", ...)`` may demote M
    to vmap freely; it promotes to M only where M admits, and warns
    otherwise."""
    admits = (accumulate == "storage" and len(shape) == 2
              and sk.pick_single_2d(shape, dtype, accumulate)[0] == "A"
              and params().m_plan(1, tuple(shape)) is not None)
    choice = tune.forced("ensemble_2d")
    if choice is not None:
        if choice == "vmap" or admits:
            return choice
        warnings.warn(f"tune[ensemble_2d]: forced choice 'M' inadmissible "
                      f"at {tuple(shape)}; using the default",
                      RuntimeWarning, stacklevel=2)
    return "M" if admits else "vmap"


def _check(u: torch.Tensor, out: torch.Tensor, k: int) -> None:
    if u.dim() != 3 or u.shape[0] < 1 or min(u.shape[1:]) < 3:
        raise ValueError(f"need a (B, M, N) stack of member grids of at "
                         f"least 3 cells per axis, got {tuple(u.shape)}")
    if u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {u.device}")
    if (u.dtype, out.dtype) not in sk.STORAGE_PAIRS:
        raise TypeError(f"float32 or bfloat16 stacks in and out, got "
                        f"{u.dtype} -> {out.dtype}")
    if out.shape != u.shape:
        raise ValueError(f"out shape {tuple(out.shape)} != stack shape "
                         f"{tuple(u.shape)}")
    if u.device != out.device:
        raise ValueError(f"u on {u.device}, out on {out.device}")
    if not (u.is_contiguous() and out.is_contiguous()):
        raise ValueError("u and out must be contiguous")
    if u.data_ptr() == out.data_ptr():
        raise ValueError("out must be a different buffer from u")
    if (u.device.type == "cuda"
            and u.device.index != torch.cuda.current_device()):
        raise ValueError(f"stack on {u.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def ensemble_steps_plain(u: torch.Tensor, out: torch.Tensor, k: int,
                         with_residual: bool = True, *, cx: float,
                         cy: float) -> Optional[torch.Tensor]:
    """Plain version of :func:`ensemble_steps`: ``k`` plain steps of
    every member of the ``(B, M, N)`` stack ``u``, the last one landing
    in ``out``; each member's last-step interior max-norm residual, a
    ``(B,)`` float32 tensor (NaN-propagating), or None without
    ``with_residual``. A bfloat16 stack rounds every level, as the
    kernel does (``stencil_kernels._plain_steps_precision``)."""
    sk.counts["ensemble_steps_plain"] += 1
    if u.dtype == torch.bfloat16:
        return sk._plain_steps_precision(u, out, k, with_residual, cx, cy,
                                         False)
    a0, cxf, cyf = coeffs_f32(cx, cy)

    def step(src, dst):
        c = src[:, 1:-1, 1:-1]
        new = combine_2d(c, src[:, :-2, 1:-1], src[:, 2:, 1:-1],
                         src[:, 1:-1, :-2], src[:, 1:-1, 2:], a0, cxf, cyf)
        dst.copy_(src)
        dst[:, 1:-1, 1:-1] = new
        return (new - c).abs().amax(dim=(1, 2))

    return sk._plain_steps(u, out, k, with_residual, step)


def _launch_m(u, out, k, xch, bits, cx, cy, plan) -> None:
    """One launch of ``heat_m_ensemble`` (``heat_m_ensemble_bf16`` on a
    bfloat16 stack) under ``plan`` (an ``m_plan`` dict; ``bits`` None: no
    residual; ``xch`` the groups' exchange planes, None when the plan or
    ``k`` needs none); raises if the launch is refused. Checks nothing and
    counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    name = sk.kernel_entry("M", u.dtype)
    lib = load(name)
    code = getattr(lib, name)(
        u.data_ptr(), out.data_ptr(), sk._ptr(xch), sk._ptr(bits),
        u.shape[0], u.shape[1], u.shape[2], k, plan["depth"],
        plan["tile"][0], plan["tile"][1], plan["groups"], plan["block"][0],
        plan["block"][1], *coeffs_f32(cx, cy), sk._stream(u))
    sk._raise_on_error(lib, "heat_m_ensemble", code)


def exchange_planes(u: torch.Tensor, k: int, plan) -> Optional[torch.Tensor]:
    """Scratch for a launch of M under ``plan``: two float32 planes of a
    member's size for each group (at either storage dtype: a bfloat16
    launch's planes hold bfloat16 values), or None when no halo is
    exchanged (one tile a member, or ``k`` within one halo depth)."""
    if plan["tiles"] == 1 or k <= plan["depth"]:
        return None
    return torch.empty((plan["groups"], 2) + tuple(u.shape[1:]),
                       dtype=torch.float32, device=u.device)


def ensemble_steps(u: torch.Tensor, out: torch.Tensor, k: int,
                   with_residual: bool = True, *, cx: float,
                   cy: float) -> Optional[torch.Tensor]:
    """Kernel M: ``k`` steps of every member of the ``(B, M, N)`` stack
    ``u`` into ``out`` in one launch; returns each member's last-step
    residual (a ``(B,)`` float32 tensor) or None without
    ``with_residual``. Takes float32 and bfloat16 stacks (``out`` of
    ``u``'s dtype; at bfloat16 every level rounds). Raises ValueError for
    a member that does not fit resident on the card
    (:meth:`~.hopper_params.HopperParams.m_plan`, the same plan at both
    dtypes: the shared buffers hold float32)."""
    _check(u, out, k)
    plan = params().m_plan(int(u.shape[0]), tuple(u.shape[1:]))
    if plan is None:
        raise ValueError(f"a member of {tuple(u.shape[1:])} does not fit "
                         f"resident in the card's shared memory (kernel M)")
    if u.device.type == "cpu":
        return ensemble_steps_plain(u, out, k, with_residual, cx=cx, cy=cy)
    # Freed when this returns, before the kernel ends: the caching
    # allocator reuses the planes only in the order of the current
    # stream, which the kernel runs on.
    xch = exchange_planes(u, k, plan)
    bits = (torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
            if with_residual else None)
    _launch_m(u, out, k, xch, bits, cx, cy, plan)
    sk.counts[sk.kernel_entry("M", u.dtype)] += 1
    return bits.view(torch.float32) if bits is not None else None


def ensemble_multistep(config):
    """``(multi_step(u, v, n) -> (u, v), multi_step_residual(u, v, n) ->
    (u, v, res))`` over a ``(B, M, N)`` member-batched state through
    kernel M: one launch per call, ``res`` the ``(B,)`` per-member
    residuals. ``u`` holds the state, ``v`` is the spare buffer, and each
    returns them swapped. The kernel library of a CUDA run is loaded
    here, before any clock starts."""
    cx, cy = float(config.cx), float(config.cy)
    if torch.device(config.device).type == "cuda":
        from parallel_heat_tpu_torch.kernels.build import load

        load(sk.kernel_entry("M", config.dtype))

    def multi_step(u, v, n):
        ensemble_steps(u, v, n, False, cx=cx, cy=cy)
        return v, u

    def multi_step_residual(u, v, n):
        res = ensemble_steps(u, v, n, True, cx=cx, cy=cy)
        return v, u, res

    return multi_step, multi_step_residual
