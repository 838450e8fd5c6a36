// Shared device code of the heat kernels (2D: heat_a ... heat_i; 3D:
// heat_d_step3d.cu, heat_f_temporal3d.cu and their bfloat16 forms).
//
// Arithmetic contract: every kernel evaluates the factored 5-point
// combine of ops/stencil.py::combine_2d,
//     ((a0*c) + (cx*(up+down))) + (cy*(left+right)),
// one correctly rounded float32 operation at a time. The __fmul_rn and
// __fadd_rn intrinsics keep nvcc from contracting a multiply and an add
// into an FMA, which eager PyTorch never does; so a kernel is bitwise
// equal to its plain PyTorch version, and K steps of heat_e_temporal are
// bitwise K launches of heat_b_step. The 3D kernels evaluate the 7-point
// combine of ops/stencil.py::combine_3d the same way,
//     (((a0*c) + (cx*(xm+xp))) + (cy*(ym+yp))) + (cz*(zm+zp)),
// so K steps of heat_f_temporal3d are bitwise K launches of heat_d_step3d.
//
// Residual contract: the max over interior cells of |new - old|, taken
// on the uint32 bit pattern of the non-negative float. For non-negative
// floats that order is the numeric order, and every NaN (0x7fc00000 and
// up once the sign is cleared) sorts above +inf (0x7f800000): a
// diverging run reports NaN, as jnp.max and torch.max do, where fmaxf
// would drop it. Max is exact and order-free, so the result does not
// depend on which block finishes first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage precision (SEMANTICS.md "Precision"). Arithmetic is float32 at
// every storage dtype; a bfloat16 grid is widened to float32 on its way
// into shared memory, so the kernels' shared buffers always hold float32.
// The widening and the exact narrowing move bits (a bfloat16 is the upper
// 16 bits of the float32 it widens to), so a cell that is copied and never
// updated, the Dirichlet ring above all, keeps its bits, NaN payloads
// included. An updated cell rounds with __float2bfloat16_rn, the
// conversion torch's .to(torch.bfloat16) makes on the card.
__device__ __forceinline__ float heat_widen(float v) { return v; }
__device__ __forceinline__ float heat_widen(__nv_bfloat16 v) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(v))
                         << 16);
}
// A float32 value rounded to bfloat16 and widened back: a storage-mode
// step's level as the next step reads it.
__device__ __forceinline__ float heat_bf16_round(float v) {
  return heat_widen(__float2bfloat16_rn(v));
}
// The bfloat16 of a float32 that is one already (a widened cell): its
// upper 16 bits, exact.
__device__ __forceinline__ __nv_bfloat16 heat_bf16_exact(float v) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(__float_as_uint(v) >> 16));
}
// One cell's store at the grid's storage type: float32 as it is; on a
// bfloat16 grid an updated cell rounded, a copied one narrowed exactly.
__device__ __forceinline__ void heat_store(float* p, float v, bool) {
  *p = v;
}
__device__ __forceinline__ void heat_store(__nv_bfloat16* p, float v,
                                           bool updated) {
  *p = updated ? __float2bfloat16_rn(v) : heat_bf16_exact(v);
}

// A group of 4 bfloat16 cells packed in a uint2 (cell 0 in the low half
// of x), widened exactly, as heat_widen does one.
__device__ __forceinline__ float4 heat_widen_group(uint2 b) {
  return make_float4(__uint_as_float(b.x << 16),
                     __uint_as_float(b.x & 0xffff0000u),
                     __uint_as_float(b.y << 16),
                     __uint_as_float(b.y & 0xffff0000u));
}

// Four bfloat16 cells at p (8 bytes, 8-byte aligned, in any memory
// space) widened exactly: a lane's group of a bfloat16 ring row.
__device__ __forceinline__ float4 heat_widen4(const __nv_bfloat16* p) {
  return heat_widen_group(*reinterpret_cast<const uint2*>(p));
}

// Two float32 values rounded to bfloat16, round to nearest even (NaN to
// the canonical NaN), as __float2bfloat16_rn rounds each, packed lo |
// hi << 16 by one cvt.rn.bf16x2.f32 (which puts its first operand in the
// upper half).
__device__ __forceinline__ uint32_t heat_bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The bfloat16 bits of a group of 4 float32 values that hold bfloat16
// ones (widened cells), packed as heat_widen_group reads them: exact.
__device__ __forceinline__ uint2 heat_bf16x2_exact(float4 v) {
  return make_uint2(__byte_perm(__float_as_uint(v.x), __float_as_uint(v.y),
                                0x7632),
                    __byte_perm(__float_as_uint(v.z), __float_as_uint(v.w),
                                0x7632));
}

// A packed group of 4 bfloat16 cells stored at q: its cells whose bit in
// `st` is set, or all 8 bytes at once with `vec`.
__device__ __forceinline__ void heat_bf16_store_group(uint16_t* q, uint2 p,
                                                      unsigned st,
                                                      bool vec) {
  if (vec) {
    *reinterpret_cast<uint2*>(q) = p;
    return;
  }
  if (st & 1u) q[0] = static_cast<uint16_t>(p.x);
  if (st & 2u) q[1] = static_cast<uint16_t>(p.x >> 16);
  if (st & 4u) q[2] = static_cast<uint16_t>(p.y);
  if (st & 8u) q[3] = static_cast<uint16_t>(p.y >> 16);
}

// The group `p` with the cells whose bit in `upd` (bit j: cell j) is
// clear taken from `old`, bit for bit.
__device__ __forceinline__ uint2 heat_bf16_keep(uint2 p, uint2 old,
                                                unsigned upd) {
  const uint32_t mx = (upd & 1u ? 0x0000ffffu : 0u) |
                      (upd & 2u ? 0xffff0000u : 0u);
  const uint32_t my = (upd & 4u ? 0x0000ffffu : 0u) |
                      (upd & 8u ? 0xffff0000u : 0u);
  return make_uint2((p.x & mx) | (old.x & ~mx), (p.y & my) | (old.y & ~my));
}

__device__ __forceinline__ float heat_combine(float c, float up, float down,
                                              float left, float right,
                                              float a0, float cx, float cy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, c),
                             __fmul_rn(cx, __fadd_rn(up, down))),
                   __fmul_rn(cy, __fadd_rn(left, right)));
}

__device__ __forceinline__ float heat_combine3(float c, float xm, float xp,
                                               float ym, float yp, float zm,
                                               float zp, float a0, float cx,
                                               float cy, float cz) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a0, c), __fmul_rn(cx, __fadd_rn(xm, xp))),
                __fmul_rn(cy, __fadd_rn(ym, yp))),
      __fmul_rn(cz, __fadd_rn(zm, zp)));
}

// Bit pattern of |new - old|, the residual's ordering key.
__device__ __forceinline__ uint32_t heat_diff_bits(float v, float c) {
  return __float_as_uint(fabsf(__fsub_rn(v, c)));
}

__device__ __forceinline__ uint32_t heat_warp_max(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide max of `v` into *res. Every thread of the block must call
// it (it synchronises), and the block size must be a multiple of 32 and
// at most 1024. *res is zeroed by the host entry point before the
// launch. The plain load skips the atomic when *res already holds at
// least `v`: *res only grows, so a stale read can only cost an atomic,
// never lose a maximum.
__device__ __forceinline__ void heat_block_max(uint32_t v, uint32_t* res) {
  __shared__ uint32_t warp_part[32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  v = heat_warp_max(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? warp_part[lane] : 0u;
    v = heat_warp_max(v);
    if (lane == 0 && v != 0u) {
      const uint32_t seen = *reinterpret_cast<volatile uint32_t*>(res);
      if (v > seen) atomicMax(res, v);
    }
  }
}

// Dirichlet interior test for global cell (i, j) of an m x n grid.
__device__ __forceinline__ bool heat_is_interior(int64_t i, int64_t j,
                                                 int64_t m, int64_t n) {
  return i >= 1 && i <= m - 2 && j >= 1 && j <= n - 2;
}
