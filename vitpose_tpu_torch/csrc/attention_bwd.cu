// Fused multi-head attention backward for Hopper (sm_90a): K2.
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel`
// (vitpose_tpu/ops/attention.py:94, launched by `fused_attention_bwd` :139,
// pallas_call :171). Same function: for every (batch, head) pair, with q, k,
// v, the output gradient g and dq, dk, dv in the [N, T, H, d] layout,
//   S = q k^T * scale, P = softmax(S)             (recomputed, f32)
//   dV = P^T g, dP = g v^T, dS = P o (dP - rowsum(dP o P))
//   dQ = dS k * scale, dK = dS^T q * scale
// with every sum in f32 and the outputs cast to the input dtype. D =
// rowsum(dP o P) is the TPU kernel's quantity in f32 (f32 P, f32 dP), not
// rowsum(g o O) from a rounded forward output, and nothing is saved from the
// forward: the kernel recomputes the softmax statistics itself.
//
// What bounds it on the H100, at the ViTPose-B training shape (bf16, N=64,
// T=192, H=12, d=64; one launch per ViT block and step):
//   bytes: q, k, v, g read once and dq, dk, dv written once
//          = 7*N*T*H*d*2 B = 132 MB, 0.039 ms at 3.35 TB/s;
//   ops:   the five [T, T] x d products of the function, 10*N*H*T^2*d =
//          18.1 GFLOP, 0.018 ms at 989 TFLOP/s (bf16);
// so the memory traffic.
//
// Three designs; ops/attention.py (`_plan`) picks one from the shape and
// passes it in `design`:
//   * bf16, whole pair per block (`attn_bwd_pair`), for T <= 192: one
//     launch, one block per (batch, head) pair. One thread loads q, k, v
//     and g by TMA into shared memory, once. Warp w owns rows [16w, 16w+16):
//       sweep 1 (its queries): S and dP against every key, with the online
//         max m, sum l and sum of exp(S - m) dP per query; lse and D go to
//         shared memory;
//       sweep 2 (its keys): S^T and dP^T against every query, dS^T =
//         P^T o (dP^T - D), dV = P^T g and dK = dS^T q in registers, and
//         dS^T in bf16 into a [T, T] shared tile;
//       then dQ = dS k for its queries from that tile.
//     Seven [T, T] x d products, no device-memory scratch, no atomics
//     (deterministic). At d = 64 they are wgmma, a warpgroup's 64 rows at
//     a time, with every operand read from the 128-byte swizzle TMA writes
//     (P^T and dS^T as A operands from registers; dS read transposed for
//     dQ), so each B operand is read once per warpgroup; at d = 32 and 80
//     they are mma.sync with ldmatrix on the same layouts. dq, dk, dv are
//     staged in the q, v and g tiles, which are free by then, and leave by
//     TMA stores.
//   * bf16, tiled (`bwd_rows_mma`, then `bwd_cols_mma`), for any T (T = 972
//     at 576x432 inputs): two launches. (b) rows: one block per (pair,
//     64-query tile) sweeps the keys twice as above and writes dQ and the
//     row statistics (f32 scratch [N*H, T] from the wrapper); (a) cols: one
//     block per (pair, 64-key tile) recomputes S^T and dP^T from those
//     statistics and accumulates dV and dK. Nine products, and the other
//     side is re-read from L2 once per tile.
//   * f32 (`bwd_rows_f32`, `bwd_cols_f32`), CUDA cores, tiled like the
//     above, two threads per row, each owning half of the head dim (so the
//     rows fit in registers); the two halves of a dot product meet with one
//     shuffle.
// In the bf16 designs P and dS are rounded to bf16 only as the A operand of
// a product (dV = P^T g, dQ = dS k, dK = dS^T q); every sum, the softmax and
// D stay in f32. Ragged edges are masked: rows past T are zero-filled, keys
// past T score -inf (P = 0), queries past T have lse = +inf (P = 0), and no
// row past T is stored. Head dims are compile-time constants: 32, 64 and 80
// (ViTPose S, B/L, H).
//
// Strides: q, k, v and g may be strided views (the ViT splits one qkv
// tensor [N, T, 3, H, d]); the kernels take their batch, token and head
// strides in elements, the last dim contiguous, and the bf16 designs need
// 16-byte aligned rows. dq, dk, dv are written contiguous.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (vitpose_tpu_torch/ops/attention.py). Every launch goes on the
// caller's stream; the return value is a CUDA error code, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16;
using hopper::pack_bf16;
using hopper::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;

// the `design` argument of vtp_attention_bwd
constexpr int kTiled = 0;
constexpr int kPair = 1;

// batch, token and head strides of q, k, v, g, in elements
struct Strides {
  long long q[3], k[3], v[3], g[3];
};

// ---------------------------------------------------------------------------
// f32 path on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // rows this block owns, two threads each
constexpr int kTile = 64;  // rows of the other side per shared-memory tile

// this thread's half of a . b, `b` a shared-memory row at this thread's
// column offset; the caller adds the other half with one shuffle
template <int H>
__device__ __forceinline__ float half_dot(const float (&a)[H],
                                          const float* b) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < H; c += 4) {
    const float4 bb = *reinterpret_cast<const float4*>(b + c);
    dot = fmaf(a[c], bb.x, dot);
    dot = fmaf(a[c + 1], bb.y, dot);
    dot = fmaf(a[c + 2], bb.z, dot);
    dot = fmaf(a[c + 3], bb.w, dot);
  }
  return dot + __shfl_xor_sync(0xffffffffu, dot, 1);
}

// rows [r0, r0 + kTile) of a [T, D] slice into shared memory, zero past T
template <int D>
__device__ __forceinline__ void load_rows_f32(float (*dst)[D],
                                              const float* src,
                                              long long stride, int valid) {
  for (int i = threadIdx.x; i < kTile * D; i += 2 * kRows) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r][c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// pass (b), f32: dq and the row statistics of one 64-query tile
template <int D>
__global__ void __launch_bounds__(2 * kRows)
bwd_rows_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             float* __restrict__ dq, float* __restrict__ lse,
             float* __restrict__ dsum, int t_len, int heads, Strides st,
             float scale, float scale_log2) {
  static_assert(D % 8 == 0, "each half of the head dim takes float4 reads");
  constexpr int H = D / 2;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int pair = blockIdx.x;  // n * heads + h
  const int n = pair / heads;
  const int h = pair - n * heads;
  const int row = blockIdx.y * kRows + threadIdx.x / 2;
  const int c0 = (threadIdx.x % 2) * H;
  const bool live = row < t_len;

  float qr[H], gr[H];
  {
    const long long r = live ? row : 0;
    const float* qp = q + n * st.q[0] + h * st.q[2] + r * st.q[1] + c0;
    const float* gp = g + n * st.g[0] + h * st.g[2] + r * st.g[1] + c0;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      qr[c] = live ? qp[c] : 0.f;
      gr[c] = live ? gp[c] : 0.f;
    }
  }
  const float* kb = k + n * st.k[0] + h * st.k[2];
  const float* vb = v + n * st.v[0] + h * st.v[2];

  // sweep 1: online max m and sum l of exp2(s - m), and of exp2(s - m) * dp
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += kTile) {
    const int kn = min(kTile, t_len - k0);
    __syncthreads();
    load_rows_f32<D>(ks, kb + k0 * st.k[1], st.k[1], kn);
    load_rows_f32<D>(vs, vb + k0 * st.v[1], st.v[1], kn);
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      const float s = half_dot<H>(qr, &ks[j][c0]) * scale_log2;
      const float dp = half_dot<H>(gr, &vs[j][c0]);
      const float mn = fmaxf(m, s);  // finite: s is
      const float alpha = exp2f(m - mn);
      const float p = exp2f(s - mn);
      l = fmaf(l, alpha, p);
      a = fmaf(a, alpha, p * dp);
      m = mn;
    }
  }
  const float lse_r = m + log2f(l);
  const float d_r = a / l;

  // sweep 2: dS = P (dP - D), dQ += dS k
  float acc[H];
#pragma unroll
  for (int c = 0; c < H; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += kTile) {
    const int kn = min(kTile, t_len - k0);
    __syncthreads();
    load_rows_f32<D>(ks, kb + k0 * st.k[1], st.k[1], kn);
    load_rows_f32<D>(vs, vb + k0 * st.v[1], st.v[1], kn);
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      const float s = half_dot<H>(qr, &ks[j][c0]) * scale_log2;
      const float dp = half_dot<H>(gr, &vs[j][c0]);
      const float ds = exp2f(s - lse_r) * (dp - d_r);
#pragma unroll
      for (int c = 0; c < H; ++c) acc[c] = fmaf(ds, ks[j][c0 + c], acc[c]);
    }
  }

  if (live) {
    float* out = dq + (((long long)n * t_len + row) * heads + h) * D + c0;
#pragma unroll
    for (int c = 0; c < H; ++c) out[c] = acc[c] * scale;
    if (c0 == 0) {
      lse[(long long)pair * t_len + row] = lse_r;
      dsum[(long long)pair * t_len + row] = d_r;
    }
  }
}

// pass (a), f32: dk and dv of one 64-key tile
template <int D>
__global__ void __launch_bounds__(2 * kRows)
bwd_cols_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             float* __restrict__ dk, float* __restrict__ dv, int t_len,
             int heads, Strides st, float scale, float scale_log2) {
  constexpr int H = D / 2;
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float gs[kTile][D];
  __shared__ float ls[kTile], dss[kTile];

  const int pair = blockIdx.x;
  const int n = pair / heads;
  const int h = pair - n * heads;
  const int row = blockIdx.y * kRows + threadIdx.x / 2;  // key index
  const int c0 = (threadIdx.x % 2) * H;
  const bool live = row < t_len;

  float kr[H], vr[H];
  {
    const long long r = live ? row : 0;
    const float* kp = k + n * st.k[0] + h * st.k[2] + r * st.k[1] + c0;
    const float* vp = v + n * st.v[0] + h * st.v[2] + r * st.v[1] + c0;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      kr[c] = live ? kp[c] : 0.f;
      vr[c] = live ? vp[c] : 0.f;
    }
  }
  const float* qb = q + n * st.q[0] + h * st.q[2];
  const float* gb = g + n * st.g[0] + h * st.g[2];
  const float* lb = lse + (long long)pair * t_len;
  const float* db = dsum + (long long)pair * t_len;

  float dka[H], dva[H];
#pragma unroll
  for (int c = 0; c < H; ++c) dka[c] = dva[c] = 0.f;
  for (int q0 = 0; q0 < t_len; q0 += kTile) {
    const int qn = min(kTile, t_len - q0);
    __syncthreads();
    load_rows_f32<D>(qs, qb + q0 * st.q[1], st.q[1], qn);
    load_rows_f32<D>(gs, gb + q0 * st.g[1], st.g[1], qn);
    for (int i = threadIdx.x; i < kTile; i += 2 * kRows) {
      ls[i] = i < qn ? lb[q0 + i] : INFINITY;
      dss[i] = i < qn ? db[q0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < qn; ++i) {
      const float s = half_dot<H>(kr, &qs[i][c0]) * scale_log2;
      const float dp = half_dot<H>(vr, &gs[i][c0]);
      const float p = exp2f(s - ls[i]);
      const float ds = p * (dp - dss[i]);
#pragma unroll
      for (int c = 0; c < H; ++c) {
        dva[c] = fmaf(p, gs[i][c0 + c], dva[c]);
        dka[c] = fmaf(ds, qs[i][c0 + c], dka[c]);
      }
    }
  }

  if (live) {
    const long long off = (((long long)n * t_len + row) * heads + h) * D + c0;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      dk[off + c] = dka[c] * scale;
      dv[off + c] = dva[c];
    }
  }
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, const void* g,
                void* dq, void* dk, void* dv, float* lse, float* dsum, int n,
                int t, int h, const Strides& st, float scale,
                cudaStream_t stream) {
  const dim3 grid(n * h, (t + kRows - 1) / kRows);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  bwd_rows_f32<D><<<grid, 2 * kRows, 0, stream>>>(
      qf, kf, vf, gf, static_cast<float*>(dq), lse, dsum, t, h, st, scale,
      scale * kLog2e);
  bwd_cols_f32<D><<<grid, 2 * kRows, 0, stream>>>(
      qf, kf, vf, gf, lse, dsum, static_cast<float*>(dk),
      static_cast<float*>(dv), t, h, st, scale, scale * kLog2e);
}

// ---------------------------------------------------------------------------
// bf16, tiled design (mma.sync m16n8k16, f32 accumulate). Each warp owns 16
// rows of its block's 64 and holds their A fragments; the other side comes
// in 64-row tiles through shared memory (rows padded by 16 bytes).
// Accumulator layout of one 16x8 product: lane holds rows lane/4 and
// lane/4 + 8, columns 2*(lane%4) and 2*(lane%4) + 1.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBR = 16 * kWarps;  // rows per block
constexpr int kBT = 64;           // rows per shared-memory tile
static_assert(kBR == kBT, "one tile loader serves both sides");

// 64 rows of D bf16 from global (row stride in elements) into shared memory,
// 16 bytes per thread and step; rows >= `valid` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + 8],
                                          const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBT * kChunks; i += kWarps * 32) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// A fragments of 16 rows [r0, r0 + 16) x D of a [row][d] tile
template <int D>
__device__ __forceinline__ void load_a(unsigned (&f)[D / 16][4],
                                       const __nv_bfloat16 (*src)[D + 8],
                                       int r0, int lane) {
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], smem_addr(&src[r0 + (mi % 2) * 8 + lane % 8]
                                     [kk * 16 + (mi / 2) * 8]));
}

// c = a (16 x D) * b^T, b a [64][D] tile: 16 x 64 in 8 column groups
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[kBT / 8][4],
                                        const unsigned (&a)[D / 16][4],
                                        const __nv_bfloat16 (*b)[D + 8],
                                        int lane) {
  const int mi = lane / 8;
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kBT / 8; j += 2) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned r[4];
      ldmatrix_x4(r, smem_addr(&b[j * 8 + (mi / 2) * 8 + lane % 8]
                                 [kk * 16 + (mi % 2) * 8]));
      mma_bf16(c[j], a[kk], r[0], r[1]);
      mma_bf16(c[j + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc (16 x D) += a (16 x 64) * b, b a [64][D] tile read through
// ldmatrix.trans
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const unsigned (&a)[kBT / 16][4],
                                       const __nv_bfloat16 (*b)[D + 8],
                                       int lane) {
  static_assert((D / 8) % 2 == 0, "column groups go in pairs");
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) {
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      unsigned r[4];
      ldmatrix_x4_trans(r, smem_addr(&b[kk * 16 + (mi % 2) * 8 + lane % 8]
                                       [(dn + mi / 2) * 8]));
      mma_bf16(acc[dn], a[kk], r[0], r[1]);
      mma_bf16(acc[dn + 1], a[kk], r[2], r[3]);
    }
  }
}

// a 16 x 64 accumulator, rounded to bf16, as the A operand of the next
// product
__device__ __forceinline__ void to_a(unsigned (&a)[kBT / 16][4],
                                     const float (&x)[kBT / 8][4]) {
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(x[j][0], x[j][1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// rows lane/4 and lane/4 + 8 of a warp's 16 x D accumulator, times `mul`,
// into a contiguous [N, T, H, D] bf16 output
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 8][4],
                                           float mul, int n, int r0, int h,
                                           int t_len, int heads, int lane) {
  const int r1 = r0 + 8;
  __nv_bfloat16* o0 = out + (((long long)n * t_len + r0) * heads + h) * D;
  __nv_bfloat16* o1 = out + (((long long)n * t_len + r1) * heads + h) * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * (lane % 4);
    if (r0 < t_len)
      *reinterpret_cast<unsigned*>(o0 + c) =
          pack_bf16(acc[dn][0] * mul, acc[dn][1] * mul);
    if (r1 < t_len)
      *reinterpret_cast<unsigned*>(o1 + c) =
          pack_bf16(acc[dn][2] * mul, acc[dn][3] * mul);
  }
}

// pass (b), bf16: dq and the row statistics of one 64-query tile
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
bwd_rows_mma(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ g,
             __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
             float* __restrict__ dsum, int t_len, int heads, int tiles,
             Strides st, float scale, float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  // rows padded by 16 bytes so ldmatrix row addresses fall in distinct
  // banks (the row pitch is an odd number of 16-byte units)
  __shared__ __align__(16) __nv_bfloat16 as[kBR][D + 8];
  __shared__ __align__(16) __nv_bfloat16 ks[kBT][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vs[kBT][D + 8];

  // the query tiles of one pair are neighbours in the grid, so the pair's
  // K and V are re-read from L2
  const int pair = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - pair * tiles) * kBR;
  const int n = pair / heads;
  const int h = pair - n * heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  unsigned qf[D / 16][4], gf[D / 16][4];
  load_tile<D>(as, q + n * st.q[0] + h * st.q[2] + q0 * st.q[1], st.q[1],
               t_len - q0);
  __syncthreads();
  load_a<D>(qf, as, warp * 16, lane);
  __syncthreads();
  load_tile<D>(as, g + n * st.g[0] + h * st.g[2] + q0 * st.g[1], st.g[1],
               t_len - q0);
  __syncthreads();
  load_a<D>(gf, as, warp * 16, lane);

  const __nv_bfloat16* kb = k + n * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + n * st.v[0] + h * st.v[2];

  // sweep 1, per row of this lane (lane/4 and lane/4 + 8): running max m
  // (log2 units), this lane's parts of l = sum exp2(s - m) and of
  // a = sum exp2(s - m) * dp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < t_len; k0 += kBT) {
    const int kn = min(kBT, t_len - k0);
    __syncthreads();
    load_tile<D>(ks, kb + k0 * st.k[1], st.k[1], kn);
    load_tile<D>(vs, vb + k0 * st.v[1], st.v[1], kn);
    __syncthreads();
    float s[kBT / 8][4], dp[kBT / 8][4];
    mma_abt<D>(s, qf, ks, lane);
    mma_abt<D>(dp, gf, vs, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j * 8 + 2 * (lane % 4) + (e & 1) < kn;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < T is in every tile, so the new max is finite
      const float mn = fmaxf(m[r], mx[r]);
      const float alpha = exp2f(m[r] - mn);
      l[r] *= alpha;
      a[r] *= alpha;
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e / 2]);  // 0 past T
        l[e / 2] += p;
        a[e / 2] = fmaf(p, dp[j][e], a[e / 2]);
      }
    }
  }
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    a[r] += __shfl_xor_sync(0xffffffffu, a[r], 1);
    a[r] += __shfl_xor_sync(0xffffffffu, a[r], 2);
    lse_r[r] = m[r] + log2f(l[r]);
    d_r[r] = a[r] / l[r];
  }

  // sweep 2: dS = P (dP - D), dQ += dS k
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += kBT) {
    const int kn = min(kBT, t_len - k0);
    __syncthreads();
    load_tile<D>(ks, kb + k0 * st.k[1], st.k[1], kn);
    load_tile<D>(vs, vb + k0 * st.v[1], st.v[1], kn);
    __syncthreads();
    float s[kBT / 8][4], dp[kBT / 8][4];
    mma_abt<D>(s, qf, ks, lane);
    mma_abt<D>(dp, gf, vs, lane);
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j * 8 + 2 * (lane % 4) + (e & 1) < kn;
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_r[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - d_r[e / 2]);
      }
    }
    unsigned dsf[kBT / 16][4];
    to_a(dsf, s);
    mma_ab<D>(acc, dsf, ks, lane);
  }

  const int r0 = q0 + warp * 16 + lane / 4;
  store_rows<D>(dq, acc, scale, n, r0, h, t_len, heads, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r0 + 8 * r < t_len) {
        lse[(long long)pair * t_len + r0 + 8 * r] = lse_r[r];
        dsum[(long long)pair * t_len + r0 + 8 * r] = d_r[r];
      }
    }
  }
}

// pass (a), bf16: dk and dv of one 64-key tile. The warp's 16 keys are the
// rows of S^T = k q^T and dP^T = v g^T, so P^T and dS^T come out in the
// accumulator layout and feed dV = P^T g and dK = dS^T q directly.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
bwd_cols_mma(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int t_len, int heads, int tiles, Strides st, float scale,
             float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBT][D + 8];
  __shared__ __align__(16) __nv_bfloat16 gs[kBT][D + 8];
  __shared__ float ls[kBT], dss[kBT];

  const int pair = blockIdx.x / tiles;
  const int k0 = (blockIdx.x - pair * tiles) * kBR;
  const int n = pair / heads;
  const int h = pair - n * heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  unsigned kf[D / 16][4], vf[D / 16][4];
  load_tile<D>(qs, k + n * st.k[0] + h * st.k[2] + k0 * st.k[1], st.k[1],
               t_len - k0);
  load_tile<D>(gs, v + n * st.v[0] + h * st.v[2] + k0 * st.v[1], st.v[1],
               t_len - k0);
  __syncthreads();
  load_a<D>(kf, qs, warp * 16, lane);
  load_a<D>(vf, gs, warp * 16, lane);

  const __nv_bfloat16* qb = q + n * st.q[0] + h * st.q[2];
  const __nv_bfloat16* gb = g + n * st.g[0] + h * st.g[2];
  const float* lb = lse + (long long)pair * t_len;
  const float* db = dsum + (long long)pair * t_len;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }
  for (int q0 = 0; q0 < t_len; q0 += kBT) {
    const int qn = min(kBT, t_len - q0);
    __syncthreads();
    load_tile<D>(qs, qb + q0 * st.q[1], st.q[1], qn);
    load_tile<D>(gs, gb + q0 * st.g[1], st.g[1], qn);
    for (int i = threadIdx.x; i < kBT; i += kWarps * 32) {
      ls[i] = i < qn ? lb[q0 + i] : INFINITY;  // P = 0 past T
      dss[i] = i < qn ? db[q0 + i] : 0.f;
    }
    __syncthreads();
    float s[kBT / 8][4], dp[kBT / 8][4];
    mma_abt<D>(s, kf, qs, lane);
    mma_abt<D>(dp, vf, gs, lane);
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * (lane % 4) + (e & 1);
        const float p = exp2f(s[j][e] * scale_log2 - ls[col]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dss[col]);
      }
    }
    unsigned af[kBT / 16][4];
    to_a(af, s);
    mma_ab<D>(dva, af, gs, lane);
    to_a(af, dp);
    mma_ab<D>(dka, af, qs, lane);
  }

  const int r0 = k0 + warp * 16 + lane / 4;
  store_rows<D>(dk, dka, scale, n, r0, h, t_len, heads, lane);
  store_rows<D>(dv, dva, 1.f, n, r0, h, t_len, heads, lane);
}

template <int D>
void launch_mma(const void* q, const void* k, const void* v, const void* g,
                void* dq, void* dk, void* dv, float* lse, float* dsum, int n,
                int t, int h, const Strides& st, float scale,
                cudaStream_t stream) {
  const int tiles = (t + kBR - 1) / kBR;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  bwd_rows_mma<D><<<n * h * tiles, kWarps * 32, 0, stream>>>(
      qb, kb, vb, gb, static_cast<__nv_bfloat16*>(dq), lse, dsum, t, h,
      tiles, st, scale, scale * kLog2e);
  bwd_cols_mma<D><<<n * h * tiles, kWarps * 32, 0, stream>>>(
      qb, kb, vb, gb, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t, h, tiles, st, scale,
      scale * kLog2e);
}


// ---------------------------------------------------------------------------
// bf16, whole pair per block (`attn_bwd_pair`). NT = ceil(T / 64); 4 NT
// warps, warp w owns rows [16w, 16w + 16) of each side in turn (and
// warpgroup w / 4 the 64 rows from 64 (w / 4) for wgmma at d = 64).
// ---------------------------------------------------------------------------

// dynamic shared memory: 1024 bytes to align the tiles for the swizzle; q,
// k, v, g; the bf16 [NK][NK] dS^T tile; lse and D (f32 [NK] each); one
// 8-byte barrier. ops/attention.py `_plan` computes the same number.
template <int D, int NT>
__host__ __device__ constexpr int pair_smem() {
  return 1024 + 4 * hopper::tile_bytes<D, NT>() + (NT * 64) * (NT * 64) * 2 +
         2 * (NT * 64) * 4 + 8;
}

// shared address of 16-byte chunk `chunk` (queries 8 chunk .. 8 chunk + 7)
// of key row `key` of the dS^T tile at `base` (1024-byte aligned). The tile
// is NK / 64 blocks of [NK keys][64 queries], each in the 128-byte swizzle
// (the layout wgmma reads; the 8 rows an ldmatrix reads or a warp's
// accumulator writes fall in distinct banks).
template <int NK>
__device__ __forceinline__ uint32_t ds_addr(uint32_t base, int key,
                                            int chunk) {
  return (base + (chunk / 8) * (NK * 128) + key * 128 + (chunk % 8) * 16) ^
         ((key & 7) << 4);
}

template <int D, int NT>
__global__ void __launch_bounds__(NT * 128, 1)
attn_bwd_pair(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap g_map,
              const __grid_constant__ CUtensorMap dq_map,
              const __grid_constant__ CUtensorMap dk_map,
              const __grid_constant__ CUtensorMap dv_map, int heads,
              int t_len, float scale, float scale_log2) {
  constexpr int TB = hopper::tile_bytes<D, NT>();
  constexpr int NK = NT * 64;  // rows of each side, padded
  // queries per step of sweep 2: 16 at d = 80 keeps its registers (dK, dV
  // and the fragments) under the 168 that 384 threads may have
  constexpr int QC = D > 64 ? 16 : 32;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t qs = hopper::smem_addr(smem);
  const uint32_t ks = qs + TB;
  const uint32_t vs = qs + 2 * TB;
  const uint32_t gs = qs + 3 * TB;
  const uint32_t dss = qs + 4 * TB;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * TB + NK * NK * 2);
  float* dsum_s = lse_s + NK;
  const uint32_t bar = dss + NK * NK * 2 + 2 * NK * 4;
  const int n = blockIdx.x / heads;
  const int h = blockIdx.x - n * heads;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, 4 * TB);
    hopper::tma_load(qs, &q_map, bar, h, n);
    hopper::tma_load(ks, &k_map, bar, h, n);
    hopper::tma_load(vs, &v_map, bar, h, n);
    hopper::tma_load(gs, &g_map, bar, h, n);
  }
  __syncwarp();
  hopper::mbar_wait(bar, 0);

  // sweep 1, this warp's queries; per row of this lane (lane/4 and
  // lane/4 + 8): running max m (log2 units), this lane's parts of
  // l = sum exp2(s - m) and a = sum exp2(s - m) dp
  {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          a[2] = {0.f, 0.f};
    // one key tile at a time: unrolled, the tiles' products would overlap
    // and hold two tiles of S and dP in registers
#pragma unroll 1
    for (int kt = 0; kt < NT; ++kt) {
      const int lane = hopper::lane_id();
      const int r0 = 16 * hopper::warp_id();
      float s[8][4], dp[8][4];
      if constexpr (D == 64) {
        // S and dP of this warpgroup's 64 queries against key tile kt
        const uint32_t rows = (r0 / 64) * 8192;
        hopper::zero(s);
        hopper::zero(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss(s, hopper::gmma_desc(qs + rows + kk * 32),
                           hopper::gmma_desc(ks + kt * 8192 + kk * 32));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss(dp, hopper::gmma_desc(gs + rows + kk * 32),
                           hopper::gmma_desc(vs + kt * 8192 + kk * 32));
        hopper::wgmma_commit();
        hopper::wgmma_wait();
        hopper::reg_fence(s);
        hopper::reg_fence(dp);
      } else {
        {
          unsigned qf[D / 16][4];
          hopper::load_a<D>(qf, qs, r0, lane);
          hopper::mma_abt<D, 64>(s, qf, ks, kt * 64, lane);
        }
        unsigned gf[D / 16][4];
        hopper::load_a<D>(gf, gs, r0, lane);
        hopper::mma_abt<D, 64>(dp, gf, vs, kt * 64, lane);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kt * 64 + j * 8 + 2 * (lane % 4) + (e & 1) < t_len;
          s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // key 0 < T is in the first tile, so the max is finite from there
        const float mn = fmaxf(m[r], mx[r]);
        const float alpha = exp2f(m[r] - mn);
        l[r] *= alpha;
        a[r] *= alpha;
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e / 2]);  // 0 past T
          l[e / 2] += p;
          a[e / 2] = fmaf(p, dp[j][e], a[e / 2]);
        }
      }
    }
    const int lane = hopper::lane_id();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      a[r] += __shfl_xor_sync(0xffffffffu, a[r], 1);
      a[r] += __shfl_xor_sync(0xffffffffu, a[r], 2);
      const int row = 16 * hopper::warp_id() + lane / 4 + 8 * r;
      if (lane % 4 == 0) {
        // queries past T get P = 0 in sweep 2
        lse_s[row] = row < t_len ? m[r] + log2f(l[r]) : INFINITY;
        dsum_s[row] = row < t_len ? a[r] / l[r] : 0.f;
      }
    }
  }
  __syncthreads();

  // sweep 2, this warp's keys (rows of S^T = k q^T and dP^T = v g^T), in
  // steps of QC queries: P^T and dS^T come out in the accumulator layout
  // and feed dV = P^T g and dK = dS^T q as A operands
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }
#pragma unroll 1
  for (int q0 = 0; q0 < NK; q0 += QC) {
    const int lane = hopper::lane_id();
    const int r0 = 16 * hopper::warp_id();
    const int key = r0 + lane / 4;  // this lane's keys: key and key + 8
    const bool live[2] = {key < t_len, key + 8 < t_len};
    float s[QC / 8][4], dp[QC / 8][4];
    if constexpr (D == 64) {
      // S^T and dP^T of this warpgroup's 64 keys against QC queries
      const uint32_t rows = (r0 / 64) * 8192;
      hopper::zero(s);
      hopper::zero(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n32(s, hopper::gmma_desc(ks + rows + kk * 32),
                             hopper::gmma_desc(qs + q0 * 128 + kk * 32));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n32(dp, hopper::gmma_desc(vs + rows + kk * 32),
                             hopper::gmma_desc(gs + q0 * 128 + kk * 32));
      hopper::wgmma_commit();
      hopper::wgmma_wait();
      hopper::reg_fence(s);
      hopper::reg_fence(dp);
    } else {
      {
        unsigned kf[D / 16][4];
        hopper::load_a<D>(kf, ks, r0, lane);
        hopper::mma_abt<D, QC>(s, kf, qs, q0, lane);
      }
      unsigned vf[D / 16][4];
      hopper::load_a<D>(vf, vs, r0, lane);
      hopper::mma_abt<D, QC>(dp, vf, gs, q0, lane);
    }
#pragma unroll
    for (int j = 0; j < QC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = q0 + j * 8 + 2 * (lane % 4) + (e & 1);
        const float p =
            live[e / 2] ? exp2f(s[j][e] * scale_log2 - lse_s[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dsum_s[col]);
      }
    }
    unsigned pf[QC / 16][4], dsf[QC / 16][4];
    hopper::to_a<QC>(pf, s);
    hopper::to_a<QC>(dsf, dp);
    if constexpr (D == 64) {
      // the 16-query steps of g and q as MN-major B operands
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk)
        hopper::wgmma_rs(dva, pf[kk],
                         hopper::gmma_desc(gs + (q0 + 16 * kk) * 128));
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk)
        hopper::wgmma_rs(dka, dsf[kk],
                         hopper::gmma_desc(qs + (q0 + 16 * kk) * 128));
      hopper::wgmma_commit();
      hopper::wgmma_wait();
      hopper::reg_fence(dva);
      hopper::reg_fence(dka);
    } else {
      hopper::mma_ab<D, QC>(dva, pf, gs, q0, lane);
      hopper::mma_ab<D, QC>(dka, dsf, qs, q0, lane);
    }
    // dS^T as rounded for dK, rows = keys, into the shared tile
#pragma unroll
    for (int j = 0; j < QC / 8; ++j) {
      const int c = 4 * (lane % 4);
      const int chunk = q0 / 8 + j;
      hopper::st_shared(ds_addr<NK>(dss, key, chunk) + c,
                        dsf[j / 2][(j % 2) * 2]);
      hopper::st_shared(ds_addr<NK>(dss, key + 8, chunk) + c,
                        dsf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  hopper::fence_async_smem();  // the dS^T tile, for wgmma's reads
  __syncthreads();  // dS^T complete; q, v and g are read no more
  const int lane = hopper::lane_id();
  const int warp = hopper::warp_id();
  const int r0 = 16 * warp;

  // dK and dV into the v and g tiles, in the layout the TMA store reads
  hopper::stage_rows<D>(vs, dka, scale, r0, lane);
  hopper::stage_rows<D>(gs, dva, 1.f, r0, lane);

  // dQ = dS k for this warp's queries
  float acc[D / 8][4];
  hopper::zero(acc);
  if constexpr (D == 64) {
    // A = dS, read transposed (MN-major) from the warpgroup's query block
    // of the dS^T tile; B = k, MN-major
    const uint32_t block = dss + (warp / 4) * (NK * 128);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      hopper::wgmma_ss_tt(acc, hopper::gmma_desc(block + kk * 2048),
                          hopper::gmma_desc(ks + kk * 2048));
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::reg_fence(acc);
  } else {
    // A fragments of dS are the transposed 8 x 8 blocks of the dS^T tile
    // (ldmatrix.trans)
    const int mi = lane / 8;
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      unsigned af[1][4];
      ldmatrix_x4_trans(af[0], ds_addr<NK>(dss, kk * 16 + (mi / 2) * 8 +
                                                     lane % 8,
                                           2 * warp + mi % 2));
      hopper::mma_ab<D, 16>(acc, af, ks, kk * 16, lane);
    }
  }
  hopper::stage_rows<D>(qs, acc, scale, r0, lane);
  hopper::fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    hopper::tma_store(&dq_map, qs, h, n);
    hopper::tma_store(&dk_map, vs, h, n);
    hopper::tma_store(&dv_map, gs, h, n);
    hopper::bulk_commit();
    hopper::bulk_wait_read();  // the block's shared memory outlives the reads
  }
}

template <int D, int NT>
int launch_pair(const void* q, const void* k, const void* v, const void* g,
                void* dq, void* dk, void* dv, int n, int t, int h,
                const long long* st, float scale, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = hopper::bind_context(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= hopper::kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const long long ost[3] = {(long long)t * h * D, (long long)h * D, D};
  const void* bases[7] = {q, k, v, g, dq, dk, dv};
  CUtensorMap maps[7];
  for (int i = 0; i < 7; ++i) {
    const long long* s = i < 4 ? st + 3 * i : ost;
    const int res = hopper::make_map(&maps[i], bases[i], n, t, h, D, s[0],
                                     s[1], s[2], NT * 64);
    if (res != 0) return res;
  }
  constexpr int smem = pair_smem<D, NT>();
  auto kernel = attn_bwd_pair<D, NT>;
  static bool opted_in[hopper::kMaxDevices];  // per device, once
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  kernel<<<n * h, NT * 128, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], h, t,
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* g,
                void* dq, void* dk, void* dv, float* lse, float* dsum, int n,
                int t, int h, const long long* strides, const Strides& st,
                float scale, int design, cudaStream_t stream) {
  if (design == kTiled) {
    if (lse == nullptr || dsum == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    launch_mma<D>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, st, scale,
                  stream);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((t + 63) / 64) {
    case 1: return launch_pair<D, 1>(q, k, v, g, dq, dk, dv, n, t, h, strides, scale, stream);
    case 2: return launch_pair<D, 2>(q, k, v, g, dq, dk, dv, n, t, h, strides, scale, stream);
    case 3: return launch_pair<D, 3>(q, k, v, g, dq, dk, dv, n, t, h, strides, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. design: 0 = tiled (two passes through
// the lse and dsum scratch, f32 [N*H*T] each), 1 = whole pair per block
// (bf16, T <= 192; lse and dsum may be null). strides: q (n, t, h),
// k (n, t, h), v (n, t, h), g (n, t, h), in elements. Returns the CUDA error
// of the launches (0 on success), cudaErrorInvalidValue for a dtype, design,
// head dim, length or alignment this file does not take, or kMapError plus
// the CUresult if cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int vtp_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* g, void* dq, void* dk, void* dv,
                                 float* lse, float* dsum, int n, int t, int h,
                                 int d, int dtype, int design,
                                 const long long* strides, float scale,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.g[i] = strides[9 + i];
  }
  if (design != kTiled && design != kPair) return bad;
  if (dtype == 0 && design == kTiled) {
    if (lse == nullptr || dsum == nullptr) return bad;
    switch (d) {
      case 32: launch_f32<32>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, st, scale, s); break;
      case 64: launch_f32<64>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, st, scale, s); break;
      case 80: launch_f32<80>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, st, scale, s); break;
      default: return bad;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const void* ptrs[4] = {q, k, v, g};
  if (dtype != 1 || !hopper::aligned16(ptrs, 4, strides, 12)) return bad;
  switch (d) {
    case 32: return launch_bf16<32>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, strides, st, scale, design, s);
    case 64: return launch_bf16<64>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, strides, st, scale, design, s);
    case 80: return launch_bf16<80>(q, k, v, g, dq, dk, dv, lse, dsum, n, t, h, strides, st, scale, design, s);
    default: return bad;
  }
}
