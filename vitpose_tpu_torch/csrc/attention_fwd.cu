// Fused multi-head attention forward for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (vitpose_tpu/ops/attention.py:22, launched by `fused_attention` :38,
// pallas_call :71). Same function: O = softmax(q k^T * scale) v for every
// (batch, head) pair, with q, k, v, O in the [N, T, H, d] layout, scores and
// softmax in f32, P cast to v's dtype before the PV product, PV accumulated
// in f32 and O cast to the input dtype. The [T, T] score matrix never
// reaches device memory.
//
// What bounds it on the H100, at the ViTPose-B serving shape (bf16, N=256,
// T=192, H=12, d=64; 24 launches per flip-test batch):
//   bytes: q, k, v read once and O written once = 4*N*T*H*d*2 B = 302 MB,
//          0.090 ms at 3.35 TB/s;
//   ops:   4*N*H*T^2*d = 29.0 GFLOP, 0.029 ms at 989 TFLOP/s (bf16);
// so the memory traffic: a kernel near its bound reads each byte once and
// keeps device memory busy all the time.
//
// Three designs; ops/attention.py (`_plan`) picks one from the shape and
// passes it in `design`:
//   * bf16, whole pair per block (`attn_fwd_pair`), for T <= 192 (every
//     ViTPose variant at 256x192). A persistent block owns one (batch, head)
//     pair at a time, with one warpgroup per 64 query rows, so the pair's K
//     and V leave device memory once. One thread loads q, k and v by TMA
//     into a ring of two stages (the next pair's arrive while this one
//     computes); the whole [64, T] score row block of a warpgroup stays in
//     registers, so the softmax is exact in one pass (no running rescale)
//     and P is normalised before its bf16 rounding, as in the TPU kernel.
//     At d = 64 both products are wgmma: S = Q K^T from shared-memory
//     descriptors in the 128-byte swizzle that TMA writes, and O = P V with P
//     as the A operand from registers. At d = 32 and 80 they are mma.sync
//     with ldmatrix on the same TMA layouts (80 * 2 B = 160-byte rows do
//     not fit a swizzle span). O is staged in shared memory and leaves by
//     one TMA store per pair.
//   * bf16, tiled (`attn_fwd_mma_kernel`), for any T (T = 972 at 576x432
//     inputs): one block per (pair, 64-query tile), 64-key tiles through
//     shared memory, online softmax; K and V are re-read once per query
//     tile (from L2).
//   * f32 (`attn_fwd_kernel`), CUDA cores, tiled like the above: the tensor
//     cores have no exact f32, so at the serving shape it is bound by the
//     67 TFLOP/s f32 rate (0.43 ms), not by memory.
// Ragged edges are masked: key rows past T are zero-filled and scored -inf,
// query rows past T compute but are not stored. Head dims are compile-time
// constants: 32, 64 and 80 (ViTPose S, B/L, H); the wrapper rejects
// anything else.
//
// Strides: q, k and v may be strided views (the ViT splits one qkv tensor
// [N, T, 3, H, d]), so the kernels take their batch, token and head strides
// in elements; the last dim must be contiguous, and the bf16 designs need
// 16-byte aligned rows. O is written contiguous.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (vitpose_tpu_torch/ops/attention.py). The launch goes on the
// caller's stream; the return value is a CUDA error code, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// the `design` argument of vtp_attention_fwd
constexpr int kTiled = 0;
constexpr int kPair = 1;

// ---------------------------------------------------------------------------
// f32 path on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block, one thread each
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr int kCH = 16;  // keys per online-softmax rescale

template <int D>
__global__ void __launch_bounds__(kBQ)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int t_len,
                int heads, long long qsn, long long qst, long long qsh,
                long long ksn, long long kst, long long ksh, long long vsn,
                long long vst, long long vsh, float scale_log2) {
  static_assert(D % 4 == 0, "head dim must allow float4 reads");
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];

  const int pair = blockIdx.x;  // n * heads + h
  const int n = pair / heads;
  const int h = pair - n * heads;
  const int row = blockIdx.y * kBQ + threadIdx.x;
  const bool live = row < t_len;

  float qr[D];
  {
    const float* qp =
        q + n * qsn + h * qsh + (long long)(live ? row : 0) * qst;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = live ? qp[d] : 0.f;
  }
  const float* kb = k + n * ksn + h * ksh;
  const float* vb = v + n * vsn + h * vsh;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max of the scores, in log2 units
  float l = 0.f;        // running sum of exp2(score - m)

  for (int k0 = 0; k0 < t_len; k0 += kBK) {
    const int kn = min(kBK, t_len - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBK * D; i += kBQ) {
      const int r = i / D;
      const int c = i - r * D;
      float kv = 0.f, vv = 0.f;
      if (r < kn) {
        kv = kb[(long long)(k0 + r) * kst + c];
        vv = vb[(long long)(k0 + r) * vst + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kn; c0 += kCH) {
      float s[kCH];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + j][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        s[j] = (c0 + j < kn) ? dot * scale_log2 : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // c0 < kn, so the chunk has a finite score and m_new is finite
      const float m_new = fmaxf(m, cmax);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kCH; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    float* op = o + (((long long)n * t_len + row) * heads + h) * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int n,
            int t, int h, const long long* st, float scale,
            cudaStream_t stream) {
  const dim3 grid(n * h, (t + kBQ - 1) / kBQ);
  attn_fwd_kernel<D><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t, h, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale * kLog2e);
}

bool dispatch_f32(const void* q, const void* k, const void* v, void* o, int n,
                  int t, int h, int d, const long long* st, float scale,
                  cudaStream_t stream) {
  switch (d) {
    case 32: launch<32>(q, k, v, o, n, t, h, st, scale, stream); return true;
    case 64: launch<64>(q, k, v, o, n, t, h, st, scale, stream); return true;
    case 80: launch<80>(q, k, v, o, n, t, h, st, scale, stream); return true;
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// bf16, tiled design (`attn_fwd_mma_kernel`), for any T: mma.sync.m16n8k16
// (bf16 in, f32 accumulate). A block of 4 warps owns one (pair, 64-query
// tile), 16 rows per warp, and walks the keys in 64-key tiles staged in
// shared memory with a running max and sum (online softmax). S = Q K^T stays
// in registers, is rescaled, rounded to bf16 unnormalised and fed back as
// the A operand of P V without leaving the registers.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaBQ = 16 * kWarps;  // query rows per block
constexpr int kMmaBK = 64;           // keys per tile
static_assert(kMmaBQ == kMmaBK, "one tile loader serves Q, K and V");

// 64 rows of D bf16 from global (row stride in elements) into shared memory,
// 16 bytes per thread and step; rows >= `valid` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + 8],
                                          const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kMmaBK * kChunks; i += kWarps * 32) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int t_len, int heads,
                    int q_tiles, long long qsn, long long qst, long long qsh,
                    long long ksn, long long kst, long long ksh, long long vsn,
                    long long vst, long long vsh, float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  // rows padded by 16 bytes: ldmatrix row addresses then fall in distinct
  // shared-memory banks (the row pitch is an odd number of 16-byte units)
  __shared__ __align__(16) __nv_bfloat16 qs[kMmaBQ][D + 8];
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBK][D + 8];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBK][D + 8];

  // query tiles of one (batch, head) pair are neighbours in the grid, so
  // the pair's K and V are re-read from L2
  const int pair = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - pair * q_tiles) * kMmaBQ;
  const int n = pair / heads;
  const int h = pair - n * heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;  // which 8x8 matrix this lane addresses

  load_tile<D>(qs, q + n * qsn + h * qsh + q0 * qst, qst, t_len - q0);
  __syncthreads();
  unsigned qf[D / 16][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(&qs[warp * 16 + (mi % 2) * 8 + lane % 8]
                                      [kk * 16 + (mi / 2) * 8]));

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  // this lane's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this lane's part of the running sum

  const __nv_bfloat16* kb = k + n * ksn + h * ksh;
  const __nv_bfloat16* vb = v + n * vsn + h * vsh;
  for (int k0 = 0; k0 < t_len; k0 += kMmaBK) {
    const int kn = min(kMmaBK, t_len - k0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(ks, kb + k0 * kst, kst, kn);
    load_tile<D>(vs, vb + k0 * vst, vst, kn);
    __syncthreads();

    // S = Q K^T for 8 key groups of 8
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; j += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned b[4];
        ldmatrix_x4(b, smem_addr(&ks[j * 8 + (mi / 2) * 8 + lane % 8]
                                    [kk * 16 + (mi % 2) * 8]));
        mma_bf16(s[j], qf[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask keys past T, and take the row max over the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * 8 + 2 * (lane % 4) + e < kn;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every row sees key k0 < T, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= a0;
      acc[dn][1] *= a0;
      acc[dn][2] *= a1;
      acc[dn][3] *= a1;
    }

    // P = exp2(S - m): f32 into the sums, bf16 (v's dtype, as in the TPU
    // kernel) into the A fragments of P V
    unsigned pf[kMmaBK / 16][4];
#pragma unroll
    for (int j = 0; j < kMmaBK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V, V fragments through ldmatrix.trans of the [key][d] tile
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, smem_addr(&vs[kk * 16 + (mi % 2) * 8 + lane % 8]
                                          [(dn + mi / 2) * 8]));
        mma_bf16(acc[dn], pf[kk], b[0], b[1]);
        mma_bf16(acc[dn + 1], pf[kk], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  __nv_bfloat16* o0 = o + (((long long)n * t_len + r0) * heads + h) * D;
  __nv_bfloat16* o1 = o + (((long long)n * t_len + r1) * heads + h) * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * (lane % 4);
    if (r0 < t_len)
      *reinterpret_cast<unsigned*>(o0 + c) =
          pack_bf16(acc[dn][0] * i0, acc[dn][1] * i0);
    if (r1 < t_len)
      *reinterpret_cast<unsigned*>(o1 + c) =
          pack_bf16(acc[dn][2] * i1, acc[dn][3] * i1);
  }
}

template <int D>
void launch_mma(const void* q, const void* k, const void* v, void* o, int n,
                int t, int h, const long long* st, float scale,
                cudaStream_t stream) {
  const int q_tiles = (t + kMmaBQ - 1) / kMmaBQ;
  attn_fwd_mma_kernel<D><<<n * h * q_tiles, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t,
      h, q_tiles, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale * kLog2e);
}


// ---------------------------------------------------------------------------
// bf16, whole pair per block (`attn_fwd_pair`). NT = ceil(T / 64) query
// tiles, one warpgroup (4 warps, 16 rows each) per tile; warp w owns query
// rows [16w, 16w + 16) and every key.
// ---------------------------------------------------------------------------

// dynamic shared memory: 1024 bytes to align the tiles for the swizzle, two
// stages of q, k, v, the output tile and two 8-byte barriers. ops/attention.py
// `_plan` computes the same number.
template <int D, int NT>
__host__ __device__ constexpr int pair_smem() {
  return 1024 + 7 * tile_bytes<D, NT>() + 16;
}

// thread 0: q, k, v of `pair` by TMA into the stage at `dst`, completing
// on the stage's barrier `full`
__device__ __forceinline__ void load_pair(const CUtensorMap* q_map,
                                          const CUtensorMap* k_map,
                                          const CUtensorMap* v_map, int pair,
                                          int heads, uint32_t dst,
                                          uint32_t full, int tile) {
  const int n = pair / heads;
  const int h = pair - n * heads;
  mbar_expect_tx(full, 3 * tile);
  tma_load(dst, q_map, full, h, n);
  tma_load(dst + tile, k_map, full, h, n);
  tma_load(dst + 2 * tile, v_map, full, h, n);
}

template <int D, int NT>
__global__ void __launch_bounds__(NT * 128, 1)
attn_fwd_pair(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap o_map, int pairs, int heads,
              int t_len, float scale_log2) {
  constexpr int TB = tile_bytes<D, NT>();
  constexpr int NK = NT * 64;  // keys, padded
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);  // stage s: q, k, v at base + 3 s TB
  const uint32_t o_tile = base + 6 * TB;
  const uint32_t bar = base + 7 * TB;  // full barrier of stage s at bar + 8 s
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid == 0 && blockIdx.x < pairs)
    load_pair(&q_map, &k_map, &v_map, blockIdx.x, heads, base, bar, TB);

  int it = 0;
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++it) {
    const int stage = it & 1;
    // the other stage was released by the barrier that ended the last pair
    if (tid == 0 && pair + gridDim.x < pairs) {
      fence_async_smem();
      load_pair(&q_map, &k_map, &v_map, pair + gridDim.x, heads,
                base + (stage ^ 1) * 3 * TB, bar + 8 * (stage ^ 1), TB);
    }
    __syncwarp();
    mbar_wait(bar + 8 * stage, (it >> 1) & 1);
    const uint32_t qs = base + stage * 3 * TB;
    const uint32_t ks = qs + TB;
    const uint32_t vs = qs + 2 * TB;

    // S = Q K^T: this warp's 16 rows against all NK keys
    float s[NK / 8][4];
    if constexpr (D == 64) {
      const int wg = warp_id() / 4;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float(&st)[8][4] = *reinterpret_cast<float(*)[8][4]>(&s[t * 8]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(st, gmma_desc(qs + wg * 8192 + kk * 32),
                   gmma_desc(ks + t * 8192 + kk * 32));
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int t = 0; t < NT; ++t)
        reg_fence(*reinterpret_cast<float(*)[8][4]>(&s[t * 8]));
    } else {
      unsigned qf[D / 16][4];
      load_a<D>(qf, qs, 16 * warp_id(), lane_id());
      mma_abt<D, NK>(s, qf, ks, 0, lane_id());
    }
    const int warp = warp_id();
    const int lane = lane_id();

    // exact softmax of the two rows this lane holds (lane/4 and lane/4 + 8
    // of the warp's 16), reduced over the quad that shares them
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j * 8 + 2 * (lane % 4) + (e & 1) < t_len;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e / 2]);  // key 0 < T: mx is finite
        l[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / l[r];
    }
    // normalised P, rounded to bf16, as the A operand of P V
    unsigned pf[NK / 16][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      pf[j / 2][(j % 2) * 2] = pack_bf16(s[j][0] * l[0], s[j][1] * l[0]);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2] * l[1], s[j][3] * l[1]);
    }

    // O = P V
    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    if constexpr (D == 64) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_rs(o, pf[kk], gmma_desc(vs + kk * 2048));
      wgmma_commit();
      wgmma_wait();
      reg_fence(o);
    } else {
      mma_ab<D, NK>(o, pf, vs, 0, lane);
    }

    // stage O and store it by TMA, once the last pair's store has read the
    // staging tile
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    stage_rows<D>(o_tile, o, 1.f, 16 * warp, lane);
    fence_async_smem();
    __syncthreads();  // also: every warp is done with this stage
    if (tid == 0) {
      const int n = pair / heads;
      tma_store(&o_map, o_tile, pair - n * heads, n);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read();  // shared memory outlives the last store's reads
}

template <int D, int NT>
int launch_pair(const void* q, const void* k, const void* v, void* o, int n,
                int t, int h, const long long* st, float scale,
                cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = bind_context(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const long long ost[3] = {(long long)t * h * D, (long long)h * D, D};
  const void* bases[4] = {q, k, v, o};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const long long* s = i < 3 ? st + 3 * i : ost;
    const int res = make_map(&maps[i], bases[i], n, t, h, D, s[0], s[1], s[2],
                             NT * 64);
    if (res != 0) return res;
  }
  constexpr int smem = pair_smem<D, NT>();
  auto kernel = attn_fwd_pair<D, NT>;
  // per device, once: the shared-memory opt-in and the persistent grid
  // (SMs times the blocks one SM holds)
  static int resident[kMaxDevices];
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          NT * 128, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const int pairs = n * h;
  const int grid = pairs < resident[dev] ? pairs : resident[dev];
  kernel<<<grid, NT * 128, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                           pairs, h, t, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_pair(const void* q, const void* k, const void* v, void* o, int n,
                  int t, int h, const long long* st, float scale,
                  cudaStream_t stream) {
  switch ((t + 63) / 64) {
    case 1: return launch_pair<D, 1>(q, k, v, o, n, t, h, st, scale, stream);
    case 2: return launch_pair<D, 2>(q, k, v, o, n, t, h, st, scale, stream);
    case 3: return launch_pair<D, 3>(q, k, v, o, n, t, h, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int n,
                int t, int h, const long long* st, float scale, int design,
                cudaStream_t stream) {
  if (design == kPair)
    return dispatch_pair<D>(q, k, v, o, n, t, h, st, scale, stream);
  launch_mma<D>(q, k, v, o, n, t, h, st, scale, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. design: 0 = tiled, 1 = whole pair per
// block (bf16, T <= 192). strides: q (n, t, h), k (n, t, h), v (n, t, h), in
// elements. Returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for a dtype, design, head dim, length or alignment
// this file does not take, or kMapError plus the CUresult if
// cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int vtp_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int n, int t, int h, int d,
                                 int dtype, int design,
                                 const long long* strides, float scale,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (design != kTiled && design != kPair) return bad;
  if (dtype == 0 && design == kTiled) {
    if (!dispatch_f32(q, k, v, o, n, t, h, d, strides, scale, s)) return bad;
    return static_cast<int>(cudaGetLastError());
  }
  const void* ptrs[4] = {q, k, v, o};
  if (dtype != 1 || !aligned16(ptrs, 4, strides, 9)) return bad;
  switch (d) {
    case 32: return launch_bf16<32>(q, k, v, o, n, t, h, strides, scale, design, s);
    case 64: return launch_bf16<64>(q, k, v, o, n, t, h, strides, scale, design, s);
    case 80: return launch_bf16<80>(q, k, v, o, n, t, h, strides, scale, design, s);
    default: return bad;
  }
}
