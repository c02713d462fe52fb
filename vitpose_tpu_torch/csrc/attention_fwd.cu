// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel`
// (vitpose_tpu/ops/attention.py:22, launched by `fused_attention` :38,
// pallas_call :71). Same function: O = softmax(q k^T * scale) v for every
// (batch, head) pair, with q, k, v, O in the [N, T, H, d] layout, scores and
// softmax in f32, P cast to v's dtype before the PV product, PV accumulated
// in f32 and O cast to the input dtype. The [T, T] score matrix never
// reaches device memory.
//
// Bound at the ViTPose-B serving shape (bf16, N=256, T=192, H=12, d=64; one
// launch per ViT block and 12 more for the flip-test pass):
//   bytes: q, k, v read once and O written once = 4*N*T*H*d*2 B = 302 MB,
//          0.090 ms at 3.35 TB/s;
//   ops:   4*N*H*T^2*d = 29.0 GFLOP, 0.029 ms at the 989 TFLOP/s bf16
//          tensor-core rate;
// so the card's bound is the memory traffic.
//
// Two kernels, one per input dtype:
//   * bf16 (`attn_fwd_mma_kernel`): tensor cores, mma.sync m16n8k16 with f32
//     accumulation in a flash-attention-2 layout; the serving path takes it.
//     It needs 16-byte aligned rows (base pointers on 16 bytes, strides in
//     multiples of 8 elements), which the ViT's qkv views always have.
//   * f32 (`attn_fwd_kernel`): CUDA cores (the tensor cores have no exact
//     f32). One thread per query row, f32 FMAs; at the serving shape it is
//     bound by the 67 TFLOP/s f32 rate (0.43 ms), not by memory.
//
// Design, against the TPU version: the Pallas kernel keeps 16 whole
// (pair, [T, T]) problems in VMEM per grid step. A Hopper block has at most
// 227 KB of shared memory and T reaches 972 (576x432 inputs), so here a
// block owns one (pair, 64-query tile) and walks the keys in 64-key tiles
// staged in shared memory, keeping a running max and sum in f32 (online
// softmax) so that any T fits. Ragged edges (T = 192, 972) are masked: key
// rows past T are zero-filled and scored -inf, query rows past T compute
// but do not store. Head dims are compile-time constants: 32, 64 and 80
// (ViTPose S, B/L, H); the wrapper rejects anything else.
//
// Strides: q, k and v may be strided views (the ViT splits one qkv tensor
// [N, T, 3, H, d]), so the kernels take their batch, token and head strides
// in elements; the last dim must be contiguous. O is written contiguous.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (vitpose_tpu_torch/ops/attention.py). The launch goes on the
// caller's stream; the return value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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
// bf16 path on the tensor cores, for 16-byte aligned rows. Flash-attention-2
// layout on mma.sync.m16n8k16 (bf16 in, f32 accumulate): a block of 4 warps
// owns 64 query rows, 16 per warp; each 64-key tile of K and V is staged in shared memory; S = Q K^T stays in
// registers, is rescaled by the online softmax, rounded to bf16 and fed back
// as the A operand of P V without leaving the registers.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaBQ = 16 * kWarps;  // query rows per block
constexpr int kMmaBK = 64;           // keys per tile
static_assert(kMmaBQ == kMmaBK, "one tile loader serves Q, K and V");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even), `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

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

// the bf16 path takes 16-byte aligned rows: base pointers on 16 bytes and
// batch, token and head strides in multiples of 8 elements (the wrapper
// checks this first)
bool mma_aligned(const void* q, const void* k, const void* v,
                 const long long* st) {
  const unsigned long long bases = reinterpret_cast<unsigned long long>(q) |
                                   reinterpret_cast<unsigned long long>(k) |
                                   reinterpret_cast<unsigned long long>(v);
  if (bases % 16) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8) return false;
  return true;
}

bool dispatch_bf16(const void* q, const void* k, const void* v, void* o, int n,
                  int t, int h, int d, const long long* st, float scale,
                  cudaStream_t stream) {
  if (!mma_aligned(q, k, v, st)) return false;
  switch (d) {
    case 32: launch_mma<32>(q, k, v, o, n, t, h, st, scale, stream); return true;
    case 64: launch_mma<64>(q, k, v, o, n, t, h, st, scale, stream); return true;
    case 80: launch_mma<80>(q, k, v, o, n, t, h, st, scale, stream); return true;
    default: return false;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q (n, t, h), k (n, t, h),
// v (n, t, h), in elements. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a dtype, head dim or alignment this file does not
// take.
extern "C" int vtp_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int n, int t, int h, int d,
                                 int dtype, const long long* strides,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_f32(q, k, v, o, n, t, h, d, strides, scale, s);
  else if (dtype == 1)
    ok = dispatch_bf16(q, k, v, o, n, t, h, d, strides, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
