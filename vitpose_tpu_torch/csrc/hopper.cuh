// Building blocks shared by csrc/attention_fwd.cu and csrc/attention_bwd.cu:
// mma.sync and ldmatrix for bf16, wgmma with its shared-memory descriptors,
// the shared-memory layouts that TMA writes, mbarriers, TMA loads and
// stores, and the host-side tensor maps.
//
// Layout of a [rows][D] bf16 tile in shared memory, as TMA writes it:
//   D = 64: 128-byte rows, 128-byte swizzle (the layout wgmma reads);
//   D = 32: 64-byte rows, 64-byte swizzle;
//   D = 80: 160-byte rows, no swizzle (a swizzle span holds at most 128
//           bytes of a row).
// The swizzle XORs the 16-byte chunk index with bits 7-9 (128B) or 7-8
// (64B) of the byte offset, so the 8 rows an ldmatrix reads fall in
// distinct banks. `tile_addr<D>` gives the address of a chunk.

#pragma once

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up
                   // through the runtime, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and its fragment loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  uint32_t addr) {
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

// This thread's lane and warp, read where they are used: a volatile read
// cannot be hoisted, so what is derived from it (addresses, masks) is
// computed in the phase that needs it instead of being held in registers
// through the phases before it.
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return lane;
}

__device__ __forceinline__ int warp_id() {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  return tid / 32;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

// two floats -> bf16x2 (round to nearest even), `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// bytes of one [NT * 64][D] bf16 tile: the box of one (batch, head) pair in
// the whole-pair kernels
template <int D, int NT>
__host__ __device__ constexpr int tile_bytes() {
  return NT * 64 * D * 2;
}

// shared address of 16-byte chunk `chunk` of row `row` of the [rows][D]
// bf16 tile at `base` (1024-byte aligned), as TMA lays it out (see the head
// of this file). The swizzle is an XOR of the address with row bits, and
// every caller's rows are lane-aligned, so the XOR term is one value per
// lane rather than one per chunk.
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row,
                                              int chunk) {
  if constexpr (D == 64)
    return (base + row * 128 + chunk * 16) ^ ((row & 7) << 4);
  else if constexpr (D == 32)
    return (base + row * 64 + chunk * 16) ^ (((row >> 1) & 3) << 4);
  else
    return base + row * (D * 2) + chunk * 16;
}

// A fragments of rows [r0, r0 + 16) x D of the tile at `base`
template <int D>
__device__ __forceinline__ void load_a(unsigned (&f)[D / 16][4], uint32_t base,
                                       int r0, int lane) {
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], tile_addr<D>(base, r0 + (mi % 2) * 8 + lane % 8,
                                    kk * 2 + mi / 2));
}

// c = a (16 x D) * b^T, b rows [b0, b0 + NC) of the tile at `base`:
// 16 x NC in NC / 8 column groups
template <int D, int NC>
__device__ __forceinline__ void mma_abt(float (&c)[NC / 8][4],
                                        const unsigned (&a)[D / 16][4],
                                        uint32_t base, int b0, int lane) {
  const int mi = lane / 8;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NC / 8; j += 2) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned r[4];
      ldmatrix_x4(r, tile_addr<D>(base, b0 + j * 8 + (mi / 2) * 8 + lane % 8,
                                  kk * 2 + mi % 2));
      mma_bf16(c[j], a[kk], r[0], r[1]);
      mma_bf16(c[j + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc (16 x D) += a (16 x NK) * b, b rows [b0, b0 + NK) of the tile at
// `base`, read through ldmatrix.trans
template <int D, int NK>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const unsigned (&a)[NK / 16][4],
                                       uint32_t base, int b0, int lane) {
  static_assert((D / 8) % 2 == 0, "column groups go in pairs");
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      unsigned r[4];
      ldmatrix_x4_trans(
          r, tile_addr<D>(base, b0 + kk * 16 + (mi % 2) * 8 + lane % 8,
                          dn + mi / 2));
      mma_bf16(acc[dn], a[kk], r[0], r[1]);
      mma_bf16(acc[dn + 1], a[kk], r[2], r[3]);
    }
  }
}

// a 16 x NC accumulator, rounded to bf16, as the A operand of the next
// product
template <int NC>
__device__ __forceinline__ void to_a(unsigned (&a)[NC / 16][4],
                                     const float (&x)[NC / 8][4]) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(x[j][0], x[j][1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// 4 bytes into shared memory at a 32-bit shared-window address (a generic
// pointer would take two registers per address where the compiler hoists
// addresses out of a loop)
__device__ __forceinline__ void st_shared(uint32_t addr, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// rows r0 + lane/4 and r0 + lane/4 + 8 of a warp's 16 x D accumulator,
// times `mul`, as bf16 into the tile at `base`, in the layout a TMA store
// reads
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t base,
                                           const float (&acc)[D / 8][4],
                                           float mul, int r0, int lane) {
  const int g = r0 + lane / 4;
  const int c = 4 * (lane % 4);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    st_shared(tile_addr<D>(base, g, dn) + c,
              pack_bf16(acc[dn][0] * mul, acc[dn][1] * mul));
    st_shared(tile_addr<D>(base, g + 8, dn) + c,
              pack_bf16(acc[dn][2] * mul, acc[dn][3] * mul));
  }
}

// ---------------------------------------------------------------------------
// wgmma: 64-row products of one warpgroup (128 threads), bf16 in, f32
// accumulate. The accumulator d[8][4] of a 64 x 64 product is laid out as
// eight mma.sync 16 x 8 groups per warp: warp w of the warpgroup holds rows
// 16w + lane/4 (d[j][0..1]) and 16w + lane/4 + 8 (d[j][2..3]), columns
// 8j + 2(lane%4) + {0, 1}. An A operand in registers has mma.sync's A
// fragment layout, so `to_a` feeds it.
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a [rows][64] bf16 tile in the 128-byte
// swizzle (1024-byte aligned groups of 8 rows): start address, 1024 bytes
// between groups of 8 rows (SBO), swizzle mode 1. The leading offset (LBO)
// steps between 64-column blocks, which a 64-wide operand does not have; it
// is set to 1024 too, so that either field gives the row-group stride.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d += a b^T: a (64 x 16) and b (64 x 16) both K-major in shared memory
// (64 rows of a tile, 16 of their columns; the descriptor's start address
// steps 32 bytes along the row for each 16 columns)
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10,"
      " %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21,"
      " %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d += a b: a (64 x 16) in registers, b (16 x 64) MN-major in shared memory
// (16 rows of a [rows][64] tile, 2048 bytes apart for each 16 rows)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10,"
      " %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21,"
      " %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b^T as wgmma_ss, 64 x 32: b is 32 rows of a tile
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10,"
      " %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d += a b with both operands MN-major in shared memory: a (64 x 16) is 16
// rows of a [rows][64] tile read transposed, b (16 x 64) as in wgmma_rs
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[8][4], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10,"
      " %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21,"
      " %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barrier's arrival, expecting `bytes` from TMA before its phase flips
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// barrier initialisation visible to the TMA unit
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// generic-proxy writes to shared memory visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one [rows][D] box at coordinates (0, h, 0, n) of a map made by
// `make_map`, into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(0), "r"(n),
      "r"(bar)
      : "memory");
}

// the reverse: shared memory to the box at (0, h, 0, n); rows past the
// tensor's length are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(h), "r"(0), "r"(n)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's committed stores have read their shared memory (their
// writes to device memory complete before the kernel does)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

inline CUtensorMapSwizzle swizzle_for(int d) {
  return d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
         : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// what a launch returns when cuTensorMapEncodeTiled refuses a tensor map:
// this plus the CUresult (the wrapper says so)
constexpr int kMapError = 1000;

// The runtime binds its context to a thread at the thread's first runtime
// call; cuTensorMapEncodeTiled needs it bound (a host thread of
// autograd's backward may have made no runtime call yet).
inline cudaError_t bind_context(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  return err != cudaSuccess ? err : cudaSetDevice(*dev);
}

// devices a process may use: the size of the per-device launch caches
constexpr int kMaxDevices = 64;

// A map of a bf16 [N, T, H, d] view with strides (sn, st, sh) in elements,
// as 4-D (d, h, t, n), whose box is one (batch, head) pair: `rows` tokens
// (zero-filled past T on a load) by d. Returns 0, or kMapError plus the
// encoder's CUresult if it refuses the map (bases on 16 bytes and strides in
// multiples of 16 bytes are required).
inline int make_map(CUtensorMap* map, const void* base, int n, int t, int h,
                    int d, long long sn, long long st, long long sh,
                    int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sn * 2};
  const cuuint32_t box[4] = {(cuuint32_t)d, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(d),
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(res);
}

// the bf16 kernels take 16-byte aligned rows: base pointers on 16 bytes and
// batch, token and head strides in multiples of 8 elements (the wrapper
// checks this first)
inline bool aligned16(const void* const* ptrs, int n_ptrs,
                      const long long* strides, int n_strides) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8) return false;
  return true;
}

}  // namespace hopper
