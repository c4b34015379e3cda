// K3 — s8 x s8 -> s32 GEMM with a fused dequantise epilogue, hand-written
// CUDA C++ for Hopper (sm_90a).
//
// Replaces: mvoc_tpu/ops/s8gemm.py `s8_matmul` / `_kernel` (the Pallas TPU
// kernel; pl.pallas_call at ops/s8gemm.py:101).
//
// Function (kept from the TPU kernel, in this order):
//   acc[m, n] = sum_k x[m, k] * w[k, n]            int8 x int8, int32 sums
//   out[m, n] = (float)acc * (sx[m] * sw[n])        fp32, no FMA contraction
//   out is rounded once to the output dtype (fp32 or bf16).
// Integer sums are exact whatever their order, and the epilogue is the same
// two IEEE multiplies, so the result is bitwise the plain version's
// (ops/s8gemm.py: s8_matmul_plain).  |acc| <= K * 127^2, so K must stay
// below 133,144 for int32; the wrapper refuses more.
//
// What bounds it on the H100: at the main path's shapes (M = 4096 .. 131072,
// K = 1280 .. 23040, N = 320 .. 10240) it does 2*M*K*N operations on
// M*K + K*N bytes in and 2-4 bytes per output: hundreds to thousands of
// operations per byte, so the int8 tensor cores (1979 TOP/s dense) bound
// it, not HBM.  This first version uses the tensor cores through warp-level
// mma.sync.m16n8k32 (s8 in, s32 out); it does not use wgmma, TMA or a
// multi-stage pipeline, so it runs well below that bound.  What it keeps
// for the later version: both operands K-contiguous (x [M, K] row-major,
// w as the [K, N] view of the [N, K] weight storage, read by strides: no
// transpose copies), the int32 accumulator in registers for the whole K
// loop, and the dequantise fused into the single store of the output.
//
// Design: one block per 128 x 128 output tile, 256 threads (8 warps as
// 2 x 4, a 64 x 32 warp tile = 4 x 4 mma tiles of 16 x 8).  The K loop
// stages a 128 x 64 tile of x and of w in shared memory (rows padded from 64
// to 80 bytes, so the 8 rows x 4 words a fragment load touches fall in 32
// different banks), then each warp runs 2 k-steps of 16 mma.sync.  Ragged
// M, N and K tails are zero-filled in shared memory: no padded copies in
// HBM.  When K and both row strides are multiples of 16 bytes, tiles load
// as 16-byte vectors (a 16-byte chunk is then wholly inside or outside K);
// otherwise (K = 36: the first image-latents conv) byte by byte.

#include "common.cuh"

namespace mvoc {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;  // shared-memory row pitch in bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage a kBM x kBK (or kBN x kBK) tile whose rows are K-contiguous:
// element (r, k) at src[(r0 + r) * ld + k0 + k], zero outside rows < R, k < K.
template <bool VEC>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src,
                                          int64_t ld, int r0, int R, int k0, int K) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    // 128 rows x 4 chunks of 16 bytes = 512 chunks, 2 per thread
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 16) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, kc = (c & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (r0 + r < R && k0 + kc < K) {
        v = *reinterpret_cast<const int4*>(src + (r0 + r) * ld + k0 + kc);
      }
      *reinterpret_cast<int4*>(dst + r * kRow + kc) = v;
    }
  } else {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      int8_t v = 0;
      if (r0 + r < R && k0 + k < K) v = src[(r0 + r) * ld + k0 + k];
      dst[r * kRow + k] = v;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
s8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw, T* __restrict__ out,
               int M, int N, int K, int64_t ldx, int64_t ldw, int64_t ldo) {
  __shared__ __align__(16) int8_t As[kBM * kRow];
  __shared__ __align__(16) int8_t Bs[kBN * kRow];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp tile origin
  const int g = lane >> 2, t = lane & 3;                  // mma fragment coordinates

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile<VEC>(As, x, ldx, m0, M, k0, K);
    load_tile<VEC>(Bs, w, ldw, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      const int kw = ks + t * 4;  // byte offset of this thread's first word
      int a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = As + (wm + i * 16 + g) * kRow + kw;
        const int8_t* r8 = r0 + 8 * kRow;
        a[i][0] = *reinterpret_cast<const int*>(r0);
        a[i][1] = *reinterpret_cast<const int*>(r8);
        a[i][2] = *reinterpret_cast<const int*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const int*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = Bs + (wn + j * 8 + g) * kRow + kw;
        b[j][0] = *reinterpret_cast<const int*>(c0);
        b[j][1] = *reinterpret_cast<const int*>(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: c0/c1 at (g, 2t / 2t+1), c2/c3 at (g+8, 2t / 2t+1) of each tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= M) continue;
      const float sxm = sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n >= N) continue;
          const float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), __fmul_rn(sxm, sw[n]));
          out[m * ldo + n] = from_f<T>(v);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* sx, const float* sw, void* out,
                   int M, int N, int K, int64_t ldx, int64_t ldw, int64_t ldo,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const bool vec = K % 16 == 0 && ldx % 16 == 0 && ldw % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  T* o = static_cast<T*>(out);
  if (vec) {
    s8_gemm_kernel<T, true><<<grid, kThreads, 0, stream>>>(x, w, sx, sw, o, M, N, K, ldx, ldw, ldo);
  } else {
    s8_gemm_kernel<T, false><<<grid, kThreads, 0, stream>>>(x, w, sx, sw, o, M, N, K, ldx, ldw, ldo);
  }
  return cudaGetLastError();
}

}  // namespace mvoc

// x: int8 [M, K], row stride ldx (elements), K contiguous.  w: int8, column
// n of the [K, N] operand at w + n * ldw, K contiguous (the [N, K] weight
// storage).  sx [M], sw [N] fp32 contiguous; out [M, N] with row stride ldo
// in the output dtype (0 fp32, 1 bf16).  Returns a cudaError_t.
extern "C" int mvoc_s8_gemm(const void* x, const void* w, const void* sx, const void* sw,
                            void* out, int dtype, int M, int N, int K, long long ldx,
                            long long ldw, long long ldo, void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  switch (dtype) {
    case kF32: return launch<float>(xp, wp, sxp, swp, out, M, N, K, ldx, ldw, ldo, s);
    case kBF16: return launch<__nv_bfloat16>(xp, wp, sxp, swp, out, M, N, K, ldx, ldw, ldo, s);
    default: return cudaErrorInvalidValue;
  }
}
