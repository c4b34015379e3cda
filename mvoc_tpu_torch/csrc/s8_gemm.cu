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
// it, not HBM.  Both designs keep both operands K-contiguous (x [M, K]
// row-major, w as the [K, N] view of the [N, K] weight storage, read by
// strides: no transpose copies), the int32 accumulator in registers for the
// whole K loop, and the dequantise fused into the single store of the
// output, straight from the accumulator registers.  Ragged M, N and K
// tails are zero-filled in shared memory: no padded copies in HBM.
//
// Variants, chosen by the wrapper from the operands' layout alone:
//  * wgmma (K, both row strides multiples of 16 bytes, 16-byte aligned
//    bases, both operands K-contiguous in place: every main-path call).
//    One block per 128 x 128 output tile, 288 threads: two consumer
//    warpgroups, each the 64 rows x 128 columns of wgmma m64n128k32
//    (s8 x s8 -> s32, both operands K-major in shared memory, 64 s32
//    accumulators a thread), and one producer warp.  One thread of the
//    producer streams 128-deep K tiles of x and w by TMA (tensor maps
//    encoded on the host for each launch, cuTensorMapEncodeTiled reached
//    through cudaGetDriverEntryPoint, so nothing links -lcuda) into a ring
//    of 3 stages, each signalling a "full" mbarrier with its bytes; the
//    consumers wait on it, issue 4 wgmmas, and release the stage one tile
//    later on its "empty" mbarrier once wgmma.wait_group 1 says that tile's
//    products are done, so copies run two tiles ahead of the products.
//    TMA writes the 128-byte swizzle that the wgmma descriptors read (one
//    128-int8 K row is one swizzle row) and zero-fills past M, N and K.  At
//    90 registers and 97 KB two blocks share an SM: one block's pipeline
//    fill and epilogue overlap the other's products (faster at every
//    heavy main-path shape than one 384-thread block an SM with a producer
//    warpgroup, 4 stages and 128 x 128 or 128 x 256 tiles).
//  * mma (any layout: K = 36 for the first image-latents conv, a row-major
//    [K, N] weight, which the wrapper re-lays; PR 2's design): one block
//    per 128 x 128 output tile, 256 threads (8 warps as 2 x 4, a 64 x 32
//    warp tile = 4 x 4 mma.sync.m16n8k32 tiles of 16 x 8), one shared-memory
//    stage of 128 x 64 of x and of w (rows padded from 64 to 80 bytes, so
//    the 8 rows x 4 words a fragment load touches fall in 32 different
//    banks), 2 k-steps of 16 mma.sync a warp.  When K and both row strides
//    are multiples of 16 bytes, tiles load as 16-byte vectors (a 16-byte
//    chunk is then wholly inside or outside K); otherwise byte by byte.

#include <cuda.h>

#include <chrono>

#include "common.cuh"
#include "hopper.cuh"

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
cudaError_t launch_mma(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
                       void* out, int M, int N, int K, int64_t ldx, int64_t ldw, int64_t ldo,
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

// ===========================================================================
// wgmma variant: TMA ring, one producer warp, two consumer warpgroups
// ===========================================================================

// 128 x 128 output tiles, 128-deep K tiles (one 128-byte swizzle row of
// int8), a ring of ST stages of A (128 x 128) and B (128 x 128) in shared
// memory.  288 threads: two consumer warpgroups (64 rows of the tile each)
// and one producer warp; at 90-odd registers and 97 KB two blocks share an
// SM, so one block's pipeline fill and epilogue overlap the other's
// products.
struct S8Wgmma {
  static constexpr int BM = 128, BN = 128, BK = 128, ST = 3, NT = 288;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE = A_BYTES + B_BYTES;
  static constexpr size_t smem = 1024 + ST * STAGE + 2 * ST * sizeof(uint64_t);
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b, bool pair, bool second) {
  if (pair) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(dst) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
    }
    return;
  }
  dst[0] = from_f<T>(a);
  if (second) dst[1] = from_f<T>(b);
}

template <typename T>
__global__ void __launch_bounds__(S8Wgmma::NT, 2)
s8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const float* __restrict__ sx, const float* __restrict__ sw, T* __restrict__ out,
                int M, int N, int K, int64_t ldo) {
  using C = S8Wgmma;
  constexpr int ST = C::ST, BN = C::BN;
  extern __shared__ __align__(1024) unsigned char smem_s8[];
  unsigned char* ring = align1024(smem_s8);  // stage s: A at s * STAGE, B after it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int nk = (K + C::BK - 1) / C::BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);     // the producer's arrival, plus the copies' bytes
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warp: one thread keeps ST - 1 tiles in flight ahead
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        mbar_wait(&empty[s], ((kt / ST) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&full[s], C::STAGE);
        unsigned char* a = ring + s * C::STAGE;
        tma_load_2d(a, &map_x, kt * C::BK, m0, &full[s]);
        tma_load_2d(a + C::A_BYTES, &map_w, kt * C::BK, n0, &full[s]);
      }
    }
    return;
  }

  const int c = tid >> 7;  // this warpgroup's 64 rows of the tile
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    mbar_wait(&full[s], (kt / ST) & 1);
    const unsigned char* a = ring + s * C::STAGE;
    const uint64_t da = wgmma_desc(a + c * 64 * C::BK, 16, 1024);
    const uint64_t db = wgmma_desc(a + C::A_BYTES, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 32; ++kk) WgmmaS8<BN>::ss(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done: release its stage
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % ST]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue from the accumulators: acc[4j + 2h + e] at row 16 warp + g +
  // 8h, column 8j + 2t + e of this warpgroup's 64 x BN
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + c * 64 + warp * 16 + g;
  const bool even = (ldo & 1) == 0;
  float sxm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sxm[h] = r0 + 8 * h < M ? sx[r0 + 8 * h] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= N) continue;
    const bool second = n + 1 < N;
    const float sw0 = sw[n], sw1 = second ? sw[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      const float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), __fmul_rn(sxm[h], sw0));
      const float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), __fmul_rn(sxm[h], sw1));
      store_pair<T>(out + m * ldo + n, v0, v1, even && second, second);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a K-contiguous int8 operand [rows, K] (row stride ld bytes),
// boxes of box_rows x 128, 128-byte swizzled, zeros outside.
cudaError_t encode(CUtensorMap* map, const int8_t* p, int rows, int K, int64_t ld, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_wgmma(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
                         void* out, int M, int N, int K, int64_t ldx, int64_t ldw, int64_t ldo,
                         cudaStream_t stream) {
  using C = S8Wgmma;
  const dim3 grid(static_cast<unsigned>((N + C::BN - 1) / C::BN),
                  static_cast<unsigned>((M + C::BM - 1) / C::BM));
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap mx, mw;
  cudaError_t err = encode(&mx, x, M, K, ldx, C::BM);
  if (err == cudaSuccess) err = encode(&mw, w, N, K, ldw, C::BN);
  if (err != cudaSuccess) return err;
  auto kernel = s8_wgmma_kernel<T>;
  if ((err = prepare_smem(kernel, C::smem)) != cudaSuccess) return err;
  kernel<<<grid, C::NT, C::smem, stream>>>(mx, mw, sx, sw, static_cast<T*>(out), M, N, K, ldo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int variant, const int8_t* x, const int8_t* w, const float* sx,
                   const float* sw, void* out, int M, int N, int K, int64_t ldx, int64_t ldw,
                   int64_t ldo, cudaStream_t stream) {
  switch (variant) {
    case 0: return launch_mma<T>(x, w, sx, sw, out, M, N, K, ldx, ldw, ldo, stream);
    case 1: return launch_wgmma<T>(x, w, sx, sw, out, M, N, K, ldx, ldw, ldo, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mvoc

// variant: 0 mma (PR 2's mma.sync kernel: any layout), 1 wgmma (TMA: K,
// ldx and ldw multiples of 16 bytes, 16-byte aligned x and w; the wrapper
// checks).  x: int8 [M, K], row stride
// ldx (elements), K contiguous.  w: int8, column n of the [K, N] operand at
// w + n * ldw, K contiguous (the [N, K] weight storage).  sx [M], sw [N]
// fp32 contiguous; out [M, N] with row stride ldo in the output dtype (0
// fp32, 1 bf16).  Returns a cudaError_t.
extern "C" int mvoc_s8_gemm(const void* x, const void* w, const void* sx, const void* sw,
                            void* out, int variant, int dtype, int M, int N, int K,
                            long long ldx, long long ldw, long long ldo, void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  switch (dtype) {
    case kF32: return launch<float>(variant, xp, wp, sxp, swp, out, M, N, K, ldx, ldw, ldo, s);
    case kBF16:
      return launch<__nv_bfloat16>(variant, xp, wp, sxp, swp, out, M, N, K, ldx, ldw, ldo, s);
    default: return cudaErrorInvalidValue;
  }
}

// Host microseconds per launch spent encoding the wgmma variant's two
// tensor maps, mean over `reps` (the pointers are not dereferenced).
extern "C" double mvoc_s8_encode_us(const void* x, const void* w, int M, int N, int K,
                                    long long ldx, long long ldw, int reps) {
  using namespace mvoc;
  CUtensorMap mx, mw;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    if (encode(&mx, static_cast<const int8_t*>(x), M, K, ldx, 128) != cudaSuccess ||
        encode(&mw, static_cast<const int8_t*>(w), N, K, ldw, 128) != cudaSuccess) {
      return -1.0;
    }
  }
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}
