// Fused GroupNorm (with an optional SiLU epilogue) and LayerNorm for the
// channels-last activations of the I2VGen-XL stack, hand-written CUDA C++
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes its norms as jnp
// expressions (mvoc_tpu/models/layers.py GroupNorm / LayerNorm) and XLA
// fuses each into a reduction and one elementwise pass.  PyTorch runs the
// same expression (models/layers.py before this kernel) as ~21 eager passes
// over fp32 temporaries a GroupNorm and ~11 a LayerNorm; this file is what
// XLA's fusion did.
//
// Function (ops/norm.py: group_norm_plain / layer_norm_plain):
//   GroupNorm over x [B, S, C] (S = H*W per frame, or F*H*W for the joint
//   statistics of a 5-D input), G groups of C/G channels:
//     mean_g, var_g = centred moments over (S, C/G) in fp32
//     a_c = T(rsqrt(var_g + eps) * w_c),  b_c = T(bias_c - mean_g * rsqrt(.) * w_c)
//     y = T(x * a_c + b_c)                        (then y = T(silu(.)) if asked)
//   LayerNorm over the last dim D of x [rows, D]:
//     y = T((x - mean) * rsqrt(var + eps) * T(w) + T(bias))
//   T is the activation dtype (bf16 or fp32); statistics are fp32 and
//   centred (never E[x^2] - E[x]^2), so a mean far above the spread costs no
//   precision.  The plain versions round x*a and the affine separately; the
//   kernels round once at the end.
//
// What bounds it on the H100: bytes.  A norm does a few operations per
// element on 2-4 bytes of it, far below the ~295 operations a byte the card
// needs to be bound by arithmetic.  So the design moves each element as few
// times as it can and every access is a 16-byte vector where the shape
// allows (GroupNorm: 8 channels a thread, one bf16 or two fp32 vectors):
//  * GroupNorm, 3 launches, 2 reads and 1 write of x:
//    group_norm_stats: a block per (sample, tile of R rows), blockDim
//      (V = C/VEC, BY), R = BY * kRowsPerThread.  Each thread keeps its
//      kRowsPerThread vectors in registers, so the tile's group means and
//      then its centred second moments come from one read.  Per-channel
//      sums are reduced over BY through shared memory and over each
//      group's channels in a fixed order, and the tile writes (mean, M2)
//      for each group.
//    group_norm_finalize: a block per (group, sample) merges the tiles'
//      partials in a fixed tree order (mean = m_0 + sum n_t (mean_t - m_0)
//      / N, then M2 = sum M2_t + n_t (mean_t - mean)^2, both centred) and
//      writes the group's per-channel coefficients a_c, b_c, rounded to T.
//      Where a sample's frames are split over ranks, each rank runs the
//      stats kernel on its frames, the partials are all-gathered in rank
//      order, and the merge runs over every rank's tiles: the same
//      coefficients, bit for bit, on every rank.
//    group_norm_apply: the same (sample, tile) grid; each thread loads its
//      channels' a_c, b_c once and streams its rows: y = fma(x, a, b),
//      SiLU when asked, one rounding, one 16-byte store.
//  * LayerNorm, 1 launch, 1 read and 1 write: `tpr` lanes of a warp own one
//    row (a power of two dividing the row's vector count, so a 320-wide
//    bf16 row is 8 lanes x 5 vectors and a 4-wide one a single thread),
//    hold it in registers, and reduce the sum and then the centred sum of
//    squares by xor shuffles inside their group.
// Every reduction runs in an order fixed by the shape alone (no atomics),
// so a norm gives the same bits on every run.

#include <type_traits>

#include "common.cuh"

namespace mvoc {
namespace {

// rows a thread of the GroupNorm stats / apply kernels owns; ops/norm.py
// (GN_ROWS_PER_THREAD) sizes the partials' buffer with the same number
constexpr int kRowsPerThread = 8;
// threads a GroupNorm stats / apply block may have (ops/norm.py GN_MAX_THREADS)
constexpr int kMaxBlock = 512;
constexpr int kFinalizeThreads = 256;
constexpr int kLayerNormThreads = 256;

// N values loaded and stored as one 16-byte vector (two for 8 fp32), or
// narrower where N * sizeof(T) is
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

// an affine parameter, read as fp32 from its own dtype (fp32 or bf16)
__device__ __forceinline__ float param(const void* p, int dtype, int i) {
  return dtype == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                        : static_cast<const float*>(p)[i];
}

// SiLU with the fast exponential and division: a few ulp of fp32, far below
// what the bf16 output keeps, and it keeps the apply pass bound by bytes
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// the sum over a power-of-two block, in a fixed tree order; red has
// blockDim.x floats; every thread gets the total
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// stage [by][C] (each thread's per-channel sums) summed over by into its
// first row, in a fixed order; then every thread may read stage[c]
__device__ __forceinline__ void sum_rows(float* stage, int by, int C, int tid, int nthreads) {
  for (int c = tid; c < C; c += nthreads) {
    float s = stage[c];
    for (int y = 1; y < by; ++y) s += stage[y * C + c];
    stage[c] = s;
  }
  __syncthreads();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxBlock)
    group_norm_stats(const T* __restrict__ x, float2* __restrict__ part, int S, int C, int G,
                     int n_tiles) {
  extern __shared__ float sm[];
  const int tx = threadIdx.x, ty = threadIdx.y, by = blockDim.y, V = blockDim.x;
  float* stage = sm;            // [by][C]
  float* gmean = sm + by * C;   // [G]
  const int cpg = C / G;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * by * kRowsPerThread;
  const int nrows = min(by * kRowsPerThread, S - r0);
  const T* xb = x + (b * S + r0) * static_cast<long long>(C) + tx * VEC;
  Pack<T, VEC> buf[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * by;
    if (r < nrows) buf[k] = *reinterpret_cast<const Pack<T, VEC>*>(xb + static_cast<long long>(r) * C);
  }
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (ty + k * by < nrows) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f(buf[k].v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) stage[ty * C + tx * VEC + j] = acc[j];
  __syncthreads();
  const int tid = ty * V + tx, nthreads = V * by;
  sum_rows(stage, by, C, tid, nthreads);
  const float n_tile = static_cast<float>(nrows) * cpg;
  for (int g = tid; g < G; g += nthreads) {
    float s = 0.0f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) s += stage[c];
    gmean[g] = s / n_tile;
  }
  __syncthreads();
  float gm[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    gm[j] = gmean[(tx * VEC + j) / cpg];
    acc[j] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (ty + k * by < nrows) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_f(buf[k].v[j]) - gm[j];
        acc[j] += d * d;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) stage[ty * C + tx * VEC + j] = acc[j];
  __syncthreads();
  sum_rows(stage, by, C, tid, nthreads);
  float2* out = part + (b * n_tiles + blockIdx.x) * G;
  for (int g = tid; g < G; g += nthreads) {
    float s = 0.0f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) s += stage[c];
    out[g] = make_float2(gmean[g], s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinalizeThreads)
    group_norm_finalize(const float2* __restrict__ part, const void* weight, const void* bias,
                        int wdtype, T* __restrict__ coef, int B, int S, int C, int G,
                        int n_tiles, int n_ranks, int rows_per_tile, float eps) {
  __shared__ float red[kFinalizeThreads];
  const int g = blockIdx.x, tid = threadIdx.x, cpg = C / G;
  const long long b = blockIdx.y;
  // part is [n_ranks, B, n_tiles, G]: tile u of the n_ranks * n_tiles is
  // rank u / n_tiles's tile u % n_tiles, each rank holding S rows
  const float2* p = part + b * n_tiles * G + g;
  const long long rank_stride = static_cast<long long>(B) * n_tiles * G;
  const int n_all_tiles = n_ranks * n_tiles;
  auto at = [&](int u, float& n_t) {
    const int r = u / n_tiles, t = u - r * n_tiles;
    n_t = static_cast<float>(min(rows_per_tile, S - t * rows_per_tile)) * cpg;
    return p[r * rank_stride + static_cast<long long>(t) * G];
  };
  const float n_all = static_cast<float>(n_ranks) * S * cpg;
  // the tiles' means as deviations from the first one's: small terms, so a
  // mean far above the spread loses nothing in the sum
  const float m0 = p[0].x;
  float acc = 0.0f, n_t;
  for (int u = tid; u < n_all_tiles; u += blockDim.x) {
    const float2 q = at(u, n_t);
    acc += n_t * (q.x - m0);
  }
  const float mean = m0 + block_sum(acc, red) / n_all;
  acc = 0.0f;
  for (int u = tid; u < n_all_tiles; u += blockDim.x) {
    const float2 q = at(u, n_t);
    const float d = q.x - mean;
    acc += q.y + n_t * d * d;
  }
  const float var = block_sum(acc, red) / n_all;
  const float inv = rsqrtf(var + eps);
  T* a_out = coef + b * C;                       // a: [B, C]
  T* b_out = coef + (static_cast<long long>(B) + b) * C;  // b: [B, C] after it
  for (int c = g * cpg + tid; c < (g + 1) * cpg; c += blockDim.x) {
    const float w = param(weight, wdtype, c);
    a_out[c] = from_f<T>(inv * w);
    b_out[c] = from_f<T>(param(bias, wdtype, c) - mean * inv * w);
  }
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kMaxBlock)
    group_norm_apply(const T* __restrict__ x, const T* __restrict__ coef, T* __restrict__ y,
                     int B, int S, int C) {
  const int tx = threadIdx.x, ty = threadIdx.y, by = blockDim.y;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * by * kRowsPerThread;
  const int nrows = min(by * kRowsPerThread, S - r0);
  const long long base = (b * S + r0) * static_cast<long long>(C) + tx * VEC;
  const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(coef + b * C + tx * VEC);
  const Pack<T, VEC> sh =
      *reinterpret_cast<const Pack<T, VEC>*>(coef + (B + b) * C + tx * VEC);
  float af[VEC], bf[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    af[j] = to_f(a.v[j]);
    bf[j] = to_f(sh.v[j]);
  }
  Pack<T, VEC> buf[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * by;
    if (r < nrows)
      buf[k] = *reinterpret_cast<const Pack<T, VEC>*>(x + base + static_cast<long long>(r) * C);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * by;
    if (r < nrows) {
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = fmaf(to_f(buf[k].v[j]), af[j], bf[j]);
        if (SILU) v = silu(v);
        o.v[j] = from_f<T>(v);
      }
      *reinterpret_cast<Pack<T, VEC>*>(y + base + static_cast<long long>(r) * C) = o;
    }
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kLayerNormThreads)
    layer_norm_rows(const T* __restrict__ x, const T* __restrict__ weight,
                    const T* __restrict__ bias, T* __restrict__ y, int rows, int D, int tpr,
                    float eps) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x % tpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const int nvec = D / VEC;
  const T* xr = x + row * D;
  P buf[NV];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + i * tpr;
    if (live && v < nvec) {
      buf[i] = *reinterpret_cast<const P*>(xr + v * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += to_f(buf[i].v[j]);
    }
  }
  // every lane of the warp takes part in the shuffles (dead rows add 0)
  for (int off = tpr / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + i * tpr;
    if (live && v < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_f(buf[i].v[j]) - mean;
        q += d * d;
      }
    }
  }
  for (int off = tpr / 2; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float inv = rsqrtf(q / D + eps);
  T* yr = y + row * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + i * tpr;
    if (live && v < nvec) {
      const P w = *reinterpret_cast<const P*>(weight + v * VEC);
      const P bb = *reinterpret_cast<const P*>(bias + v * VEC);
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f<T>(fmaf((to_f(buf[i].v[j]) - mean) * inv, to_f(w.v[j]), to_f(bb.v[j])));
      *reinterpret_cast<P*>(yr + v * VEC) = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_group_norm_stats(const void* x, void* part, int B, int S, int C, int G, int by,
                                    int n_tiles, cudaStream_t s) {
  const int V = C / VEC, rows_per_tile = by * kRowsPerThread;
  if (V * VEC != C || V * by > kMaxBlock || n_tiles != (S + rows_per_tile - 1) / rows_per_tile)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(by) * C + G) * sizeof(float);
  cudaError_t err = prepare_smem(group_norm_stats<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  group_norm_stats<T, VEC><<<dim3(n_tiles, B), dim3(V, by), smem, s>>>(
      static_cast<const T*>(x), static_cast<float2*>(part), S, C, G, n_tiles);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_group_norm_finish(const void* x, const void* weight, const void* bias,
                                     int wdtype, void* y, const void* part, void* coef, int B,
                                     int S, int C, int G, int by, int n_tiles, int n_ranks,
                                     float eps, bool act, cudaStream_t s) {
  const int V = C / VEC, rows_per_tile = by * kRowsPerThread;
  if (V * VEC != C || V * by > kMaxBlock || n_ranks <= 0 ||
      n_tiles != (S + rows_per_tile - 1) / rows_per_tile)
    return cudaErrorInvalidValue;
  int threads = 32;
  while (threads < n_ranks * n_tiles && threads < kFinalizeThreads) threads *= 2;
  group_norm_finalize<T><<<dim3(G, B), threads, 0, s>>>(
      static_cast<const float2*>(part), weight, bias, wdtype, static_cast<T*>(coef), B, S, C, G,
      n_tiles, n_ranks, rows_per_tile, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 block(V, by), grid(n_tiles, B);
  if (act)
    group_norm_apply<T, VEC, true><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(coef), static_cast<T*>(y), B, S, C);
  else
    group_norm_apply<T, VEC, false><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(coef), static_cast<T*>(y), B, S, C);
  return cudaGetLastError();
}

// f(T*, integral_constant<VEC>) for the activation dtype and the channels a
// thread loads at once
template <typename F>
cudaError_t dispatch_group_norm(int dtype, int vec, F&& f) {
  if (dtype == kBF16 && vec == 8)
    return f(static_cast<__nv_bfloat16*>(nullptr), std::integral_constant<int, 8>{});
  if (dtype == kBF16 && vec == 1)
    return f(static_cast<__nv_bfloat16*>(nullptr), std::integral_constant<int, 1>{});
  if (dtype == kF32 && vec == 8)
    return f(static_cast<float*>(nullptr), std::integral_constant<int, 8>{});
  if (dtype == kF32 && vec == 1)
    return f(static_cast<float*>(nullptr), std::integral_constant<int, 1>{});
  return cudaErrorInvalidValue;
}

bool group_norm_args_ok(int B, int S, int C, int G, int by) {
  return B > 0 && S > 0 && C > 0 && G > 0 && C % G == 0 && by > 0;
}

template <typename T, int VEC, int NV>
cudaError_t launch_layer_norm_nv(const void* x, const void* weight, const void* bias, void* y,
                                 int rows, int D, int tpr, float eps, cudaStream_t s) {
  const int per_block = kLayerNormThreads / tpr;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(rows) + per_block - 1) /
                                                per_block);
  layer_norm_rows<T, VEC, NV><<<blocks, kLayerNormThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), static_cast<const T*>(bias),
      static_cast<T*>(y), rows, D, tpr, eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_layer_norm(const void* x, const void* weight, const void* bias, void* y,
                              int rows, int D, int nv, int tpr, float eps, cudaStream_t s) {
  switch (nv) {
#define MVOC_LN_CASE(N) \
  case N: return launch_layer_norm_nv<T, VEC, N>(x, weight, bias, y, rows, D, tpr, eps, s);
    MVOC_LN_CASE(1) MVOC_LN_CASE(2) MVOC_LN_CASE(3) MVOC_LN_CASE(4) MVOC_LN_CASE(5)
    MVOC_LN_CASE(8) MVOC_LN_CASE(10) MVOC_LN_CASE(16)
#undef MVOC_LN_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mvoc

// GroupNorm of x [B, S, C] (contiguous) with G groups -> y (contiguous, x's
// shape), as two steps: mvoc_group_norm_stats writes each tile's (mean, M2)
// for each group into part [B, n_tiles, G] (float2), and
// mvoc_group_norm_finish merges the partials of n_ranks such x (part
// [n_ranks, B, n_tiles, G], each rank's S rows: one sample's frames split
// over ranks, its partials all-gathered in rank order) into the
// coefficients coef (B * C * 2 values of x's dtype, a_c then b_c), then
// applies them to this x.  mvoc_group_norm runs both with n_ranks = 1.
// vec: channels a thread loads at once (8: one 16-byte bf16 or two fp32
// vectors, or 1); by: rows of threads in a block, (C / vec) * by <= 512;
// n_tiles = ceil(S / (by * 8)).  dtype: activations (0 fp32, 1 bf16);
// wdtype: the affine parameters'.
extern "C" int mvoc_group_norm_stats(const void* x, void* part, int dtype, int B, int S, int C,
                                     int G, int vec, int by, int n_tiles, void* stream) {
  using namespace mvoc;
  if (!group_norm_args_ok(B, S, C, G, by)) return cudaErrorInvalidValue;
  return dispatch_group_norm(dtype, vec, [&](auto t, auto v) {
    return launch_group_norm_stats<std::remove_pointer_t<decltype(t)>, decltype(v)::value>(
        x, part, B, S, C, G, by, n_tiles, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int mvoc_group_norm_finish(const void* x, const void* weight, const void* bias,
                                      void* y, const void* part, void* coef, int dtype,
                                      int wdtype, int B, int S, int C, int G, int vec, int by,
                                      int n_tiles, int n_ranks, float eps, int silu,
                                      void* stream) {
  using namespace mvoc;
  if (!group_norm_args_ok(B, S, C, G, by) || (wdtype != kF32 && wdtype != kBF16))
    return cudaErrorInvalidValue;
  return dispatch_group_norm(dtype, vec, [&](auto t, auto v) {
    return launch_group_norm_finish<std::remove_pointer_t<decltype(t)>, decltype(v)::value>(
        x, weight, bias, wdtype, y, part, coef, B, S, C, G, by, n_tiles, n_ranks, eps,
        silu != 0, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int mvoc_group_norm(const void* x, const void* weight, const void* bias, void* y,
                               void* part, void* coef, int dtype, int wdtype, int B, int S,
                               int C, int G, int vec, int by, int n_tiles, float eps, int silu,
                               void* stream) {
  const int err = mvoc_group_norm_stats(x, part, dtype, B, S, C, G, vec, by, n_tiles, stream);
  if (err != 0) return err;
  return mvoc_group_norm_finish(x, weight, bias, y, part, coef, dtype, wdtype, B, S, C, G, vec,
                                by, n_tiles, 1, eps, silu, stream);
}

// LayerNorm over the last dim D of x [rows, D] (contiguous) -> y of the same
// shape; weight and
// bias [D] in x's dtype.  vec: elements a lane loads at once (16 or 8 bytes'
// worth, or 1); tpr: lanes a row (a power of two up to 32); nv: vectors a
// lane holds (1, 2, 3, 4, 5, 8, 10 or 16; the last ones masked past the
// row's end).
extern "C" int mvoc_layer_norm(const void* x, const void* weight, const void* bias, void* y,
                               int dtype, int rows, int D, int vec, int nv, int tpr, float eps,
                               void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || D % vec != 0 || tpr <= 0 || tpr > 32 || (tpr & (tpr - 1)) != 0 ||
      (D / vec) > nv * tpr)
    return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    switch (vec) {
      case 8: return launch_layer_norm<__nv_bfloat16, 8>(x, weight, bias, y, rows, D, nv, tpr, eps, s);
      case 4: return launch_layer_norm<__nv_bfloat16, 4>(x, weight, bias, y, rows, D, nv, tpr, eps, s);
      case 1: return launch_layer_norm<__nv_bfloat16, 1>(x, weight, bias, y, rows, D, nv, tpr, eps, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    switch (vec) {
      case 4: return launch_layer_norm<float, 4>(x, weight, bias, y, rows, D, nv, tpr, eps, s);
      case 2: return launch_layer_norm<float, 2>(x, weight, bias, y, rows, D, nv, tpr, eps, s);
      case 1: return launch_layer_norm<float, 1>(x, weight, bias, y, rows, D, nv, tpr, eps, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
