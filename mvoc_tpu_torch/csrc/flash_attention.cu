// K1 — flash attention, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces: mvoc_tpu/ops/attention.py `flash_attention` / `_flash_kernel`
// (the Pallas TPU kernel; pl.pallas_call at ops/attention.py:148).
//
// Function (kept from the TPU kernel, in this order):
//   q' = round_to_input_dtype(q * 1/sqrt(D))        (scaled once, rounded)
//   s  = q' k^T in fp32; key columns >= Sk get -1e30 (finite, never -inf)
//   online softmax over key tiles: m, l and the accumulator in fp32;
//   p = exp(s - m) is rounded to the input dtype before the P.V product;
//   out = acc / l, cast to the input dtype.
//
// What bounds it on the H100: at the main path's shapes (S = 4096 or 1024,
// D = 64) it does 4*Sq*Sk*D operations for (2*Sq + 2*Sk)*D elements of I/O,
// ~1000 operations per byte in bf16: bound by the tensor cores' 989 TF/s,
// not by the 3.35 TB/s of HBM.  This first version computes the two
// products with FP32 FMAs out of shared memory, not with tensor cores, so
// it runs well below that bound; the design keeps what matters for the
// later wgmma/TMA version: no [Sq, Sk] logits in HBM, q/k/v read through
// their strides (the [B, S, H, D] projections need no transpose copy),
// and one pass over K/V per query tile.
//
// Design: one block per (batch*head, query tile of BQ rows), NT threads.
// K/V tiles of BK rows stream through shared memory.  Each thread owns one
// key column of the logits tile (K rows padded by one 32-bit word, so the
// column reads do not hit one bank) and a fixed set of output elements,
// whose fp32 accumulators live in registers for the whole key loop.  One
// warp per query row does the online-softmax update.  D = 64 (UNet) takes
// 64x64 tiles; D = 512 (the VAE's single-head mid-block attention) takes
// 16x32 tiles, ~83 KB (bf16) or ~166 KB (fp32) of dynamic shared memory,
// under the 227 KB a block may use, opted into with cudaFuncSetAttribute.

#include "common.cuh"

namespace mvoc {

template <typename T, int D, int BQ, int BK, int NT>
struct FlashCfg {
  static constexpr int KSTR = D + 4 / static_cast<int>(sizeof(T));
  static constexpr int RS = BQ * BK / NT;  // logits per thread
  static constexpr int RO = BQ * D / NT;   // output accumulators per thread
  static_assert(NT % BK == 0 && BK >= 32, "a warp must share one query row");
  static_assert((BQ * BK) % NT == 0 && (BQ * D) % NT == 0, "tile/thread mismatch");
  static constexpr size_t smem_bytes() {
    return sizeof(float) * (BQ * BK + 3 * BQ) +
           sizeof(T) * (static_cast<size_t>(BQ) * D + BK * KSTR + BK * D);
  }
};

template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int Sq, int Sk,
             int64_t qsb, int64_t qsh, int64_t qss,
             int64_t ksb, int64_t ksh, int64_t kss,
             int64_t vsb, int64_t vsh, int64_t vss,
             int64_t osb, int64_t osh, int64_t oss, float scale) {
  using C = FlashCfg<T, D, BQ, BK, NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ss = reinterpret_cast<float*>(smem_raw);  // [BQ][BK] logits, then p
  float* m_s = Ss + BQ * BK;                       // running max per row
  float* l_s = m_s + BQ;                           // running denominator per row
  float* a_s = l_s + BQ;                           // this tile's rescale per row
  T* Qs = reinterpret_cast<T*>(a_s + BQ);          // [BQ][D], pre-scaled
  T* Ks = Qs + BQ * D;                             // [BK][KSTR]
  T* Vs = Ks + BK * C::KSTR;                       // [BK][D]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  T* op = o + b * osb + h * osh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D, d = e % D;
    const int row = q0 + i;
    const float x = row < Sq ? to_f<T>(qp[row * qss + d]) * scale : 0.f;
    Qs[e] = from_f<T>(x);
  }
  for (int i = tid; i < BQ; i += NT) {
    m_s[i] = kNegBig;
    l_s[i] = 0.f;
  }

  float acc[C::RO];
#pragma unroll
  for (int r = 0; r < C::RO; ++r) acc[r] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  constexpr int NW = NT / 32;
  const int n_kt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed; Q and stats are written
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      const int col = k0 + j;
      T kv = from_f<T>(0.f), vv = from_f<T>(0.f);
      if (col < Sk) {
        kv = kp[col * kss + d];
        vv = vp[col * vss + d];
      }
      Ks[j * C::KSTR + d] = kv;
      Vs[e] = vv;
    }
    __syncthreads();
    {  // logits: this thread's key column j against RS query rows
      const int j = tid % BK;
      const int i0 = tid / BK;
      constexpr int ISTEP = NT / BK;
      float s[C::RS];
#pragma unroll
      for (int r = 0; r < C::RS; ++r) s[r] = 0.f;
      const T* krow = Ks + j * C::KSTR;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = to_f<T>(krow[d]);
#pragma unroll
        for (int r = 0; r < C::RS; ++r) s[r] += to_f<T>(Qs[(i0 + r * ISTEP) * D + d]) * kd;
      }
      const bool valid = (k0 + j) < Sk;
#pragma unroll
      for (int r = 0; r < C::RS; ++r) Ss[(i0 + r * ISTEP) * BK + j] = valid ? s[r] : kNegBig;
    }
    __syncthreads();
    for (int i = warp; i < BQ; i += NW) {  // online softmax, one warp per row
      float* srow = Ss + i * BK;
      float mx = kNegBig;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, srow[j]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        srow[j] = round_to<T>(p);
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < C::RO; ++r) {  // acc = acc * alpha + P V
      const int e = tid + r * NT;
      const int i = e / D, d = e % D;
      const float* prow = Ss + i * BK;
      float x = acc[r] * a_s[i];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) x += prow[j] * to_f<T>(Vs[j * D + d]);
      acc[r] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < C::RO; ++r) {
    const int e = tid + r * NT;
    const int i = e / D, d = e % D;
    const int row = q0 + i;
    if (row < Sq) op[row * oss + d] = from_f<T>(acc[r] / l_s[i]);
  }
}

template <typename T, int D, int BQ, int BK, int NT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Sq, int Sk, const long long* st, float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, BQ, BK, NT>;
  const size_t smem = FlashCfg<T, D, BQ, BK, NT>::smem_bytes();
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long n_qt = (Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(B) * H, static_cast<unsigned>(n_qt));
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Sq, int Sk, int D, const long long* st, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, 64, 64, 256>(q, k, v, o, B, H, Sq, Sk, st, scale, stream);
    case 512: return launch<T, 512, 16, 32, 256>(q, k, v, o, B, H, Sq, Sk, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mvoc

// strides: 12 values, (batch, head, seq) for q, k, v, o, in elements; the
// head-dim stride must be 1.  Returns a cudaError_t (0 = launched).
extern "C" int mvoc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int B, int H, int Sq, int Sk, int D,
                                    const long long* strides, float scale, void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return dispatch_d<float>(q, k, v, o, B, H, Sq, Sk, D, strides, scale, s);
    case kBF16: return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, D, strides, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
