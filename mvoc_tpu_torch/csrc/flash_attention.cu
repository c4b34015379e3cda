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
// The wgmma kernels compute exp(s - m) as exp2(s * log2(e) - m'),
// log2(e) folded into the fp32 logit multiply (never into q), by the SFU's
// ex2.approx.ftz (p below 2^-126 flushes to 0).  At D = 64
// the scale 1/8 is a power of two, so they apply it to the fp32 logits
// instead of to q: bitwise the same as scaling q.  At D = 512 q is scaled
// and rounded on its way into shared memory.
//
// What bounds it on the H100: at the main path's shapes (S = 4096, 1024 or
// 256 with D = 64; S = 4096 with D = 512) it does 4*Sq*Sk*D operations for
// (2*Sq + 2*Sk)*D elements of I/O, ~1000 operations per byte in bf16:
// bound by the tensor cores' 989 TF/s, not by the 3.35 TB/s of HBM.  So
// both products run on the tensor cores, the logits never leave registers
// (D = 64) or shared memory (D = 512), and K/V tiles stream through a
// 2-stage cp.async ring, the next tile's copy overlapping this tile's math.
//
// Variants, chosen by the wrapper from (dtype, D), the same every time:
//  * wgmma (bf16, D = 64): one block per (batch*head, 128 query rows), two
//    warpgroups of 64 rows, 64-key tiles.  S = Q K^T is wgmma m64n64k16
//    with Q and K K-major in 128-byte-swizzled shared memory (a D = 64 row
//    is exactly 128 bytes); P, the S accumulator rounded to bf16 in
//    registers, is the A operand of O += P V (wgmma m64n64k16), whose B
//    operand is V read MN-major (the transpose bit), so V needs no
//    transpose copy.  Row max and sum reduce across the 4 lanes of a row
//    with shuffles.  O and S take 32 registers a thread each.
//  * wgmma (bf16, D = 512, the VAE's single-head attention): a 64 x 512 fp32
//    O tile is 256 registers a thread, over the limit, so four warpgroups
//    each own a 128-wide slice of D for both products: each computes its
//    partial S over its slice, the partials are summed through shared
//    memory in one fixed order (every warpgroup then holds the same logits
//    and runs the same softmax), and each multiplies P by its V slice.
//    64 query rows and 32-key tiles: Q 64 KB + 2 stages of K/V 128 KB + the
//    partials 32 KB.
//  * SIMT (fp32 at D = 64 and 512): FP32 FMAs from shared memory, so fp32
//    stays exact fp32 (tensor cores would take it to TF32); its bf16
//    instantiation only serves side-by-side timing.  One block per (batch*
//    head, query tile); each thread owns one key column of the logits tile
//    and a fixed set of output accumulators.
// q/k/v are read through their (batch, head, seq) strides: the [B, S, H, D]
// projections need no transpose copy.  The wgmma variant copies rows
// in 16-byte pieces, so the wrapper requires those strides to be multiples
// of 8 elements and the pointers 16-byte aligned.  Ragged tails: K/V rows
// past Sk are zero-filled and their logits masked; Q rows past Sq are
// zero-filled and never stored.

#include "common.cuh"
#include "hopper.cuh"

namespace mvoc {

constexpr float kLog2e = 1.4426950408889634f;

// ===========================================================================
// SIMT kernel: fp32 (and bf16 for timing)
// ===========================================================================

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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B, int H,
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

// ===========================================================================
// Tensor-core kernels: bf16
// ===========================================================================

using bf16 = __nv_bfloat16;

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int H, Sq, Sk;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;  // elements
  float scale;                                                           // 1 / sqrt(D)
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// cp.async rows [r0, r0 + ROWS) of a [*, D] bf16 matrix (row stride ld
// elements) into 128-byte-swizzled shared memory, cut into D / 64 atoms of
// ROWS x 64 (atom a at dst + a * ROWS * 128).  Rows >= R are zero-filled.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src, int64_t ld, int r0,
                                          int R) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CH) % NT == 0, "tile/thread mismatch");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < R;
    cp_async_16(dst + (ch >> 3) * (ROWS * 128) + sw128(r, ch & 7),
                src + static_cast<int64_t>(ok ? r0 + r : 0) * ld + ch * 8, ok ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x by the SFU alone (ex2.approx.ftz): a result below 2^-126 flushes to
// 0, where exp2f would also spend instructions on denormals.  Such a p is
// beyond what l (>= 1) or a bf16 P.V product could show.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of the online softmax for the two rows (g, g + 8) a thread
// holds.  s[NS]: this tile's fp32 logits in the accumulator layout, s[4j +
// e] at column col0 + 8j + (e & 1), row (e >> 1) * 8 + g.  Masks columns
// >= Sk when the tile is ragged, updates the running max m (of s * sl, sl
// the softmax scale times log2(e)) and the sum l, rescales the NO
// accumulators o, and leaves p = exp2(s * sl - m) in s (one fma).
template <int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&o)[NO], float (&m)[2],
                                             float (&l)[2], float sl, int col0, int Sk,
                                             bool ragged) {
  if (ragged) {  // the last key tile only
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (col0 + 8 * (i >> 2) + (i & 1) >= Sk) s[i] = kNegBig;
  }
  float mx[2] = {kNegBig, kNegBig};  // this tile's row max of the unscaled logits
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // sl > 0, so the max commutes with the scaling
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl);
    alpha[r] = exp2_ftz(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float p = exp2_ftz(fmaf(s[i], sl, -m[(i >> 1) & 1]));
    s[i] = p;
    sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // this thread's columns
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// P as the A operand of the P.V product, KS k16 steps: the accumulator
// layout of s is the register A fragment layout, so this is a conversion
// to bf16 in place (the rounding the function asks for), no shuffles.
template <int KS, int NS>
__device__ __forceinline__ void p_fragments(uint32_t (&pa)[KS][4], const float (&s)[NS]) {
  static_assert(NS == KS * 8, "P fragment mismatch");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// out = o / l for the rows (row0, row0 + 8) a thread holds: NO / 4 chunks of
// 8 columns from col0 (its column pair in chunk 0).  l is first summed
// over the 4 lanes of the row.
template <int NO>
__device__ __forceinline__ void store_rows(bf16* op, int64_t oss, int row0, int Sq, int col0,
                                           const float (&o)[NO], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = op + row * oss + col0;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

#define MVOC_FLASH_PROLOGUE                                                       \
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;                          \
  const bf16* qp = a.q + b * a.qsb + h * a.qsh;                                   \
  const bf16* kp = a.k + b * a.ksb + h * a.ksh;                                   \
  const bf16* vp = a.v + b * a.vsb + h * a.vsh;                                   \
  bf16* op = a.o + b * a.osb + h * a.osh;                                         \
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;      \
  const int n_kt = (a.Sk + BK - 1) / BK;

// D = 64, wgmma: 2 warpgroups x 64 query rows, 64-key tiles, 2 stages.
// At ~120 registers and 49 KB of shared memory two blocks share an SM.
struct WgmmaD64 {
  static constexpr int BQ = 128, BK = 64, NT = 256, TILE = BK * 128;
  static constexpr size_t smem = 1024 + BQ * 128 + 2 * 2 * TILE;
};

__global__ void __launch_bounds__(256, 2) flash_wgmma_d64(const FlashArgs a) {
  using C = WgmmaD64;
  constexpr int BK = C::BK, NT = C::NT, TILE = C::TILE;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* Qs = align1024(smem_tc);
  unsigned char* KV = Qs + C::BQ * 128;  // stage s: K at KV + 2 s TILE, V after it
  MVOC_FLASH_PROLOGUE
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int q0 = blockIdx.y * C::BQ;
  const float sl = a.scale * kLog2e;  // 1/8 * log2(e): exact scaling of q, see the header

  load_rows<C::BQ, 64, NT>(Qs, qp, a.qss, q0, a.Sq);
  load_rows<BK, 64, NT>(KV, kp, a.kss, 0, a.Sk);
  load_rows<BK, 64, NT>(KV + TILE, vp, a.vss, 0, a.Sk);
  cp_async_commit();

  float o[32], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint64_t qdesc = wgmma_desc(Qs + wg * 64 * 128, 16, 1024);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();  // this thread's copies of tile kt
    fence_proxy_async();
    __syncthreads();     // everyone's copies landed; tile kt - 1 is consumed
    if (kt + 1 < n_kt) {
      unsigned char* nx = KV + ((kt + 1) & 1) * 2 * TILE;
      load_rows<BK, 64, NT>(nx, kp, a.kss, (kt + 1) * BK, a.Sk);
      load_rows<BK, 64, NT>(nx + TILE, vp, a.vss, (kt + 1) * BK, a.Sk);
      cp_async_commit();
    }
    const unsigned char* Ks = KV + (kt & 1) * 2 * TILE;
    const uint64_t kdesc = wgmma_desc(Ks, 16, 1024);
    const uint64_t vdesc = wgmma_desc(Ks + TILE, 16, 1024);

    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<BK>::ss(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    softmax_tile(s, o, m, l, sl, kt * BK + 2 * t, a.Sk, (kt + 1) * BK > a.Sk);
    uint32_t pa[BK / 16][4];
    p_fragments(pa, s);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Wgmma<64>::rs(o, pa[kk], vdesc + kk * (2048 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  store_rows(op, a.oss, q0 + wg * 64 + warp * 16 + g, a.Sq, 2 * t, o, l);
}

// D = 512, wgmma: 4 warpgroups, each a 128-wide slice of D, 64 query rows,
// 32-key tiles, 2 stages; the partial logits summed through shared memory.
struct WgmmaD512 {
  static constexpr int D = 512, BQ = 64, BK = 32, NT = 512;
  static constexpr int QA = BQ * 128, KA = BK * 128;  // one 64-column atom of a Q / K / V tile
  static constexpr int QT = QA * (D / 64), KT = KA * (D / 64);
  static constexpr size_t smem = 1024 + QT + 2 * 2 * KT + 4 * BQ * BK * sizeof(float);
};

__global__ void __launch_bounds__(512, 1) flash_wgmma_d512(const FlashArgs a) {
  using C = WgmmaD512;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, QA = C::QA, KA = C::KA, KT = C::KT;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* Qs = align1024(smem_tc);
  unsigned char* KV = Qs + C::QT;  // stage s: K at KV + 2 s KT, V after it
  float* Sp = reinterpret_cast<float*>(KV + 4 * KT);  // [4 warpgroups][BQ][BK] partial logits
  MVOC_FLASH_PROLOGUE
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int q0 = blockIdx.y * BQ;

  // q * 1/sqrt(512), rounded to bf16, on its way into shared memory
  for (int c = tid; c < BQ * 64; c += NT) {
    const int r = c >> 6, ch = c & 63;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < a.Sq) raw = *reinterpret_cast<const uint4*>(qp + (q0 + r) * a.qss + ch * 8);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
    }
    *reinterpret_cast<uint4*>(Qs + (ch >> 3) * QA + sw128(r, ch & 7)) = raw;
  }
  load_rows<BK, 512, NT>(KV, kp, a.kss, 0, a.Sk);
  load_rows<BK, 512, NT>(KV + KT, vp, a.vss, 0, a.Sk);
  cp_async_commit();

  float o[64], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const int rA = warp * 16 + g;  // this thread's rows: rA, rA + 8
  const int swz = (rA & 3) << 3;  // column swizzle of the partials (rows rA, rA + 8 alike)

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();  // also publishes the scaled Q (generic stores) to wgmma
    __syncthreads();
    if (kt + 1 < n_kt) {
      unsigned char* nx = KV + ((kt + 1) & 1) * 2 * KT;
      load_rows<BK, 512, NT>(nx, kp, a.kss, (kt + 1) * BK, a.Sk);
      load_rows<BK, 512, NT>(nx + KT, vp, a.vss, (kt + 1) * BK, a.Sk);
      cp_async_commit();
    }
    const unsigned char* Ks = KV + (kt & 1) * 2 * KT;
    const unsigned char* Vs = Ks + KT;

    float s[16];  // this warpgroup's partial logits over its 128 columns of D
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int atom = 2 * wg + (kk >> 2);
      Wgmma<32>::ss(s, wgmma_desc(Qs + atom * QA, 16, 1024) + 2 * (kk & 3),
                    wgmma_desc(Ks + atom * KA, 16, 1024) + 2 * (kk & 3), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float* mine = Sp + wg * BQ * BK;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(mine + (rA + 8 * r) * BK + ((8 * j + 2 * t) ^ swz)) =
            make_float2(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
    __syncthreads();
    // the full logits, summed over the slices in one order in every warpgroup
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (rA + 8 * r) * BK + ((8 * j + 2 * t) ^ swz);
        float2 acc = *reinterpret_cast<const float2*>(Sp + off);
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          const float2 x = *reinterpret_cast<const float2*>(Sp + w * BQ * BK + off);
          acc.x += x.x;
          acc.y += x.y;
        }
        s[4 * j + 2 * r] = acc.x;
        s[4 * j + 2 * r + 1] = acc.y;
      }

    softmax_tile(s, o, m, l, kLog2e, kt * BK + 2 * t, a.Sk, (kt + 1) * BK > a.Sk);
    uint32_t pa[2][4];
    p_fragments(pa, s);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      Wgmma<128>::rs(o, pa[kk], wgmma_desc(Vs + 2 * wg * KA + kk * 2048, KA, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  store_rows(op, a.oss, q0 + rA, a.Sq, wg * 128 + 2 * t, o, l);
}

#undef MVOC_FLASH_PROLOGUE

template <typename Kernel>
cudaError_t launch_tc(Kernel kernel, int BQ, int NT, size_t smem, const FlashArgs& a, int B,
                      cudaStream_t stream) {
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long n_qt = (a.Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(B) * a.H, static_cast<unsigned>(n_qt));
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Sq, int Sk, int D, const long long* st, float scale,
                         cudaStream_t stream) {
  const FlashArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Sq, Sk,
                    st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
                    st[10], st[11], scale};
  if (D == 64) {
    using C = WgmmaD64;
    return launch_tc(flash_wgmma_d64, C::BQ, C::NT, C::smem, a, B, stream);
  }
  if (D == 512) {
    using C = WgmmaD512;
    return launch_tc(flash_wgmma_d512, C::BQ, C::NT, C::smem, a, B, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_simt_d(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Sq, int Sk, int D, const long long* st, float scale,
                          cudaStream_t stream) {
  switch (D) {
    case 64: return launch_simt<T, 64, 64, 64, 256>(q, k, v, o, B, H, Sq, Sk, st, scale, stream);
    case 512: return launch_simt<T, 512, 16, 32, 256>(q, k, v, o, B, H, Sq, Sk, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mvoc

// variant: 0 SIMT (fp32, or bf16 for timing; D 64 or 512), 1 wgmma (bf16;
// D 64 or 512).  strides: 12 values, (batch, head, seq) for q, k, v, o, in
// elements; the head-dim stride must be 1.  The wgmma variant needs every
// stride a multiple of 8 and 16-byte aligned pointers (the wrapper checks).
// Returns a cudaError_t (0 = launched).
extern "C" int mvoc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int variant, int dtype, int B, int H, int Sq, int Sk, int D,
                                    const long long* strides, float scale, void* stream) {
  using namespace mvoc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  if (variant == 0) {
    switch (dtype) {
      case kF32: return launch_simt_d<float>(q, k, v, o, B, H, Sq, Sk, D, strides, scale, s);
      case kBF16:
        return launch_simt_d<__nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, D, strides, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant != 1 || dtype != kBF16) return cudaErrorInvalidValue;
  return launch_wgmma(q, k, v, o, B, H, Sq, Sk, D, strides, scale, s);
}
